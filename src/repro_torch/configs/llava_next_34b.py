"""llava-next-34b [vlm] — hf:llava-hf (unverified); Yi-34B-style backbone,
60L d7168 56H kv8 ff20480 vocab 64000. Vision frontend (anyres tiling) is a
stub: input_specs() provides precomputed patch embeddings prepended to the
text sequence."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128,
    pattern=("dense",),
    frontend="vision", frontend_tokens=1024,
    norm="rmsnorm", act="silu",
    rope_theta=5_000_000.0,
    # §Perf production knobs (EXPERIMENTS.md)
    train_microbatches=8, fsdp=True, attn_bq=2048, attn_bk=2048,
)

"""granite-3-2b [dense] — hf:ibm-granite/granite-3.0-2b-base; GQA kv=8.
40L d2048 32H (head_dim 64) ff8192 vocab 49155 (not 16-divisible; XLA pads)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=49155, head_dim=64,
    pattern=("dense",), norm="rmsnorm", act="silu",
    rope_theta=10_000.0, tie_embeddings=True,
    # §Perf production knobs (EXPERIMENTS.md)
    train_microbatches=8, attn_bq=2048, attn_bk=2048,
)

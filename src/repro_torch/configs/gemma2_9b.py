"""gemma2-9b [dense] — arXiv:2408.00118; local(4096)+global alternating
attention, attn/final logit softcaps, GeGLU. 42L d3584 16H kv8 head256."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    d_ff=14336, vocab=256000, head_dim=256,
    pattern=("local", "global"), window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    norm="rmsnorm", act="gelu",
    rope_theta=10_000.0, tie_embeddings=True,
    # §Perf production knobs (EXPERIMENTS.md)
    train_microbatches=8, attn_bq=2048, attn_bk=2048,
)

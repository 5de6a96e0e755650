"""phi4-mini-3.8b [dense] — arXiv:2412.08905; RoPE SwiGLU GQA kv=8.
32L d3072 24H ff8192 vocab 200064 (large tied embedding)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200064, head_dim=128,
    pattern=("dense",), norm="rmsnorm", act="silu",
    rope_theta=10_000.0, tie_embeddings=True,
    # §Perf production knobs (EXPERIMENTS.md)
    train_microbatches=8, attn_bq=2048, attn_bk=2048,
)

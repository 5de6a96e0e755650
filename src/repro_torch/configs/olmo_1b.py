"""olmo-1b [dense] — arXiv:2402.00838; non-parametric LayerNorm, SwiGLU,
tied embeddings. 16L d2048 16H (kv=16, i.e. MHA) ff8192 vocab 50304."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=50304, head_dim=128,
    pattern=("dense",), norm="layernorm_np", act="silu",
    rope_theta=10_000.0, tie_embeddings=True,
    # §Perf production knobs (EXPERIMENTS.md)
    train_microbatches=8, attn_bq=2048, attn_bk=2048,
)

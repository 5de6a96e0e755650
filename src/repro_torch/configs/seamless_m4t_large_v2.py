"""seamless-m4t-large-v2 [audio] — arXiv:2308.11596; encoder-decoder
backbone, 24 enc + 24 dec layers, d1024 16H (kv=16) ff8192 vocab 256206.
The speech frontend is a stub: input_specs() provides precomputed frame
embeddings (paper assignment note). RoPE replaces sinusoidal positions
(documented adaptation)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, head_dim=64,
    pattern=("dec",), enc_dec=True, n_enc_layers=24,
    frontend="audio", frontend_tokens=1024,
    norm="layernorm", act="gelu",
    rope_theta=10_000.0,
    # §Perf production knobs (EXPERIMENTS.md)
    train_microbatches=32, attn_bq=2048, attn_bk=2048,
)

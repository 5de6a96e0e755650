"""xlstm-350m [ssm] — arXiv:2405.04517 (unverified); alternating
mLSTM/sLSTM blocks, d_ff=0 (blocks carry their own projections).
24L d1024 4H vocab 50304. Sub-quadratic: O(1)-state decode."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, head_dim=256,
    pattern=("mlstm", "slstm"),
    norm="layernorm", act="gelu",
    proj_factor=2.0, tie_embeddings=True,
    sub_quadratic=True,
    # §Perf production knobs (EXPERIMENTS.md)
    train_microbatches=8, attn_bq=2048, attn_bk=2048, mlstm_chunk=256,
)

"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (unverified); Griffin:
RG-LRU recurrent blocks + local attention at 1 attn : 2 recurrent.
38L = (rec,rec,attn) x 12 + (rec,rec) tail. d4096 16H kv=1 (MQA) head256
ff12288 window2048 vocab 256000. Sub-quadratic: bounded window + O(1) state."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    pattern=("rec", "rec", "attn"), tail=("rec", "rec"),
    window=2048, lru_width=4096,
    norm="rmsnorm", act="gelu",
    rope_theta=10_000.0, tie_embeddings=True,
    sub_quadratic=True,
    # §Perf production knobs (EXPERIMENTS.md)
    train_microbatches=8, attn_bq=2048, attn_bk=2048,
)

"""qwen3-moe-30b-a3b [moe] — hf:Qwen/Qwen3-30B-A3B; 128 experts top-8,
expert ff 768, QK-norm, GQA kv=4. 48L d2048 32H vocab 151936."""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab=151936, head_dim=128,
    pattern=("moe",), qk_norm=True,
    moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=768),
    norm="rmsnorm", act="silu",
    rope_theta=1_000_000.0,
    # §Perf production knobs (EXPERIMENTS.md)
    train_microbatches=8, attn_bq=2048, attn_bk=2048, fsdp=True,
)

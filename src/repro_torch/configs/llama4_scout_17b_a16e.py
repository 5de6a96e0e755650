"""llama4-scout-17b-a16e [moe] — hf:meta-llama/Llama-4-Scout-17B-16E
(unverified); MoE 16 experts top-1 + shared expert, GQA kv=8.
48L d5120 40H ff8192 vocab 202048. Early-fusion multimodality is out of
scope for the LM backbone (see DESIGN.md)."""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    pattern=("moe",),
    moe=MoEConfig(num_experts=16, top_k=1, expert_d_ff=8192,
                  shared_d_ff=8192),
    norm="rmsnorm", act="silu",
    rope_theta=500_000.0,
    # §Perf production knobs (EXPERIMENTS.md)
    train_microbatches=16, fsdp=True, attn_bq=2048, attn_bk=2048,
)

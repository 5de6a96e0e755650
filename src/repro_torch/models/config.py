"""Architecture configuration schema (a copy of ``repro.models.config``).

Every assigned architecture is an ``ArchConfig``; the layer sequence is a
repeating ``pattern`` of layer kinds (+ optional ``tail``). The port's
stack runs it as a Python loop over layers. Of the knobs of the
reference's compiled TPU stack the port honours ``remat`` (a checkpoint
per layer), ``attn_bq``/``attn_bk`` (the attention backward's blocks),
``train_microbatches``, ``fsdp`` (the sharding rules) and ``moe_chunk``
(the MoE dispatch's capacity); ``attn_impl`` is kept so that a
configuration reads the same in both packages, and changes nothing.

Layer kinds:
  dense   — GQA attention + (Sw/Ge)GLU MLP
  local   — sliding-window GQA attention + MLP (gemma2 / recurrentgemma)
  global  — full GQA attention + MLP (gemma2 alternation)
  moe     — GQA attention + mixture-of-experts FFN
  rec     — RG-LRU recurrent block + MLP (recurrentgemma)
  mlstm   — xLSTM matrix-memory block
  slstm   — xLSTM scalar-memory block (sequential scan)
  enc     — bidirectional attention + MLP (encoder)
  dec     — causal self-attention + cross-attention + MLP (decoder)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    shared_d_ff: int = 0          # llama4 shared expert
    capacity_factor: float = 1.25
    router_noise: float = 0.0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | audio | ssm | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    pattern: tuple[str, ...] = ("dense",)
    tail: tuple[str, ...] = ()
    # attention details
    rope_theta: float = 10_000.0
    window: int = 4096             # for "local" layers
    attn_softcap: float = 0.0      # gemma2: 50.0
    final_softcap: float = 0.0     # gemma2: 30.0
    qk_norm: bool = False          # qwen3
    attn_scale_override: float = 0.0
    # norms / activations
    norm: str = "rmsnorm"          # rmsnorm | layernorm | layernorm_np (olmo)
    act: str = "silu"              # silu (SwiGLU) | gelu (GeGLU)
    tie_embeddings: bool = False
    # families
    moe: MoEConfig | None = None
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: str | None = None    # "audio" | "vision" -> stub embeddings
    frontend_tokens: int = 0       # tokens contributed by the stub frontend
    # ssm / recurrent
    conv_width: int = 4            # rg-lru temporal conv
    lru_width: int = 0             # 0 -> d_model
    proj_factor: float = 2.0       # xlstm mLSTM up-projection
    # performance knobs (§Perf iterations; "naive" variant = paper-faithful
    # first-cut baseline recorded in artifacts/dryrun)
    remat: str = "layer"           # none | layer  (activation checkpointing)
    attn_impl: str = "chunked"     # naive (materialised probs) | chunked (flash)
    attn_bq: int = 512
    attn_bk: int = 1024
    moe_chunk: int = 0             # tokens per within-row dispatch group (0 = row)
    mlstm_chunk: int = 0           # chunkwise mLSTM block (0 = quadratic parallel form)
    train_microbatches: int = 1    # grad-accumulation inside train_step
    fsdp: bool = False             # shard params over data too (weight gather per use)
    sub_quadratic: bool = False    # eligible for long_500k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        return (self.n_layers - len(self.tail)) // len(self.pattern)

    def check(self) -> None:
        assert self.n_groups * len(self.pattern) + len(self.tail) == self.n_layers, \
            f"{self.name}: layers {self.n_layers} != pattern {self.pattern} x " \
            f"{self.n_groups} + tail {self.tail}"

    def reduced(self, **over) -> "ArchConfig":
        """Smoke-test configuration: same family/pattern, tiny dims."""
        small = dict(
            n_layers=len(self.pattern) * 2 + len(self.tail),
            d_model=64,
            n_heads=max(2, min(4, self.n_heads)),
            n_kv_heads=max(1, min(2, self.n_kv_heads)),
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16,
            window=16,
            frontend_tokens=8 if self.frontend else 0,
            lru_width=0,
            n_enc_layers=2 if self.enc_dec else 0,
        )
        if self.moe is not None:
            small["moe"] = MoEConfig(num_experts=4, top_k=min(2, self.moe.top_k),
                                     expert_d_ff=64,
                                     shared_d_ff=64 if self.moe.shared_d_ff else 0)
        small.update(over)
        cfg = dataclasses.replace(self, name=self.name + "-smoke", **small)
        cfg.check()
        return cfg


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

"""Assigned-architecture registry of the port (a copy of ``repro.configs``):
``get_config("<arch-id>")``; ``--arch <id>`` in the launchers."""
import importlib

from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig  # re-export

ARCHS = {
    "olmo-1b": "olmo_1b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "granite-3-2b": "granite_3_2b",
    "gemma2-9b": "gemma2_9b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "xlstm-350m": "xlstm_350m",
    "llava-next-34b": "llava_next_34b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def get_config(arch: str) -> ArchConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    cfg = mod.CONFIG
    cfg.check()
    return cfg


def list_archs() -> list[str]:
    return sorted(ARCHS)

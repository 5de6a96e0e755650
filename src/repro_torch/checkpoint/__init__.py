"""Checkpoints of the port, in the reference's msgpack layout (the
counterpart of ``repro.checkpoint``)."""
from .checkpoint import cleanup, keystr, latest_step, restore, save

__all__ = ["save", "restore", "latest_step", "cleanup", "keystr"]

"""The port's data pipeline (the counterpart of ``repro.data``)."""
from .pipeline import DataConfig, SyntheticLM, pack_documents

__all__ = ["DataConfig", "SyntheticLM", "pack_documents"]

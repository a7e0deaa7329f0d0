# The synthetic LM data pipeline (a numpy copy of repro.data).
from .pipeline import DataConfig, SyntheticLMDataset

__all__ = ["DataConfig", "SyntheticLMDataset"]

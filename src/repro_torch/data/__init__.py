"""Synthetic data of the port (numpy only)."""
from repro_torch.data.pipeline import SyntheticLM

__all__ = ["SyntheticLM"]

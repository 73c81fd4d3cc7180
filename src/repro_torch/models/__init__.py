"""Model assembly of the port: layers, attention and the decoder LM."""
from repro_torch.models.transformer import LM

__all__ = ["LM"]

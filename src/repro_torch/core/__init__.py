"""Formats (the paper's TCSC baselines among them), quantization and weight
containers of the port."""
from repro_torch.core import formats, quantize, weights
from repro_torch.core.formats import TCSC, BlockedTCSC, InterleavedTCSC
from repro_torch.core.quantize import ternarize, ternarize_target_sparsity
from repro_torch.core.weights import (Base3, Bitplane, Dense2Bit,
                                      TernaryWeight, Tiled, pack,
                                      register_format)

__all__ = ["formats", "quantize", "weights", "TCSC", "BlockedTCSC",
           "InterleavedTCSC", "ternarize", "ternarize_target_sparsity",
           "TernaryWeight", "Dense2Bit",
           "Tiled", "Bitplane", "Base3", "pack", "register_format"]

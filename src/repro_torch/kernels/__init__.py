"""Ternary kernels of the port: hand-written CUDA kernels under ``csrc/``,
their wrappers and plain PyTorch versions, the block-shape tuner and the
public ops."""
from repro_torch.kernels.autotune import (Autotuner, BlockConfig,
                                          FusedBlockConfig, get_tuner)

__all__ = ["Autotuner", "BlockConfig", "FusedBlockConfig", "get_tuner"]

"""The paper's benchmark configuration as a pseudo-architecture: a small
decoder-only LM whose every projection is ternary-quantized (the port's
copy of ``repro.configs.ternary_paper``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="ternary-paper",
    family="dense",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=32768,
    quantization="ternary",
    ternary_min_dim=512,
    fsdp=False,
)

# The paper's microbenchmark parameter grid (Figs 6-11)
PAPER_SPARSITIES = (0.5, 0.25, 0.125, 0.0625)
PAPER_K_RANGE = (1024, 2048, 4096, 8192, 16384)
PAPER_BLOCK_SIZE = 4096

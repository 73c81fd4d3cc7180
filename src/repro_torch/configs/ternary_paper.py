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

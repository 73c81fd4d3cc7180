"""internvl2-76b [VLM] — arXiv:2404.16821 (unverified).

LM backbone (InternLM2-ish per the assignment row): 80L, d_model=8192,
64H (GQA kv=8), d_ff=28672, vocab=128256. The InternViT frontend is a STUB
per the assignment: ``input_specs()`` provides precomputed (B, S_v, d_model)
patch embeddings prepended to the text sequence. Full attention ->
long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    frontend="vision_patches",
    frontend_seq=1024,        # patch positions in the 4k train cell
    rope_theta=1_000_000.0,
    grad_accum=8,
    fsdp=True,
)

"""seamless-m4t-large-v2 [audio, enc-dec] — arXiv:2308.11596 (hf).

24L (24 enc + 24 dec), d_model=1024, 16H (GQA kv=16 = MHA), d_ff=8192,
vocab=256206. Multimodal: the speech frontend is a STUB per the assignment —
``input_specs()`` feeds precomputed (B, S_enc, 1024) frame embeddings into
the text encoder stack. Simplifications vs. the full SeamlessM4T (noted per
DESIGN.md): RoPE replaces the original positional schemes; conformer
convolutions in the speech encoder are not modeled (frontend is a stub).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,          # decoder
    enc_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    use_bias=True,
    norm_type="layernorm",
    frontend="audio_frames",
    frontend_seq=2048,      # enc positions in the 4k train cell (see DESIGN)
    quantization="none",
    grad_accum=4,
    fsdp=False,
)

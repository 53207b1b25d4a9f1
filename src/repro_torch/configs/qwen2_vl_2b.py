"""Qwen2-VL-2B backbone: M-RoPE, vision tower STUBBED (precomputed patch
embeddings via input_specs) [arXiv:2409.12191; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_ff=8960, vocab_size=151_936,
    act="swiglu", qkv_bias=True, rope="mrope",
    source="arXiv:2409.12191; hf",
)
SMOKE = CONFIG.reduced()

"""Qwen1.5-110B: QKV bias [hf:Qwen/Qwen1.5-0.5B scaling; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=49152, vocab_size=152_064,
    act="swiglu", qkv_bias=True, rope="standard",
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
SMOKE = CONFIG.reduced()

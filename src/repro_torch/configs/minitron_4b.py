"""Minitron-4B: pruned Nemotron [arXiv:2407.14679; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=9216, vocab_size=256_000,
    act="relu2", qkv_bias=False, rope="standard",
    source="arXiv:2407.14679; hf",
)
SMOKE = CONFIG.reduced()

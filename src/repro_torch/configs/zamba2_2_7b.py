"""Zamba2-2.7B: Mamba2 backbone + shared attention blocks [arXiv:2411.15242; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab_size=32_000,
    act="swiglu", qkv_bias=False, rope="standard",
    ssm_kind="mamba2", ssm_state=64, ssm_conv=4, ssm_expand=2,
    ssm_headdim=64, hybrid_period=6,
    source="arXiv:2411.15242; hf",
)
SMOKE = CONFIG.reduced()

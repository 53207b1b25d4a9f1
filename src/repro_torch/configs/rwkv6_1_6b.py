"""RWKV-6 (Finch) 1.6B: attention-free, data-dependent decay [arXiv:2404.05892]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=7168, vocab_size=65_536,
    act="rwkv", norm="layernorm", rope="none",
    ssm_kind="rwkv6", ssm_headdim=64,
    source="arXiv:2404.05892; unverified",
)
SMOKE = CONFIG.reduced()

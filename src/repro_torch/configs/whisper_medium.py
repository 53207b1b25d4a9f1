"""Whisper-medium: enc-dec, conv frontend STUBBED (precomputed frame
embeddings via input_specs) [arXiv:2212.04356]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=51_865,
    act="gelu", norm="layernorm", qkv_bias=True, rope="none",
    enc_layers=24, enc_seq=1500,
    source="arXiv:2212.04356; unverified",
)
SMOKE = CONFIG.reduced()

"""The paper's own transformer (IWSLT14 En-De, fairseq transformer-small):
6+6 layer enc-dec in the paper; we expose the decoder-only analogue used for
variance/convergence experiments (Sec. 5.4 proxy)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="statquant-tx", family="dense", n_layers=6, d_model=512,
    n_heads=4, n_kv_heads=4, d_ff=1024, vocab_size=10_000,
    act="gelu", norm="layernorm", qkv_bias=True, rope="standard",
    source="paper Sec. 5.4 (fairseq IWSLT transformer)",
)
SMOKE = CONFIG.reduced()

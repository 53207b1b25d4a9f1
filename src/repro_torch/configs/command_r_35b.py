"""Command-R 35B: GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense", n_layers=40, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22528, vocab_size=256_000,
    act="swiglu", qkv_bias=False, rope="standard",
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)
SMOKE = CONFIG.reduced()

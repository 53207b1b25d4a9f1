"""OLMoE-1B-7B: MoE 64 experts top-8 [arXiv:2409.02060; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab_size=50_304,
    act="swiglu", qkv_bias=False, rope="standard",
    moe_experts=64, moe_topk=8,
    source="arXiv:2409.02060; hf",
)
SMOKE = CONFIG.reduced()

"""Layers of the dense transformer family (forward path)."""

from .attention import (attention, decode_attention, init_attention,
                        init_kv_cache, init_kv_cache_quant)
from .common import dense, init_dense, qkey
from .embeddings import (apply_rope, embed, init_embedding, init_lm_head,
                         lm_head, rope_freqs)
from .mlp import init_mlp, mlp
from .norms import apply_norm, init_norm, layernorm, rmsnorm

__all__ = ["attention", "decode_attention", "init_attention", "init_kv_cache",
           "init_kv_cache_quant", "dense", "init_dense", "qkey", "apply_rope",
           "embed", "init_embedding", "init_lm_head", "lm_head", "rope_freqs",
           "init_mlp", "mlp", "apply_norm", "init_norm", "layernorm",
           "rmsnorm"]

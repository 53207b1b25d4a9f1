"""Layers of the dense, MoE, VLM, Mamba2-hybrid, RWKV6 and audio
(encoder-decoder) families."""

from .attention import (attention, cross_attention_kv, decode_attention,
                        init_attention, init_kv_cache, init_kv_cache_quant,
                        init_paged_kv_pool, paged_decode_attention,
                        paged_write_index)
from .common import dense, init_dense, qkey
from .embeddings import (apply_mrope, apply_rope, embed, init_embedding,
                         init_lm_head, lm_head, rope_freqs,
                         sinusoidal_positions)
from .mamba2 import (init_mamba2_layer, init_mamba2_state, mamba2_decode_step,
                     mamba2_layer)
from .mlp import init_mlp, mlp
from .moe import expert_capacity, init_moe, moe_block
from .norms import apply_norm, init_norm, layernorm, rmsnorm
from .rwkv import (init_rwkv_layer, init_rwkv_state, rwkv_decode_step,
                   rwkv_layer)

__all__ = ["attention", "cross_attention_kv", "decode_attention",
           "init_attention", "init_kv_cache", "init_kv_cache_quant",
           "init_paged_kv_pool",
           "paged_decode_attention", "paged_write_index", "dense",
           "init_dense", "qkey", "apply_rope", "apply_mrope",
           "embed", "init_embedding", "init_lm_head", "lm_head", "rope_freqs",
           "sinusoidal_positions",
           "init_mlp", "mlp", "expert_capacity", "init_moe", "moe_block",
           "apply_norm", "init_norm", "layernorm", "rmsnorm",
           "init_mamba2_layer", "init_mamba2_state", "mamba2_decode_step",
           "mamba2_layer", "init_rwkv_layer", "init_rwkv_state",
           "rwkv_decode_step", "rwkv_layer"]

"""Quantizer core: the forward quantizer, registry, policy, backends and
the FQT matmul (forward only in this slice)."""

from .backend import (affine_factors, apply_epilogue, epilogue_coeffs,
                      fused_fqt_fwd, qt_gemm)
from .fqt import fqt_matmul
from .kv_cache import dequant_kv_rows, kv_fresh_code, quantize_kv_rows
from .policy import QuantPolicy, RoleOverride
from .quantizers import QTensor, num_bins, quantize_ptq_det, tensor_min_max
from .registry import (BACKENDS, ROLES, GemmQuantConfig, Quantizer,
                       QuantizerSpec, available_quantizers, get_quantizer,
                       register_quantizer, resolve_kv_cache_spec)

__all__ = ["affine_factors", "apply_epilogue", "epilogue_coeffs",
           "fused_fqt_fwd", "qt_gemm", "fqt_matmul", "dequant_kv_rows",
           "kv_fresh_code", "quantize_kv_rows", "QuantPolicy", "RoleOverride",
           "QTensor", "num_bins", "quantize_ptq_det", "tensor_min_max",
           "BACKENDS", "ROLES", "GemmQuantConfig", "Quantizer",
           "QuantizerSpec", "available_quantizers", "get_quantizer",
           "register_quantizer", "resolve_kv_cache_spec"]

"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper launches its kernel on a CUDA tensor and counts the launch in
its ``launches`` attribute; on a CPU tensor it runs the plain version.
"""

from .fused_fqt import fused_qlhs_matmul, fused_qlhs_matmul_plain
from .kv_dequant import kv_dequant_rows, kv_dequant_rows_plain

__all__ = ["fused_qlhs_matmul", "fused_qlhs_matmul_plain",
           "kv_dequant_rows", "kv_dequant_rows_plain"]

"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper launches its kernel on a CUDA tensor and counts the launch in
its ``launches`` attribute; on a CPU tensor it runs the plain version.
"""

from .fused_fqt import (fused_qboth_tn_matmul, fused_qboth_tn_matmul_plain,
                        fused_qlhs_matmul, fused_qlhs_matmul_plain)
from .kv_dequant import kv_dequant_rows, kv_dequant_rows_plain
from .q8_matmul import q8_matmul, q8_matmul_plain

__all__ = ["fused_qboth_tn_matmul", "fused_qboth_tn_matmul_plain",
           "fused_qlhs_matmul", "fused_qlhs_matmul_plain",
           "kv_dequant_rows", "kv_dequant_rows_plain",
           "q8_matmul", "q8_matmul_plain"]

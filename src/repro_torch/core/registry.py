"""Role-based quantizer API: quantizers, a registry, role specs.

Port of ``repro.core.registry``.  The paper assigns a distinct quantizer to
each tensor role of the linear-layer training step (Sec. 2, Eq. 3/6):

  ``fwd_act``     Q_f      forward activations   (deterministic)
  ``fwd_weight``  Q_theta  forward weights       (deterministic)
  ``wgrad``       Q_b1     output-grad operand of the dW GEMM (stochastic)
  ``agrad``       Q_b2     output-grad operand of the dX GEMM (stochastic)

plus the serving-time ``kv_cache`` role: the forward quantizer
(``ptq_det``), the stochastic backward quantizers (``ptq``, ``psq``,
``bhq``), the int8 KV codec (``kv_int8``) and the bit-packed forward-weight
quantizers (``int4w``, ``binary``, ``ternary``), which return a
:class:`~repro_torch.kernels.pack.PackedTensor`.  On the ``kernel`` backend
the FQT step fuses PTQ/PSQ into the GEMM kernels; PTQ/PSQ in an unfused
role there run through the ``quantize_sr_*`` kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels.pack import pack_qtensor
from .bhq import quantize_bhq_stoch
from .quantizers import (_EPS, QTensor, quantize_ptq_det, quantize_psq_stoch,
                         quantize_ptq_stoch)

__all__ = [
    "BACKENDS", "ROLES", "KV_CACHE_ROLE", "QuantizerSpec", "GemmQuantConfig",
    "Quantizer", "register_quantizer", "get_quantizer",
    "available_quantizers", "resolve_kv_cache_spec",
]

# ``kernel`` is the JAX package's ``pallas``: the hand-written CUDA kernels
# on the card, their plain PyTorch versions on the CPU.
BACKENDS = ("simulate", "native", "kernel")

ROLES = ("fwd_act", "fwd_weight", "wgrad", "agrad")

KV_CACHE_ROLE = "kv_cache"

EXACT_NAME = "exact"

NATIVE_SLICE = ("a later slice of the port (the 'native' backend; use "
                "'kernel', the hand-written CUDA kernels)")


@dataclasses.dataclass(frozen=True)
class QuantizerSpec:
    """``(name, bits, params)`` reference into the quantizer registry.

    Partial specs express overrides: ``name=""`` inherits the base spec's
    quantizer, ``bits=None`` inherits the base bits (:meth:`merged_over`).
    """

    name: str = ""
    bits: Optional[int] = None
    params: tuple = ()                 # sorted ((key, value), ...)

    @classmethod
    def of(cls, value, **params) -> Optional["QuantizerSpec"]:
        """Coerce a spec-ish value: ``None``, a spec, ``"bhq"``, ``"bhq:4"``,
        ``("bhq", 4)``, or ``{"name": "bhq", "bits": 4, "block_rows": 32}``."""
        if value is None or isinstance(value, QuantizerSpec):
            return value
        if isinstance(value, str):
            name, _, bits = value.partition(":")
            return cls(name, int(bits) if bits else None,
                       tuple(sorted(params.items())))
        if isinstance(value, dict):
            d = dict(value)
            name, bits = d.pop("name", ""), d.pop("bits", None)
            d.update(params)
            return cls(name, bits, tuple(sorted(d.items())))
        if isinstance(value, (tuple, list)):
            name = value[0]
            bits = value[1] if len(value) > 1 else None
            extra = dict(value[2]) if len(value) > 2 else {}
            extra.update(params)
            return cls(name, bits, tuple(sorted(extra.items())))
        raise TypeError(f"cannot interpret {value!r} as a QuantizerSpec")

    def param(self, key: str, default=None):
        return dict(self.params).get(key, default)

    def with_bits(self, bits: int) -> "QuantizerSpec":
        return dataclasses.replace(self, bits=bits)

    def merged_over(self, base: Optional["QuantizerSpec"]) -> "QuantizerSpec":
        """Fill this partial spec from ``base``: empty name and
        ``bits=None`` inherit; params merge over the base params only when
        the quantizer name is unchanged."""
        name = self.name or (base.name if base else EXACT_NAME)
        bits = self.bits if self.bits is not None else \
            (base.bits if base is not None else None)
        if base is not None and base.name == name:
            params = dict(base.params)
            params.update(self.params)
        else:
            params = dict(self.params)
        return QuantizerSpec(name, bits, tuple(sorted(params.items())))

    def describe(self) -> str:
        s = f"{self.name}:{self.bits if self.bits is not None else 8}"
        if self.params:
            s += "(" + ",".join(f"{k}={v}" for k, v in self.params) + ")"
        return s


def _spec_str(spec: Optional[QuantizerSpec]) -> str:
    return "-" if spec is None else spec.describe()


@dataclasses.dataclass(frozen=True)
class GemmQuantConfig:
    """One resolved spec per tensor role plus the execution backend.

    ``None`` for a forward role disables quantization of the whole GEMM
    (both forward roles travel together).  ``fused``: None = auto (on for
    the ``kernel`` backend), True/False force.
    """

    fwd_act: Optional[QuantizerSpec] = None
    fwd_weight: Optional[QuantizerSpec] = None
    wgrad: Optional[QuantizerSpec] = None
    agrad: Optional[QuantizerSpec] = None
    backend: str = "simulate"
    fused: Optional[bool] = None

    @property
    def quantize_fwd(self) -> bool:
        return self.fwd_act is not None and self.fwd_weight is not None

    def validate(self) -> "GemmQuantConfig":
        """Reject configs that cannot execute faithfully: backward roles
        quantized over a (partially) exact forward, one forward role
        without the other, and bit widths outside [2, 8] (1 for the
        forward weight)."""
        if not self.quantize_fwd and (self.wgrad or self.agrad):
            raise ValueError(
                f"invalid role config {self.describe_roles()}: backward "
                f"roles are quantized but the forward is (partially) exact; "
                f"the backward GEMMs need quantized forward operands — pin "
                f"the whole layer 'exact' or set both fwd_act and fwd_weight")
        if (self.fwd_act is None) != (self.fwd_weight is None):
            raise ValueError(
                f"invalid role config {self.describe_roles()}: the forward "
                f"roles travel together — set both fwd_act and fwd_weight, "
                f"or pin the whole layer 'exact'")
        for role in ROLES:
            spec = getattr(self, role)
            if spec is None or spec.bits is None:
                continue
            lo = 1 if role == "fwd_weight" else 2
            if not (isinstance(spec.bits, int) and lo <= spec.bits <= 8):
                raise ValueError(
                    f"{role}={spec.describe()}: bits must be an int in "
                    f"[{lo}, 8] (codes are stored as int8; 1-bit is "
                    f"weight-only)")
        return self

    def describe_roles(self) -> str:
        return " ".join(f"{r}={_spec_str(getattr(self, r))}" for r in ROLES)

    def describe(self) -> str:
        if not self.quantize_fwd:
            return "exact"
        return (f"fwd={_spec_str(self.fwd_act)}/{_spec_str(self.fwd_weight)} "
                f"wgrad={_spec_str(self.wgrad)} agrad={_spec_str(self.agrad)}")


class Quantizer:
    """Base class for pluggable quantizers.  Subclasses implement
    :meth:`quantize`; ``key`` is ``None`` for the deterministic forward
    roles.  ``packed_weights``: the quantizer returns a bit-packed weight,
    which the fused forward takes as it is."""

    name: str = ""
    stochastic: bool = True
    packed_weights: bool = False

    def quantize(self, x2d: torch.Tensor, key, spec: QuantizerSpec, *,
                 backend: str):
        raise NotImplementedError

    def __repr__(self):
        return f"<Quantizer {self.name or type(self).__name__}>"


_REGISTRY: dict = {}


def register_quantizer(name: str, quantizer: Quantizer,
                       overwrite: bool = False) -> Quantizer:
    """Register ``quantizer`` under ``name`` (``QuantizerSpec(name, ...)``)."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"quantizer {name!r} already registered; "
                         "pass overwrite=True to replace it")
    _REGISTRY[name] = quantizer
    return quantizer


def get_quantizer(name: str) -> Quantizer:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown quantizer {name!r}; registered: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def available_quantizers() -> tuple:
    return tuple(sorted(_REGISTRY))


class DeterministicPTQ(Quantizer):
    """Q_f / Q_theta: deterministic per-tensor PTQ (paper Sec. 2.1)."""

    name = "ptq_det"
    stochastic = False

    def quantize(self, x2d, key, spec, *, backend):
        return quantize_ptq_det(x2d, spec.bits or 8)


class StochasticPTQ(Quantizer):
    """Q_b1 / PTQ Q_b2: stochastic per-tensor PTQ (paper Sec. 3.3)."""

    name = "ptq"

    def quantize(self, x2d, key, spec, *, backend):
        bits = spec.bits or 8
        if backend == "kernel":
            from .backend import quantize_sr_tensor_qt
            return quantize_sr_tensor_qt(x2d, key, bits)
        return quantize_ptq_stoch(x2d, key, bits)


class StochasticPSQ(Quantizer):
    """PSQ Q_b2: stochastic per-sample quantizer (paper Sec. 4.1)."""

    name = "psq"

    def quantize(self, x2d, key, spec, *, backend):
        bits = spec.bits or 8
        if backend == "kernel":
            from .backend import quantize_sr_rows_qt
            return quantize_sr_rows_qt(x2d, key, bits)
        return quantize_psq_stoch(x2d, key, bits)


class BlockHouseholder(Quantizer):
    """BHQ Q_b2 (paper Sec. 4.2).  Params: ``block_rows`` (row-block size),
    ``g_search`` ("refined" | "paper").  The grouping and Householder
    transform are plain PyTorch on every backend, as the reference keeps
    them in XLA; the GEMM it feeds, with the ``S^{-1}`` output epilogue,
    runs on the selected backend (core/backend.py ``qt_gemm_nt``)."""

    name = "bhq"

    def quantize(self, x2d, key, spec, *, backend):
        return quantize_bhq_stoch(
            x2d, key, spec.bits or 8,
            block_rows=spec.param("block_rows", 1024),
            g_search=spec.param("g_search", "refined"))


class KVCacheInt8(Quantizer):
    """The ``kv_cache`` role: deterministic per-row affine int8 cache codec
    (core/kv_cache.py), with the ``quantize_rows``/``dequant_rows`` pair
    the decode attention path consumes, and the optional
    ``dequant_rows_kv`` it prefers: a layer's K and V in one call (one
    kernel launch on ``kernel``).  A codec without it is read one side at
    a time."""

    name = "kv_int8"
    stochastic = False

    def quantize(self, x2d, key, spec, *, backend):
        from .kv_cache import quantize_kv_rows
        bits = spec.bits or 8
        codes8, scale, zero = quantize_kv_rows(x2d, bits)
        return QTensor.from_int8(codes8, scale[..., None], zero[..., None],
                                 bits, x2d.shape)

    def quantize_rows(self, x, bits: int = 8):
        from .kv_cache import quantize_kv_rows
        return quantize_kv_rows(x, bits)

    def dequant_rows(self, codes8, scale, zero, bits: int = 8, *,
                     backend: str = "simulate"):
        from .kv_cache import dequant_kv_rows
        return dequant_kv_rows(codes8, scale, zero, bits, backend=backend)

    def dequant_rows_kv(self, k, v, bits: int = 8, *,
                        backend: str = "simulate"):
        from .kv_cache import dequant_kv_rows_kv
        return dequant_kv_rows_kv(k, v, bits, backend=backend)


class PackedPTQWeight(Quantizer):
    """``int4w``: deterministic PTQ forward-weight quantizer with bit-packed
    storage: the ``ptq_det`` code grid at 4 or 2 bits, returned as a
    :class:`~repro_torch.kernels.pack.PackedTensor`.  Weight-role only: the
    packed kernels keep the weight on the RHS of the forward GEMM."""

    name = "int4w"
    stochastic = False
    packed_weights = True
    default_bits = 4

    def quantize(self, x2d, key, spec, *, backend):
        bits = spec.bits if spec.bits is not None else self.default_bits
        if bits not in (2, 4):
            raise ValueError(
                f"int4w packs sub-byte PTQ codes; bits must be 4 or 2, got "
                f"{bits!r} (use 'ptq_det' for 8-bit, 'binary' for 1-bit)")
        return pack_qtensor(quantize_ptq_det(x2d, bits))


class BinaryWeight(Quantizer):
    """``binary``: 1-bit BWN-style weights ``w -> alpha * sign(w)`` with
    ``alpha = mean|w|``.  Codes are the sign plane ``{0, 1}`` packed 8 a
    byte; ``scale = 1/(2 alpha)``, ``zero = -alpha`` put ``dequant`` on
    ``{-alpha, +alpha}``, so the standard epilogue needs no special case."""

    name = "binary"
    stochastic = False
    packed_weights = True
    default_bits = 1

    def quantize(self, x2d, key, spec, *, backend):
        if spec.bits not in (None, 1):
            raise ValueError(
                f"binary is 1-bit by definition, got bits={spec.bits!r}")
        x = x2d.to(torch.float32)
        alpha = torch.mean(torch.abs(x))
        codes = (x > 0).to(torch.uint8)             # sign(0) -> -alpha
        return pack_qtensor(QTensor(
            codes=codes, scale=1.0 / (2.0 * alpha + _EPS), zero=-alpha,
            bits=1, shape=tuple(x2d.shape)))


class TernaryWeight(Quantizer):
    """``ternary``: TWN-style weights ``w -> alpha * {-1, 0, +1}`` with
    threshold ``delta = 0.7 mean|w|`` and ``alpha = mean(|w| : |w| >
    delta)``.  Codes ``{0, 1, 2}`` ride the 2-bit pack; ``scale = 1/alpha``,
    ``zero = -alpha`` put ``dequant`` on ``{-alpha, 0, +alpha}``."""

    name = "ternary"
    stochastic = False
    packed_weights = True
    default_bits = 2

    def quantize(self, x2d, key, spec, *, backend):
        if spec.bits not in (None, 2):
            raise ValueError(
                f"ternary stores {{-1,0,+1}} as 2-bit codes, got "
                f"bits={spec.bits!r}")
        x = x2d.to(torch.float32)
        ax = torch.abs(x)
        delta = 0.7 * torch.mean(ax)
        mask = ax > delta
        alpha = torch.sum(torch.where(mask, ax, 0.0)) / torch.clamp_min(
            torch.sum(mask.to(torch.float32)), 1.0)
        codes = torch.where(mask, torch.where(x > 0, 2, 0), 1).to(torch.uint8)
        return pack_qtensor(QTensor(
            codes=codes, scale=1.0 / (alpha + _EPS), zero=-alpha,
            bits=2, shape=tuple(x2d.shape)))


def resolve_kv_cache_spec(value) -> Optional[QuantizerSpec]:
    """Coerce the serving engine's quantized-KV knob: ``None``/``False`` =>
    full-precision cache; ``True`` => ``kv_int8:8``; otherwise a spec-ish
    value naming a registered cache quantizer."""
    if value is None or value is False:
        return None
    if value is True:
        value = KVCacheInt8.name
    spec = QuantizerSpec.of(value)
    q = get_quantizer(spec.name or KVCacheInt8.name)
    if not hasattr(q, "quantize_rows") or not hasattr(q, "dequant_rows"):
        raise ValueError(
            f"quantizer {spec.name!r} cannot serve the {KV_CACHE_ROLE!r} "
            f"role: it lacks the quantize_rows/dequant_rows cache protocol")
    return spec if spec.name else dataclasses.replace(
        spec, name=KVCacheInt8.name)


register_quantizer("ptq_det", DeterministicPTQ())
register_quantizer("ptq", StochasticPTQ())
register_quantizer("psq", StochasticPSQ())
register_quantizer("bhq", BlockHouseholder())
register_quantizer("kv_int8", KVCacheInt8())
register_quantizer("int4w", PackedPTQWeight())
register_quantizer("binary", BinaryWeight())
register_quantizer("ternary", TernaryWeight())

"""Quantization policy — global defaults + per-layer overrides.

Port of ``repro.core.policy``.  Three canonical modes (paper App. E):

  ``exact()``  full precision                 (paper's "Exact" rows)
  ``qat()``    quantized forward, FP backward (paper's "QAT" rows)
  ``fqt(...)`` fully quantized training       (paper's "b-bit FQT" rows)

:meth:`QuantPolicy.resolve` turns the global fields plus the path-regex
``overrides`` into one :class:`~repro_torch.core.registry.GemmQuantConfig`
per GEMM.  ``backend`` picks how every quantized GEMM executes:

  ``simulate``  fp32 quantize-dequantize matmul (the paper's GPU simulation)
  ``native``    ``torch._int_mm`` on the int8 codes + the affine epilogue
                (the reference's XLA int8 ``dot_general``)
  ``kernel``    the hand-written CUDA kernels (their plain versions on CPU)

The factory methods also accept the legacy ``mode=`` spelling and
``policy.mode`` reads as an alias of ``backend``.
:func:`overrides_to_json` / :func:`overrides_from_json` are the precision
planner's interchange format, byte for byte the reference's, so a plan
either package writes is read by the other (``launch/train.py
--override-file``).
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Optional

from .registry import (BACKENDS, EXACT_NAME, ROLES, GemmQuantConfig,
                       QuantizerSpec, get_quantizer)

__all__ = ["QuantPolicy", "RoleOverride", "BACKENDS", "EXACT", "QAT",
           "FQT8_BHQ", "overrides_to_json", "overrides_from_json"]

_BIT_FIELDS = ("act_bits", "weight_bits", "wgrad_bits", "grad_bits",
               "dp_grad_bits")


@dataclasses.dataclass(frozen=True)
class RoleOverride:
    """Partial per-role settings merged over the policy defaults.

    ``exact=True`` pins the layer to full precision; ``bits`` rewrites the
    bitwidth of every role that stays quantized; the four role fields carry
    partial :class:`QuantizerSpec` values (``None`` = leave the role alone,
    spec name ``"exact"`` = pin just that role to full precision).
    """

    exact: bool = False
    bits: Optional[int] = None
    fwd_act: Optional[QuantizerSpec] = None
    fwd_weight: Optional[QuantizerSpec] = None
    wgrad: Optional[QuantizerSpec] = None
    agrad: Optional[QuantizerSpec] = None

    @classmethod
    def of(cls, value) -> "RoleOverride":
        """Coerce an override-ish value: ``"exact"``, an int (bits for all
        roles), a RoleOverride, or a dict of role -> spec-ish (plus the
        shorthand key ``"fwd"`` and the scalar keys ``"exact"``/``"bits"``)."""
        if isinstance(value, RoleOverride):
            return value
        if value == EXACT_NAME:
            return cls(exact=True)
        if isinstance(value, int) and not isinstance(value, bool):
            return cls(bits=value)
        if isinstance(value, dict):
            d = dict(value)
            kw = {"exact": bool(d.pop("exact", False)),
                  "bits": d.pop("bits", None)}
            fwd = d.pop("fwd", None)
            if fwd is not None:
                d.setdefault("fwd_act", fwd)
                d.setdefault("fwd_weight", fwd)
            for role in ROLES:
                if role in d:
                    kw[role] = QuantizerSpec.of(d.pop(role))
            if d:
                raise ValueError(
                    f"unknown override keys {sorted(d)}; expected "
                    f"{('exact', 'bits', 'fwd') + ROLES}")
            return cls(**kw)
        raise TypeError(f"cannot interpret {value!r} as a RoleOverride")

    def apply(self, cfg: GemmQuantConfig) -> GemmQuantConfig:
        if self.exact:
            cfg = dataclasses.replace(cfg, fwd_act=None, fwd_weight=None,
                                      wgrad=None, agrad=None)
        # blanket `bits` first, so an explicit per-role spec in the SAME
        # override entry (more specific) wins over it
        if self.bits is not None:
            cfg = dataclasses.replace(cfg, **{
                role: getattr(cfg, role).with_bits(self.bits)
                for role in ROLES if getattr(cfg, role) is not None})
        for role in ROLES:
            part = getattr(self, role)
            if part is None:
                continue
            base = getattr(cfg, role)
            if not part.name and base is None:
                raise ValueError(
                    f"override for role {role!r} gives no quantizer name "
                    f"but the role has no quantizer to inherit (it is "
                    f"full-precision at this point); name one explicitly, "
                    f"e.g. {role}='psq:{part.bits or 8}'")
            spec = part.merged_over(base)
            cfg = dataclasses.replace(
                cfg, **{role: None if spec.name == EXACT_NAME else spec})
        return cfg


def _normalize_overrides(overrides) -> tuple:
    """dict / iterable-of-pairs -> hashable ((pattern, RoleOverride), ...)."""
    if not overrides:
        return ()
    items = overrides.items() if isinstance(overrides, dict) else overrides
    out = []
    for pattern, value in items:
        try:
            re.compile(pattern)
        except re.error as e:
            raise ValueError(
                f"invalid override pattern {pattern!r}: {e}") from None
        out.append((pattern, RoleOverride.of(value)))
    return tuple(out)


@functools.lru_cache(maxsize=4096)
def _resolve(policy: "QuantPolicy", path: str) -> GemmQuantConfig:
    cfg = policy._default_gemm_config()
    for pattern, override in policy.overrides:
        if re.search(pattern, path):
            cfg = override.apply(cfg)
    return cfg.validate()


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    enabled: bool = True           # False => full-precision ("exact")
    act_bits: int = 8              # Q_f bits
    weight_bits: int = 8           # Q_theta bits
    quantize_bwd: bool = True      # False => QAT (backward in full precision)
    wgrad_bits: int = 8            # Q_b1 bits (stochastic per-tensor)
    grad_bits: int = 8             # Q_b2 bits
    grad_quantizer: str = "bhq"    # Q_b2 type: any registered quantizer name
    bhq_block: int = 1024          # BHQ row-block size
    overrides: tuple = ()          # ((path_regex, RoleOverride), ...) in order
    backend: str = "simulate"      # "simulate" | "native" | "kernel"
    fused: Optional[bool] = None   # fused kernels: None => auto (kernel on)
    # beyond-paper: the bits of the int8 compressed data-parallel gradient
    # exchange (core/compression.py; the step's compress_axis turns it on)
    dp_grad_bits: int = 8

    def __post_init__(self):
        get_quantizer(self.grad_quantizer)   # ValueError if unregistered
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {BACKENDS}")
        for field in _BIT_FIELDS:
            bits = getattr(self, field)
            if not (isinstance(bits, int) and 2 <= bits <= 8):
                raise ValueError(f"{field}={bits!r} out of range: "
                                 "bitwidths must be ints in [2, 8]")
        if not (isinstance(self.bhq_block, int) and self.bhq_block > 0):
            raise ValueError(f"bhq_block={self.bhq_block!r} must be a "
                             "positive int")
        object.__setattr__(self, "overrides",
                           _normalize_overrides(self.overrides))

    def _default_gemm_config(self) -> GemmQuantConfig:
        """The global-field defaults as one GemmQuantConfig."""
        if not self.enabled:
            return GemmQuantConfig(backend=self.backend, fused=self.fused)
        wgrad = agrad = None
        if self.quantize_bwd:
            wgrad = QuantizerSpec("ptq", self.wgrad_bits)
            params = ()
            if self.grad_quantizer == "bhq":
                params = (("block_rows", self.bhq_block),)
            agrad = QuantizerSpec(self.grad_quantizer, self.grad_bits, params)
        return GemmQuantConfig(
            fwd_act=QuantizerSpec("ptq_det", self.act_bits),
            fwd_weight=QuantizerSpec("ptq_det", self.weight_bits),
            wgrad=wgrad, agrad=agrad, backend=self.backend, fused=self.fused)

    def resolve(self, path: str = "") -> GemmQuantConfig:
        """Per-layer role specs for the GEMM at ``path``: the global
        defaults with every ``overrides`` entry whose regex
        ``re.search``-matches ``path`` applied in order (memoized)."""
        return _resolve(self, path or "")

    def spec_table(self, paths) -> tuple:
        """((path, resolved-spec-description), ...) for a path list: the
        per-layer precision table of a config."""
        return tuple((p, self.resolve(p).describe()) for p in paths)

    @property
    def mode(self) -> str:
        """Legacy alias of ``backend`` (read-only; set via the factories)."""
        return self.backend

    @staticmethod
    def _resolve_backend(backend: str, mode: str) -> str:
        # `mode` is the legacy spelling; an explicit `backend` wins.
        chosen = backend or mode or "simulate"
        if chosen not in BACKENDS:
            which = "backend" if backend else "mode"
            raise ValueError(f"invalid {which}={chosen!r}; "
                             f"expected one of {BACKENDS}")
        return chosen

    @staticmethod
    def exact() -> "QuantPolicy":
        return QuantPolicy(enabled=False)

    @staticmethod
    def qat(act_bits: int = 8, weight_bits: int = 8, mode: str = "",
            backend: str = "", **kw) -> "QuantPolicy":
        return QuantPolicy(enabled=True, quantize_bwd=False,
                           act_bits=act_bits, weight_bits=weight_bits,
                           backend=QuantPolicy._resolve_backend(backend, mode),
                           **kw)

    @staticmethod
    def fqt(grad_quantizer: str = "bhq", grad_bits: int = 8,
            act_bits: int = 8, weight_bits: int = 8, mode: str = "",
            backend: str = "", **kw) -> "QuantPolicy":
        return QuantPolicy(enabled=True, quantize_bwd=True,
                           grad_quantizer=grad_quantizer, grad_bits=grad_bits,
                           act_bits=act_bits, weight_bits=weight_bits,
                           backend=QuantPolicy._resolve_backend(backend, mode),
                           **kw)


EXACT = QuantPolicy.exact()
QAT = QuantPolicy.qat()
FQT8_BHQ = QuantPolicy.fqt("bhq", 8)


def _spec_to_json(spec: Optional[QuantizerSpec]):
    if spec is None:
        return None
    d = {"name": spec.name, "bits": spec.bits}
    d.update(dict(spec.params))
    return d


def overrides_to_json(overrides) -> list:
    """Overrides (any form ``QuantPolicy(overrides=...)`` accepts) -> a
    JSON-serializable ``[[pattern, {role: spec-dict, ...}], ...]`` list,
    the inverse of :func:`overrides_from_json`."""
    out = []
    for pattern, ov in _normalize_overrides(overrides):
        d: dict = {}
        if ov.exact:
            d["exact"] = True
        if ov.bits is not None:
            d["bits"] = ov.bits
        for role in ROLES:
            spec = getattr(ov, role)
            if spec is not None:
                d[role] = _spec_to_json(spec)
        out.append([pattern, d])
    return out


def overrides_from_json(data) -> tuple:
    """JSON overrides -> the normalized tuple ``QuantPolicy(overrides=...)``
    consumes.  Accepts the list-of-pairs form :func:`overrides_to_json`
    emits, a ``{pattern: override}`` dict, or a whole planner document
    (its ``"overrides"`` key)."""
    if isinstance(data, dict) and "overrides" in data:
        data = data["overrides"]
    if isinstance(data, dict):
        pairs = list(data.items())
    else:
        pairs = [(p, v) for p, v in data]
    return _normalize_overrides(pairs)

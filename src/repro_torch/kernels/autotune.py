"""Tile and split-K autotuner with a persisted per-(kernel, shape) cache.

Port of ``repro.kernels.autotune``.  The reference tunes each Pallas
kernel's (bm, bn, bk) under the TPU's VMEM budget.  On the card a tile is
compiled into its library (``csrc/``), so what is tuned is the choice
among the tiles a kernel was built with and the split of K
(``kernels/splitk.py``); for the two KV row kernels, the body their C
entry runs (``body``: 0 the entry's own choice, 1 bulk, 2 element).  This
module owns:

  * the **shared-memory accounting** (:func:`tile_smem_bytes`): the
    dynamic shared memory a block of each tile takes, as its library's
    ``<lib>_tile`` entry reports it, against the H100's 232,448 bytes
    (227 KB) a block (:data:`SMEM_BUDGET_BYTES`);
  * the **candidates** (:func:`tile_candidates`): a GEMM kernel's tiles
    (decode and wide where it has both, the SR variant as the rounding
    requires) crossed with every split of 1 to 8 that leaves no slice
    empty; :func:`autotune` times them through an injectable timer and
    records the winner;
  * the **persisted cache**: a JSON file keyed
    ``<kernel>/<MxKxN>/<dtype>/<platform>`` (``sm_90`` on the H100, ``any``
    for every platform) at ``~/.cache/repro_torch/tuning.json``
    (``$REPRO_TORCH_TUNING_CACHE`` overrides; the JAX package's file,
    whose entries differ, is never read).  An entry is ``{"tile":
    <Tile.name>, "splits": s}`` for a GEMM, ``{"body": b}`` for a row
    kernel.

GEMM keys are GEMM-logical (M, K, N), K the contraction: the forward
looks up (m, k, n), dX (m, n, k) and dW (k, m, n) for a model GEMM (m, k,
n), as the reference documents.  The dtype segment is ``int8``, or the
packed weights' width (``int4``, ``int2``, ``int1``).

:func:`lookup_tiles` resolves a call: the persisted cache (the platform's
entry, then ``any``), then :data:`SHIPPED_DEFAULTS`, then the split model
of ``kernels/splitk.py``.  The result is memoized per (kernel, shape,
dtype, rounding), so a wrapper call reads no file and builds no key
string; :func:`record_tiles` and :func:`reset_cache` drop the memo.  A
corrupt file warns and reads as empty; an illegal entry is dropped with a
warning; an entry that names a tile or body the kernel lacks raises where
it is resolved.  Tune on the card with

    python -m repro_torch.kernels.autotune [--case q8_matmul:512x10240x512]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import sys
import tempfile
import warnings
from typing import Callable, Dict, Iterable, Optional, Tuple

from . import splitk
from .splitk import SMEM_VARIANTS, Tile

__all__ = [
    "SMEM_BUDGET_BYTES", "KERNEL_SPECS", "SHIPPED_DEFAULTS", "ENV_CACHE",
    "kernel_tiles", "tile_smem_bytes", "validate_entry", "tile_candidates",
    "shape_key", "cache_key", "cache_path", "current_platform",
    "TuningCache", "get_cache", "reset_cache", "lookup_tiles",
    "model_entry", "record_tiles", "autotune", "forced", "WIDTH_DTYPES",
    "LEGAL_DTYPES", "parse_key", "check_keyed_entry", "resolve",
    "entry_of", "SWEEP_CASES", "case_call", "tune_case"]

# the H100's dynamic shared memory a block (cudaFuncSetAttribute's
# MaxDynamicSharedMemorySize: 227 KB)
SMEM_BUDGET_BYTES = 232448

ENV_CACHE = "REPRO_TORCH_TUNING_CACHE"
_DEFAULT_CACHE_PATH = os.path.join("~", ".cache", "repro_torch",
                                   "tuning.json")

# The reference's eight kernel keys and what each is on the card: a GEMM
# library and its tiles, a packed GEMM library (its tiles at the key's
# width), or a row kernel and its bodies.
KERNEL_SPECS: Dict[str, Dict[str, object]] = {
    "q8_matmul": {"kind": "gemm", "lib": "q8_matmul",
                  "tiles": (splitk.Q8_TILE,)},
    "fused_fwd": {"kind": "gemm", "lib": "fused_qlhs_fwd",
                  "tiles": (splitk.FWD_DECODE_TILE, splitk.FWD_DECODE_SR_TILE,
                            splitk.FWD_WIDE_TILE, splitk.FWD_WIDE_SR_TILE)},
    "fused_dx": {"kind": "gemm", "lib": "fused_qlhs_dx",
                 "tiles": (splitk.DX_TILE,)},
    "fused_dw": {"kind": "gemm", "lib": "fused_qboth_tn",
                 "tiles": (splitk.DW_TILE,)},
    "kv_dequant": {"kind": "rows", "lib": "kv_dequant", "bodies": (0, 1, 2)},
    "kv_gather": {"kind": "rows", "lib": "kv_gather", "bodies": (0, 1, 2)},
    "q4_matmul": {"kind": "packed", "lib": "packed_matmul"},
    "fused_packed": {"kind": "packed", "lib": "fused_qlhs_packed"},
}

_WIDTHS = {"int8": 8, "int4": 4, "int2": 2, "int1": 1}
# a packed GEMM's dtype segment by width, for the wrappers' lookups
WIDTH_DTYPES = {w: d for d, w in _WIDTHS.items()}
# the int8 forward's rounding variants: (deterministic, SR) of each tile
_FWD_TWINS = {splitk.FWD_DECODE_TILE.name: (splitk.FWD_DECODE_TILE,
                                            splitk.FWD_DECODE_SR_TILE),
              splitk.FWD_WIDE_TILE.name: (splitk.FWD_WIDE_TILE,
                                          splitk.FWD_WIDE_SR_TILE)}
_FWD_TWINS.update({v[1].name: v for v in list(_FWD_TWINS.values())})


def kernel_tiles(kernel: str, dtype: str = "int8") -> Tuple[Tile, ...]:
    """The tiles ``kernel`` was built with (a packed kernel's at the width
    ``dtype`` names); () for a row kernel."""
    spec = KERNEL_SPECS[kernel]
    if spec["kind"] == "packed":
        w = _WIDTHS.get(dtype)
        if w is None:
            return ()
        return tuple(splitk.PACKED_TILES[spec["lib"], t, w] for t in (0, 1))
    return tuple(spec.get("tiles", ()))


# ---------------------------------------------------------------------------
# Shared-memory accounting (the libraries' <lib>_tile figures)
# ---------------------------------------------------------------------------

def _qlhs_smem(t: Tile, kmajor: bool, ppb: int, sr: bool) -> int:
    """csrc/fused_qlhs_gemm.cuh ``Tile::smem_bytes``: the ring of f32 LHS,
    SR bits (int64) and B stages (the accumulator tile reuses it), the
    LHS code tile and, unless B is K-major, the K-major B tile."""
    stage = t.bm * t.bk * 4 + (t.bm * t.bk * 8 if sr else 0) \
        + t.bn * t.bk // ppb
    ring = max(t.stages * stage, t.bm * (t.bn + 8) * 4)
    return ring + t.bm * t.bk + (0 if kmajor else t.bn * t.bk)


def tile_smem_bytes(tile: Tile, variant: int = 0) -> int:
    """Dynamic shared memory a block of ``tile`` takes, in bytes, as its
    library's ``<lib>_tile`` entry reports it: ``variant`` 0 or 1 is the
    library's first or second figure (``splitk.SMEM_VARIANTS``: B K-major
    or N-major for ``q8_matmul``, with SR bits in the ring or without for
    the libraries of ``csrc/fused_qlhs_gemm.cuh``)."""
    t, lib = tile, tile.lib
    if lib == "q8_matmul":
        b = t.bn * t.bk
        return t.stages * (t.bm * t.bk + b) + (b if variant else 0)
    if lib == "fused_qlhs_dx":
        return _qlhs_smem(t, True, 1, variant == 0)
    if lib == "fused_qlhs_fwd":
        return _qlhs_smem(t, False, 1, variant == 0)
    if lib == "fused_qlhs_packed":
        return _qlhs_smem(t, False, 8 // _tile_wbits(t), variant == 0)
    if lib == "packed_matmul":
        stage = t.bm * t.bk + t.bn * t.bk // (8 // _tile_wbits(t))
        ring = max(t.stages * stage, t.bm * (t.bn + 8) * 4)
        return ring + t.bn * t.bk
    if lib == "fused_qboth_tn":
        # raw f32 X and dY rows, their int64 SR bits; the two code tiles
        stage = t.bk * t.bm * 4 + t.bk * t.bn * 4 + t.bk * t.bn * 8
        ring = max(t.stages * stage, t.bm * (t.bn + 8) * 4)
        return ring + t.bm * t.bk + t.bn * t.bk
    raise ValueError(f"no shared-memory accounting for library {lib!r}; "
                     f"expected one of {sorted(SMEM_VARIANTS)}")


def _tile_wbits(tile: Tile) -> int:
    return (1, 2, 4, 8)[tile.mode % 4]


# ---------------------------------------------------------------------------
# Entries: validation, candidates, resolution
# ---------------------------------------------------------------------------

def _geometry_tile(kernel: str, geom, dtype: str) -> Tile:
    """A tile of ``kernel``'s library from an entry's ``{"bm", "bn", "bk",
    "stages"}`` (what a foreign or hand-edited cache may hold): priced by
    :func:`tile_smem_bytes`, never built."""
    base = kernel_tiles(kernel, dtype)[0]
    return dataclasses.replace(
        base, name="<geometry>", bm=int(geom["bm"]), bn=int(geom["bn"]),
        bk=int(geom["bk"]), stages=int(geom.get("stages", base.stages)))


def validate_entry(kernel: str, entry, shape=None, dtype: str = "int8",
                   budget: int = SMEM_BUDGET_BYTES):
    """Statically validate one cache entry of ``kernel`` at ``shape`` (the
    key's (M, K, N); None skips the split's shape checks).

    Returns a list of problem strings (empty = legal), or ``None`` when
    the kernel is not in :data:`KERNEL_SPECS` (nothing to validate
    against; callers keep such entries and may flag them)."""
    spec = KERNEL_SPECS.get(kernel)
    if spec is None:
        return None
    if not isinstance(entry, dict):
        want = "{body}" if spec["kind"] == "rows" else "{tile, splits}"
        return [f"entry {entry!r} is not a {want} dict"]
    if spec["kind"] == "rows":
        body = entry.get("body")
        if not isinstance(body, int) or isinstance(body, bool) \
                or body not in spec["bodies"]:
            return [f"body {body!r} is not one of {spec['lib']}'s bodies "
                    f"{spec['bodies']}"]
        return []
    tiles = {t.name: t for t in kernel_tiles(kernel, dtype)}
    if not tiles:
        return [f"dtype {dtype!r} names no width of {spec['lib']}'s tiles"]
    problems = []
    name, splits = entry.get("tile"), entry.get("splits")
    if isinstance(name, dict):
        try:
            tile = _geometry_tile(kernel, name, dtype)
        except (KeyError, TypeError, ValueError):
            return [f"tile {name!r} is neither a tile name nor a "
                    f"{{bm, bn, bk, stages}} geometry"]
        problems.append(f"tile {tile.bm}x{tile.bn}x{tile.bk} ({tile.stages} "
                        f"stages) is not one {spec['lib']} was built with "
                        f"({', '.join(sorted(tiles))})")
    elif name in tiles:
        tile = tiles[name]
    else:
        return [f"tile {name!r} is not one {spec['lib']} was built with "
                f"({', '.join(sorted(tiles))})"]
    if not isinstance(splits, int) or isinstance(splits, bool) \
            or not 1 <= splits <= 8:
        problems.append(f"splits={splits!r} is not a cluster of 1 to 8")
    elif shape is not None:
        K = int(shape[1])
        span = splitk.split_ok(tile, K, splits) if tile.bk > 0 else None
        if span is None:
            problems.append(f"{splits} slices of K={K} leave a slice empty "
                            f"(K steps of {tile.bk})")
        elif span % 8:
            problems.append(f"k_span {span} is not a multiple of 8 (a "
                            f"packed byte would straddle two slices)")
    smem = max(tile_smem_bytes(tile, 0), tile_smem_bytes(tile, 1))
    if smem > budget:
        problems.append(f"tile {tile.bm}x{tile.bn}x{tile.bk} needs {smem} B "
                        f"of shared memory a block > the budget {budget} B")
    return problems


def tile_candidates(kernel: str, shape, dtype: str = "int8",
                    sr: bool = False) -> Tuple[dict, ...]:
    """The autotuner's sweep at ``shape`` (M, K, N): every tile ``kernel``
    was built with (the SR variant of the int8 forward's when ``sr``)
    crossed with every split of 1 to 8 that leaves no slice empty; a row
    kernel's bodies."""
    spec = KERNEL_SPECS[kernel]
    if spec["kind"] == "rows":
        return tuple({"body": b} for b in spec["bodies"])
    K = int(shape[1])
    tiles = kernel_tiles(kernel, dtype)
    if kernel == "fused_fwd":
        tiles = tuple(t for t in tiles if _FWD_TWINS[t.name][int(sr)] is t)
    return tuple({"tile": t.name, "splits": s} for t in tiles
                 for s in range(1, 9)
                 if (span := splitk.split_ok(t, K, s)) is not None
                 and span % 8 == 0)


def resolve(kernel: str, shape, entry, dtype: str = "int8", sr: bool = False):
    """An entry as the wrappers use it: a ``SplitPlan`` (GEMM) or a body
    (row kernel).  Raises ValueError for a tile or body the kernel lacks;
    the rounding picks the int8 forward's variant."""
    spec = KERNEL_SPECS[kernel]
    if spec["kind"] == "rows":
        body = entry.get("body") if isinstance(entry, dict) else None
        if body not in spec["bodies"]:
            raise ValueError(f"{kernel}: body {body!r} is not one of "
                             f"{spec['lib']}'s bodies {spec['bodies']}")
        return body
    tiles = {t.name: t for t in kernel_tiles(kernel, dtype)}
    name = entry.get("tile") if isinstance(entry, dict) else None
    if name not in tiles:
        raise ValueError(f"{kernel}: tile {name!r} is not one {spec['lib']} "
                         f"was built with ({', '.join(sorted(tiles))})")
    tile = tiles[name]
    if kernel == "fused_fwd":
        tile = _FWD_TWINS[name][int(sr)]
    M, K, N = (int(d) for d in shape)
    return splitk.plan_split(tile, M, N, K, int(entry["splits"]))


def model_entry(kernel: str, shape, dtype: str = "int8", sr: bool = False,
                card: Optional[bool] = None) -> dict:
    """The split model's pick (``kernels/splitk.py``) as a cache entry:
    the tile the wrapper takes by M and rounding, the split ``plan``
    prices best; on the card with the capacity the library reports
    (``card`` None: when the platform is a card)."""
    spec = KERNEL_SPECS[kernel]
    if spec["kind"] == "rows":
        return {"body": 0}
    M, K, N = (int(d) for d in shape)
    if kernel == "fused_fwd":
        tile = splitk.fwd_tile(M, sr)
    elif spec["kind"] == "packed":
        tile = splitk.packed_tile(spec["lib"], M, _WIDTHS[dtype])
    else:
        tile = spec["tiles"][0]
    if card is None:
        card = current_platform().startswith("sm_")
    p = splitk.plan(splitk.on_card(tile) if card else tile, M, N, K)
    return {"tile": tile.name, "splits": p.splits}


# ---------------------------------------------------------------------------
# The persisted cache
# ---------------------------------------------------------------------------

def shape_key(*dims) -> str:
    return "x".join(d if isinstance(d, str) else str(int(d)) for d in dims)


@functools.lru_cache(maxsize=None)
def current_platform() -> str:
    """``sm_<major><minor>`` of the current card (``sm_90`` on the H100),
    or ``cpu`` without one; asked once per process."""
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    major, minor = torch.cuda.get_device_capability()
    return f"sm_{major}{minor}"


def cache_key(kernel: str, shape, dtype: str = "int8",
              platform: Optional[str] = None) -> str:
    return (f"{kernel}/{shape_key(*shape)}/{dtype}/"
            f"{platform or current_platform()}")


def cache_path() -> str:
    return os.path.expanduser(os.environ.get(ENV_CACHE)
                              or _DEFAULT_CACHE_PATH)


# dtype segments a key may carry: int4/int2/int1 tag the *packed weight*
# keys (q4_matmul and fused_packed keep their tiles per sub-byte width)
LEGAL_DTYPES = ("int8", "uint8", "int4", "int2", "int1", "float32",
                "bfloat16", "float16")


def parse_key(key: str, platform: bool = True):
    """``(kernel, dims, dtype)`` of a cache key ``<kernel>/<shape>/<dtype>``
    (``/<platform>`` after it when ``platform``; a shipped default's key
    has none); a dim is an int or a name.  ValueError names what is
    malformed."""
    parts = str(key).split("/")
    want = 4 if platform else 3
    if len(parts) != want:
        raise ValueError(
            f"key does not parse as <kernel>/<shape>/<dtype>"
            f"{'/<platform>' if platform else ''} ({len(parts)} segment(s))")
    kernel, shape, dtype = parts[:3]
    dims = shape.split("x")
    if not all(d.isdigit() or d.isidentifier() for d in dims):
        raise ValueError(f"shape segment {shape!r} has a non-numeric, "
                         f"non-name dim")
    if dtype not in LEGAL_DTYPES:
        raise ValueError(f"dtype {dtype!r} not in {LEGAL_DTYPES}")
    return kernel, tuple(int(d) if d.isdigit() else d for d in dims), dtype


def check_keyed_entry(key: str, entry, platform: bool = True):
    """validate_entry for the entry of cache key ``key``, at its shape and
    dtype (a GEMM key's shape must be MxKxN); None for an unknown kernel.
    ValueError for a malformed key."""
    kernel, dims, dtype = parse_key(key, platform)
    spec = KERNEL_SPECS.get(kernel)
    if spec is None or spec["kind"] == "rows":
        return validate_entry(kernel, entry, None, dtype)
    if len(dims) != 3 or not all(isinstance(d, int) for d in dims):
        return [f"a GEMM key's shape is MxKxN, got {dims}"]
    return validate_entry(kernel, entry, dims, dtype)


class TuningCache:
    """Lazy-loaded JSON cache; a corrupt or unreadable file degrades to an
    empty cache with a warning (never an exception).

    Each entry is validated on load (:func:`validate_entry` at its key's
    shape and dtype): an illegal one is DROPPED with a warning, so a stale
    or hand-edited cache never feeds a tile the library lacks, an empty
    slice or a body the kernel does not have into :func:`lookup_tiles`.
    Entries of kernels not in :data:`KERNEL_SPECS` are kept
    (``python -m repro_torch.analysis kernels`` flags them)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or cache_path()
        self._data: Optional[dict] = None

    def _load(self) -> dict:
        if self._data is not None:
            return self._data
        data: dict = {}
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    raw = json.load(f)
                if not isinstance(raw, dict):
                    raise ValueError(f"expected a JSON object, got "
                                     f"{type(raw).__name__}")
                data = self._validate(raw)
            except (ValueError, OSError) as e:
                warnings.warn(
                    f"ignoring corrupt tuning cache {self.path!r} ({e}); "
                    f"falling back to the shipped defaults and the split "
                    f"model; re-tune with `python -m "
                    f"repro_torch.kernels.autotune`", stacklevel=3)
        self._data = data
        return data

    def _validate(self, raw: dict) -> dict:
        data: dict = {}
        dropped = []
        for key, entry in raw.items():
            try:
                problems = check_keyed_entry(str(key), entry)
            except ValueError:      # a malformed key: its kernel's rules
                problems = validate_entry(str(key).split("/", 1)[0], entry)
            if problems:            # None (unknown kernel) and [] both pass
                dropped.append(f"{key}: " + "; ".join(problems))
                continue
            data[key] = entry
        if dropped:
            listing = "\n  ".join(dropped)
            warnings.warn(
                f"dropped {len(dropped)} illegal entr"
                f"{'y' if len(dropped) == 1 else 'ies'} from tuning cache "
                f"{self.path!r}:\n  {listing}\nre-tune with `python -m "
                f"repro_torch.kernels.autotune`", stacklevel=4)
        return data

    def lookup(self, key: str) -> Optional[dict]:
        entry = self._load().get(key)
        return entry if isinstance(entry, dict) else None

    def record(self, key: str, entry: dict,
               us_per_call: Optional[float] = None) -> None:
        entry = dict(entry)
        if us_per_call is not None:
            entry["us_per_call"] = float(us_per_call)
        self._load()[key] = entry

    def save(self) -> str:
        """Atomic write (tmp + rename) so a killed tune never corrupts."""
        data = self._load()
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return self.path


# The card's winners at the swept shapes where the winner is not the split
# model's pick and beat it in every run (NVIDIA H100 80GB HBM3 at 700 W,
# chip_smoke.py [autotune]; PERF.md names each with its times).  Keys
# (``<kernel>/<MxKxN>/<dtype>``) are platform-agnostic: they apply when
# the persisted cache has no entry for the call.  kv_dequant's body 1 at
# (2048, 512) timed 0.2 us under body 0, which runs that same bulk body
# there: not shipped.
SHIPPED_DEFAULTS: Dict[str, dict] = {
    # 24.2 us against the model's 8 slices' 25.6 and 26.0
    "q8_matmul/512x10240x512/int8": {"tile": "q8_matmul", "splits": 7},
}

_CACHE: Optional[TuningCache] = None
# (kernel, shape, dtype, sr, $REPRO_TORCH_TUNING_CACHE) -> SplitPlan or
# body: lookup_tiles' memo (a new cache path misses it)
_MEMO: dict = {}


def get_cache() -> TuningCache:
    global _CACHE
    if _CACHE is None or _CACHE.path != cache_path():
        # re-resolve when $REPRO_TORCH_TUNING_CACHE changes
        _CACHE = TuningCache()
    return _CACHE


def reset_cache() -> None:
    """Forget the loaded cache and every memoized lookup."""
    global _CACHE
    _CACHE = None
    _MEMO.clear()


def lookup_tiles(kernel: str, shape: tuple, dtype: str = "int8",
                 sr: bool = False):
    """The plan of a call of ``kernel`` at ``shape`` (a ``SplitPlan`` for
    a GEMM: (M, K, N), K the contraction; a body for a row kernel): the
    persisted cache (the platform's entry wins over ``any``), then
    :data:`SHIPPED_DEFAULTS`, then the split model.  ``sr``: the int8
    forward's rounding; a ``fused_fwd`` entry applies to the rounding of
    the tile it names (its ``SR`` twin or not), the other rounding reads
    past it.  Memoized per (kernel, shape, dtype, sr) and the value of
    ``$REPRO_TORCH_TUNING_CACHE``."""
    key = (kernel, shape, dtype, sr, os.environ.get(ENV_CACHE))
    hit = _MEMO.get(key)
    if hit is None:
        hit = _MEMO[key] = _lookup(kernel, tuple(shape), dtype, sr)
    return hit


def _rounding_matches(kernel: str, entry: dict, sr: bool) -> bool:
    """False for a ``fused_fwd`` entry tuned under the other rounding (its
    tile is the other twin): the SR decode tile runs one block an SM, the
    deterministic one two, so their splits differ."""
    twins = _FWD_TWINS.get(entry.get("tile")) if kernel == "fused_fwd" \
        else None
    return twins is None or twins[int(sr)].name == entry["tile"]


def _lookup(kernel: str, shape: tuple, dtype: str, sr: bool):
    cache = get_cache()
    for plat in (current_platform(), "any"):
        entry = cache.lookup(cache_key(kernel, shape, dtype, plat))
        if entry is not None and _rounding_matches(kernel, entry, sr):
            return resolve(kernel, shape, entry, dtype, sr)
    entry = SHIPPED_DEFAULTS.get(f"{kernel}/{shape_key(*shape)}/{dtype}")
    if entry is None or not _rounding_matches(kernel, entry, sr):
        entry = model_entry(kernel, shape, dtype, sr)
    return resolve(kernel, shape, entry, dtype, sr)


def record_tiles(kernel: str, shape, entry: dict,
                 us_per_call: Optional[float] = None, dtype: str = "int8",
                 platform: Optional[str] = None, save: bool = True) -> str:
    """Persist ``entry`` for ``kernel`` at ``shape`` (raises ValueError
    for an illegal one); drops the memo.  Returns the key."""
    problems = validate_entry(kernel, entry, shape if KERNEL_SPECS.get(
        kernel, {}).get("kind") != "rows" else None, dtype)
    if problems:
        raise ValueError(f"record_tiles({kernel!r}, {tuple(shape)}): "
                         + "; ".join(problems))
    cache = get_cache()
    key = cache_key(kernel, shape, dtype, platform)
    cache.record(key, entry, us_per_call)
    _MEMO.clear()
    if save:
        cache.save()
    return key


@contextlib.contextmanager
def forced(kernel: str, shape: tuple, entry: dict, dtype: str = "int8",
           sr: bool = False):
    """Within the block, :func:`lookup_tiles` answers ``entry`` for this
    call (the tuner's way to run a candidate through the wrapper)."""
    key = (kernel, tuple(shape), dtype, sr, os.environ.get(ENV_CACHE))
    _MEMO[key] = resolve(kernel, tuple(shape), entry, dtype, sr)
    try:
        yield
    finally:
        _MEMO.pop(key, None)


def autotune(kernel: str, shape, run_us: Callable[[dict], float], *,
             candidates: Optional[Iterable[dict]] = None,
             dtype: str = "int8", sr: bool = False, save: bool = True,
             log: Optional[Callable[[str], None]] = None) -> dict:
    """Time ``candidates`` (default :func:`tile_candidates`) through
    ``run_us`` (a timer returning µs a call), persist the winner and
    return it.  ``run_us`` is injectable so the unit tests drive the sweep
    with a fake timer.  A candidate that raises is skipped; when every one
    does, ValueError."""
    if candidates is None:
        candidates = tile_candidates(kernel, shape, dtype, sr)
    best: Optional[dict] = None
    best_us = float("inf")
    for entry in candidates:
        try:
            us = float(run_us(entry))
        except Exception as e:  # noqa: BLE001 — the sweep survives a bad one
            if log:
                log(f"  {kernel} {entry}: skipped ({type(e).__name__}: {e})")
            continue
        if log:
            log(f"  {kernel} {entry}: {us:.2f} us")
        if us < best_us:
            best, best_us = entry, us
    if best is None:
        raise ValueError(f"autotune({kernel!r}, {tuple(shape)}): every "
                         f"candidate failed")
    record_tiles(kernel, shape, best, best_us, dtype=dtype, save=save)
    return best


# ---------------------------------------------------------------------------
# Tuning on the card
# ---------------------------------------------------------------------------

# (kernel, shape, dtype): the smoke run's sweep (chip_smoke.py
# [autotune]): dX, q8_matmul (K-major B, the BHQ dX) and dW at statquant-tx's
# lm_head, q8_matmul at the unfused step's 512-wide GEMM, at 2048 rows and
# at (128, 2048, 8192), the int8 forward at granite's decode MLP
# up-projection and decode lm_head, both packed GEMMs at 8 and 4 bits
# there; the KV reads of a decode step (a layer's K and V, 8 slots x 256
# positions, pages of 16)
SWEEP_CASES = (
    ("fused_dx", (512, 10240, 512), "int8"),
    ("q8_matmul", (512, 10240, 512), "int8"),
    ("q8_matmul", (512, 512, 512), "int8"),
    ("q8_matmul", (2048, 2048, 2048), "int8"),
    ("q8_matmul", (128, 2048, 8192), "int8"),
    ("fused_dw", (512, 512, 10240), "int8"),
    ("fused_fwd", (8, 2048, 8192), "int8"),
    ("fused_fwd", (8, 2048, 49408), "int8"),
    ("fused_packed", (8, 2048, 8192), "int8"),
    ("q4_matmul", (8, 2048, 8192), "int8"),
    ("fused_packed", (8, 2048, 8192), "int4"),
    ("q4_matmul", (8, 2048, 8192), "int4"),
    ("fused_packed", (8, 2048, 49408), "int8"),
    ("q4_matmul", (8, 2048, 49408), "int8"),
    ("fused_packed", (8, 2048, 49408), "int4"),
    ("q4_matmul", (8, 2048, 49408), "int4"),
    ("kv_dequant", (2048, 512), "int8"),
    ("kv_gather", (8, 16, 16, 512), "int8"),
)


def case_call(kernel: str, shape, dtype: str, gen):
    """``(call, plain)`` for ``kernel`` at ``shape`` on random operands
    from ``gen`` (on its device), built as the main path builds them: the
    forward's by ``core.backend.fwd_operands`` (a weight packed at the
    key's width for the packed forward), dX's by ``dx_operands`` under
    PSQ, dW's by ``dw_operands``, ``q8_matmul``'s as BHQ's dX
    (``qt_gemm_nt``: 5-bit Householder codes against the transposed
    weight codes), ``packed_matmul``'s as ``_packed_gemm``, and the KV
    reads' from ``quantize_kv_rows`` (a zero scale every 97th row; a pool
    of pages, page 0 the garbage page).  The wrapper's call plans through
    :func:`lookup_tiles`; the second is its plain version's."""
    import torch

    from .. import prng
    from ..core import (QuantizerSpec, affine_factors, epilogue_coeffs,
                        get_quantizer, kv_fresh_code, quantize_kv_rows,
                        quantize_ptq_det)
    from ..core import backend
    from .fused_fqt import (fused_qboth_tn_matmul, fused_qboth_tn_matmul_plain,
                            fused_qlhs_matmul, fused_qlhs_matmul_plain,
                            fused_qlhs_packed_matmul,
                            fused_qlhs_packed_matmul_plain)
    from .kv_dequant import kv_dequant_rows_kv, kv_dequant_rows_kv_plain
    from .kv_gather import kv_gather_pages_kv, kv_gather_pages_kv_plain
    from .pack import pack_qtensor
    from .q4_matmul import packed_matmul, packed_matmul_plain
    from .q8_matmul import q8_matmul, q8_matmul_plain
    dev = gen.device

    def randn(*s):
        return torch.randn(*s, generator=gen, device=dev)

    def pair(fn, plain, args, **kw):
        return lambda: fn(*args, **kw), lambda: plain(*args, **kw)

    if kernel == "kv_dequant":
        sides = []
        for _ in range(2):
            c, sc, z = quantize_kv_rows(randn(*shape) * 3)
            sc[::97] = 0.0
            sides.append((c, sc[:, None].contiguous(),
                          z[:, None].contiguous()))
        return pair(kv_dequant_rows_kv, kv_dequant_rows_kv_plain, sides)
    if kernel == "kv_gather":
        B, nb, P, D = shape
        pools = []
        for _ in range(2):
            codes, sc, z = quantize_kv_rows(randn(1 + B * nb, P, D) * 3)
            codes[0], sc[0], z[0] = kv_fresh_code(), 1.0, 0.0
            pools.append((codes, sc, z))
        table = torch.arange(1, 1 + B * nb, device=dev,
                             dtype=torch.int32).reshape(B, nb)
        return pair(kv_gather_pages_kv, kv_gather_pages_kv_plain,
                    pools + [table])
    M, K, N = shape
    wbits = _WIDTHS[dtype]
    if kernel == "fused_dw":
        # the key is GEMM-logical: X (K tokens, M = d_in), dY (K, N)
        x, g = randn(K, M), randn(K, N) * 1e-3
        zx, sx = backend._ptq_range(x, 8)
        rbits = prng.bits(prng.PRNGKey(K + M + N), (K, N), dev)
        return pair(fused_qboth_tn_matmul, fused_qboth_tn_matmul_plain,
                    backend.dw_operands(x, sx, zx, 8, g, rbits, 8),
                    bits_a=8, bits_b=8)
    if kernel == "fused_dx":
        # dY (M, K) against the (N, K) = (d_in, d_out) weight codes
        g = randn(M, K) * 1e-3
        wq = quantize_ptq_det(randn(N, K) / K ** 0.5)
        rbits = prng.bits(prng.PRNGKey(M + K + N), (M, K), dev)
        return pair(fused_qlhs_matmul, fused_qlhs_matmul_plain,
                    backend.dx_operands(g, QuantizerSpec("psq", 8), wq,
                                        rbits), bits=8, trans_b=True)
    if kernel == "q8_matmul":
        a8 = torch.randint(-16, 16, (M, K), generator=gen, device=dev,
                           dtype=torch.int8)
        wq = quantize_ptq_det(randn(N, K) / K ** 0.5)
        bt8 = wq.int8_codes.T
        ab, bb = affine_factors(wq.scale, wq.zero, 8)
        coeffs = epilogue_coeffs(a8, 1.0, 16.0 + randn(M), bt8, ab, bb)
        return pair(q8_matmul, q8_matmul_plain,
                    (a8, bt8) + tuple(c.contiguous() for c in coeffs))
    x, w = randn(M, K), randn(K, N) / K ** 0.5
    if kernel == "fused_fwd":
        args, _, _ = backend.fwd_operands(x, quantize_ptq_det(w, 8), 8)
        return pair(fused_qlhs_matmul, fused_qlhs_matmul_plain, args, bits=8)
    if wbits == 1:          # the binary quantizer's sign plane
        pt = get_quantizer("binary").quantize(
            w, None, QuantizerSpec.of("binary"), backend="kernel")
    else:
        pt = pack_qtensor(quantize_ptq_det(w, wbits))
    if kernel == "fused_packed":
        args, _, _ = backend.fwd_operands(x, pt, 8)
        return pair(fused_qlhs_packed_matmul, fused_qlhs_packed_matmul_plain,
                    args, bits=8, wbits=wbits)
    aq = quantize_ptq_det(x, 8)
    aa, ba = affine_factors(aq.scale, aq.zero, 8)
    ab, bb = affine_factors(pt.scale, pt.zero, wbits)
    coeffs = epilogue_coeffs(aq.int8_codes, aa, ba, None, ab, bb,
                             colsum=pt.colsum)
    return pair(packed_matmul, packed_matmul_plain,
                (aq.int8_codes, pt.packed)
                + tuple(c.contiguous() for c in coeffs),
                wbits=wbits, kdim=K)


def time_us(fn, iters: int = 20) -> float:
    """Mean device time of one call of ``fn`` in µs: CUDA events around
    each of ``iters`` calls, a 128 MB write flushing the L2 before each."""
    import torch
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters * 1e3


def _same(a, b) -> bool:
    import torch
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def entry_of(plan) -> dict:
    """The cache entry of a resolved lookup: a plan's tile and split, or a
    body."""
    if isinstance(plan, int):
        return {"body": plan}
    return {"tile": plan.tile.name, "splits": plan.splits}


def tune_case(kernel: str, shape, dtype: str, gen, *, timer=time_us,
              log=None, save: bool = True) -> dict:
    """Tune one case on the card: every candidate through the wrapper
    (:func:`forced`) on :func:`case_call`'s operands from ``gen``, each
    held bit for bit to the planned call, which is held to the plain
    version; the winner persisted.  ``timer(fn)``: µs a call of ``fn``
    (:func:`time_us` by default).  Raises RuntimeError when any result
    differs.
    Returns ``{"planned", "model", "best": entry, "us": {json of a
    candidate: µs}, "skipped": [candidates that raised]}``."""
    import torch
    shape = tuple(shape)
    call, plain = case_call(kernel, shape, dtype, gen)
    planned = entry_of(lookup_tiles(kernel, shape, dtype))
    ref = call()
    torch.cuda.synchronize()
    if not _same(ref, plain()):
        raise RuntimeError(f"{kernel} {shape} {dtype}: the planned call "
                           f"differs from the plain version")
    times, differ, skipped = {}, [], []

    def run_us(entry):
        try:
            with forced(kernel, shape, entry, dtype):
                out = call()
                torch.cuda.synchronize()
                if not _same(out, ref):
                    differ.append(entry)
                    raise RuntimeError("differs from the planned call")
                us = timer(call)
        except Exception:
            skipped.append(entry)
            raise
        times[json.dumps(entry, sort_keys=True)] = us
        return us
    best = autotune(kernel, shape, run_us, dtype=dtype, save=save, log=log)
    if differ:
        raise RuntimeError(f"{kernel} {shape} {dtype}: {differ} differ from "
                           f"the planned call")
    return {"planned": planned, "model": model_entry(kernel, shape, dtype),
            "best": best, "us": times, "skipped": skipped}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.autotune",
        description="tune the kernels' tiles and splits on the card and "
                    "persist the winners")
    ap.add_argument("--case", action="append", metavar="KERNEL:DIMS[:DTYPE]",
                    help="e.g. q8_matmul:512x10240x512 or "
                         "q4_matmul:8x2048x8192:int4 (repeatable; default: "
                         "the smoke run's sweep, SWEEP_CASES)")
    ap.add_argument("--cache", default=None,
                    help=f"cache file (default: ${ENV_CACHE} or "
                         f"{_DEFAULT_CACHE_PATH})")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("autotune: no CUDA device", file=sys.stderr)
        return 2
    if args.cache:
        os.environ[ENV_CACHE] = args.cache
        reset_cache()
    cases = SWEEP_CASES
    if args.case:
        cases = []
        for c in args.case:
            kernel, dims, *dt = c.split(":")
            cases.append((kernel, tuple(int(d) for d in dims.split("x")),
                          dt[0] if dt else "int8"))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for kernel, shape, dtype in cases:
        r = tune_case(kernel, shape, dtype, gen)
        best_us = min(r["us"].values())
        model_us = r["us"].get(json.dumps(r["model"], sort_keys=True))
        print(f"[autotune] {kernel} {shape_key(*shape)} {dtype}: best "
              f"{r['best']} {best_us:.2f} us; model {r['model']} "
              f"{model_us:.2f} us; skipped {r['skipped']}", flush=True)
    print(f"[autotune] wrote {get_cache().path}")
    return 0


if __name__ == "__main__":
    # run the package's module (which the wrappers read: its memo and
    # cache), not this copy that ``python -m`` executes as __main__
    from repro_torch.kernels import autotune as _module
    sys.exit(_module.main())

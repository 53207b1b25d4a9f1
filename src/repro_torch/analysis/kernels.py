"""Static checker for the kernels' tile and split choices.

Port of ``repro.analysis.kernels``.  Walks every entry a kernel wrapper
can resolve (``kernels/autotune.py`` ``lookup_tiles``) —
:data:`~repro_torch.kernels.autotune.SHIPPED_DEFAULTS` plus every entry
of the persisted tuning cache (``~/.cache/repro_torch/tuning.json`` /
``$REPRO_TORCH_TUNING_CACHE``) — and verifies, without building or
launching anything:

  * **the tile**: one its kernel's library was built with (for a packed
    kernel, at the key's width);
  * **the split**: a cluster of 1 to 8 that leaves no slice of the key's
    K empty, with a ``k_span`` that is a multiple of 8;
  * **shared memory**: the tile's (``tile_smem_bytes``) under the H100's
    232,448 bytes a block;
  * **the body** of a row kernel: one its C entry has;
  * **key well-formedness**: persisted keys parse as
    ``<kernel>/<MxKxN>/<dtype>/<platform>`` with a legal dtype;
  * **staleness**: entries naming kernels no registered wrapper resolves.

Bad persisted entries are reported (and purged with ``--purge``); the
loader already refuses to serve them (``TuningCache._validate``), so this
checker is the part that *explains* and *cleans*, and the gate that keeps
SHIPPED_DEFAULTS legal as the kernels change.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

from ..kernels.autotune import (KERNEL_SPECS, SHIPPED_DEFAULTS,
                                SMEM_BUDGET_BYTES, TuningCache, cache_path,
                                check_keyed_entry, kernel_tiles,
                                tile_smem_bytes)

__all__ = ["KernelFinding", "KernelCheckReport", "check_kernels",
           "purge_bad_entries"]


@dataclasses.dataclass(frozen=True)
class KernelFinding:
    severity: str          # "error" | "stale" | "info"
    source: str            # "shipped" | "cache"
    key: str
    entry: Optional[dict]
    detail: str

    def __str__(self):
        e = "" if self.entry is None else f" entry={self.entry}"
        return f"[{self.severity}:{self.source}] {self.key}{e}: {self.detail}"


@dataclasses.dataclass(frozen=True)
class KernelCheckReport:
    findings: tuple
    n_shipped: int
    n_cache: int
    cache_file: str

    @property
    def errors(self) -> tuple:
        return tuple(f for f in self.findings if f.severity == "error")

    @property
    def ok(self) -> bool:
        return not self.errors

    def format(self, verbose: bool = False) -> str:
        lines = ["== kernel tile check =="]
        lines.append(f"shipped defaults: {self.n_shipped} entries; "
                     f"persisted cache: {self.n_cache} entries "
                     f"({self.cache_file}"
                     f"{'' if os.path.exists(self.cache_file) else ', absent'})")
        shown = [f for f in self.findings
                 if verbose or f.severity != "info"]
        lines.extend(f"  {f}" for f in shown)
        lines.append(f"tile check: "
                     f"{'OK' if self.ok else f'{len(self.errors)} error(s)'}"
                     f" ({len(self.findings)} finding(s), shared-memory "
                     f"budget {SMEM_BUDGET_BYTES} B a block)")
        return "\n".join(lines)


def _check_entry(source: str, key: str, entry) -> List[KernelFinding]:
    try:
        problems = check_keyed_entry(key, entry, platform=source == "cache")
    except ValueError as e:
        return [KernelFinding("error", source, key, None, str(e))]
    kernel = key.split("/", 1)[0]
    shown = entry if isinstance(entry, dict) else None
    if problems is None:
        return [KernelFinding(
            "stale", source, key, shown,
            f"kernel {kernel!r} has no registered wrapper (KERNEL_SPECS: "
            f"{', '.join(sorted(KERNEL_SPECS))}); entry is dead weight")]
    if problems:
        return [KernelFinding("error", source, key, shown, p)
                for p in problems]
    if KERNEL_SPECS[kernel]["kind"] == "rows":
        detail = f"body {entry['body']} of {KERNEL_SPECS[kernel]['lib']} OK"
    else:
        dtype = key.split("/")[2]
        tile = {t.name: t for t in kernel_tiles(kernel, dtype)}[entry["tile"]]
        smem = max(tile_smem_bytes(tile, 0), tile_smem_bytes(tile, 1))
        detail = (f"OK: {tile.name}, {entry['splits']} slice(s), {smem} B "
                  f"of shared memory a block "
                  f"({100.0 * smem / SMEM_BUDGET_BYTES:.0f}% of budget)")
    return [KernelFinding("info", source, key, shown, detail)]


def _read_raw(path: str):
    """(the persisted file's object or None, a problem string or None):
    a raw read, on purpose — the loader drops illegal entries, which would
    hide exactly what this checker must report."""
    if not os.path.exists(path):
        return {}, None
    try:
        with open(path) as f:
            loaded = json.load(f)
    except (ValueError, OSError) as e:
        return None, f"unreadable cache: {e}"
    if not isinstance(loaded, dict):
        return None, (f"cache is not a JSON object (got "
                      f"{type(loaded).__name__})")
    return loaded, None


def check_kernels(path: Optional[str] = None) -> KernelCheckReport:
    """Validate the shipped defaults and every persisted entry statically."""
    findings: List[KernelFinding] = []
    for key, entry in sorted(SHIPPED_DEFAULTS.items()):
        findings.extend(_check_entry("shipped", key, entry))
    cache_file = os.path.expanduser(path) if path else cache_path()
    raw, problem = _read_raw(cache_file)
    if problem:
        findings.append(KernelFinding("error", "cache", cache_file, None,
                                      problem))
    for key, entry in sorted((raw or {}).items()):
        findings.extend(_check_entry("cache", str(key), entry))
    return KernelCheckReport(findings=tuple(findings),
                             n_shipped=len(SHIPPED_DEFAULTS),
                             n_cache=len(raw or {}), cache_file=cache_file)


def purge_bad_entries(report: KernelCheckReport) -> int:
    """Remove every cache entry the report marks error or stale; returns
    the number purged.  Writes atomically (``TuningCache.save``)."""
    bad_keys = {f.key for f in report.findings
                if f.source == "cache" and f.severity in ("error", "stale")}
    if not bad_keys:
        return 0
    raw, _ = _read_raw(report.cache_file)
    raw = raw or {}
    kept = {k: v for k, v in raw.items() if k not in bad_keys}
    cache = TuningCache(report.cache_file)
    cache._data = kept
    cache.save()
    return len(raw) - len(kept)

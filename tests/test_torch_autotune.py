"""The tile and split autotuner (``kernels/autotune.py``), its checker
(``analysis/kernels.py``) and the shared-memory accounting, on the CPU;
the card-only cases carry the ``gpu`` marker.

Counterparts of the reference's autotuner cases (``tests/test_fused.py``:
the sweep with a fake timer persists the fastest, a raising candidate is
skipped, a corrupt cache falls back, the lookup's precedence) and of its
checker cases (``tests/test_analysis.py``: the loader drops illegal
entries with a warning, ``validate_entry``, the checker and ``--purge``,
the shipped defaults are legal, the CLI's JSON).  An entry here names a
tile the kernel's library was built with and a split of K (``{"tile",
"splits"}``), or a row kernel's body (``{"body"}``), in place of the
reference's (bm, bn, bk).  Also: ``tile_smem_bytes`` against every tile's
table (the figures each library's ``_tile`` entry reports, which the
smoke run holds to the card), the lookup's memo, and ``lookup_tiles``
falling back to the split model.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import splitk  # noqa: E402
from repro_torch.analysis import check_kernels  # noqa: E402
from repro_torch.analysis.kernels import purge_bad_entries  # noqa: E402

ALL_TILES = [splitk.Q8_TILE, splitk.DX_TILE, splitk.DW_TILE,
             splitk.FWD_DECODE_TILE, splitk.FWD_DECODE_SR_TILE,
             splitk.FWD_WIDE_TILE, splitk.FWD_WIDE_SR_TILE,
             *splitk.PACKED_TILES.values()]
Q8 = {"tile": "q8_matmul", "splits": 1}


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = tmp_path / "tuning.json"
    monkeypatch.setenv(at.ENV_CACHE, str(path))
    at.reset_cache()
    yield path
    at.reset_cache()


def _q8(splits):
    return {"tile": "q8_matmul", "splits": splits}


# ---------------------------------------------------------------------------
# Shared-memory accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", ALL_TILES, ids=lambda t: t.name)
def test_smem_formula_matches_each_tiles_table(tile):
    """tile_smem_bytes equals the two figures each tile's table holds
    (what its library's <lib>_tile reports), and every tile fits the
    H100's 232,448 bytes a block."""
    got = (at.tile_smem_bytes(tile, 0), at.tile_smem_bytes(tile, 1))
    assert got == tile.smem
    assert max(got) <= at.SMEM_BUDGET_BYTES == 227 * 1024
    assert tile.lib in splitk.SMEM_VARIANTS


def test_smem_formula_follows_layout_and_rounding():
    """q8_matmul's N-major B adds the K-major tile it transposes into;
    SR bits in the ring cost 8 bytes a LHS element a stage; a packed B
    stage shrinks with the width."""
    t = splitk.Q8_TILE
    assert at.tile_smem_bytes(t, 1) - at.tile_smem_bytes(t, 0) == t.bn * t.bk
    w = splitk.FWD_WIDE_TILE
    assert (at.tile_smem_bytes(w, 0) - at.tile_smem_bytes(w, 1)
            == w.stages * w.bm * w.bk * 8)
    dec = [splitk.PACKED_TILES["packed_matmul", 0, b] for b in (1, 2, 4, 8)]
    sizes = [at.tile_smem_bytes(t) for t in dec]
    assert sizes == sorted(sizes) and len(set(sizes)) == 4


# ---------------------------------------------------------------------------
# Entries and candidates
# ---------------------------------------------------------------------------

def test_validate_entry():
    shape = (512, 512, 512)
    assert at.validate_entry("q8_matmul", Q8, shape) == []
    assert at.validate_entry("nope", Q8, shape) is None
    # a tile the library was not built with
    assert at.validate_entry("q8_matmul", {"tile": "fused_qlhs_dx",
                                           "splits": 1}, shape)
    # a split outside 1..8, or one that empties a slice (8 K steps)
    assert at.validate_entry("q8_matmul", _q8(9), shape)
    assert at.validate_entry("q8_matmul", _q8(0), shape)
    assert at.validate_entry("q8_matmul", _q8(8), shape) == []
    assert at.validate_entry("q8_matmul", _q8(8), (512, 448, 512))
    # a geometry over the budget (and not built)
    big = {"tile": {"bm": 512, "bn": 512, "bk": 128, "stages": 4},
           "splits": 1}
    problems = at.validate_entry("fused_dw", big, shape)
    assert any("built with" in p for p in problems)
    assert any("shared memory" in p for p in problems)
    # a k_span off the 8-code grid
    odd = {"tile": {"bm": 64, "bn": 128, "bk": 12, "stages": 2}, "splits": 3}
    assert any("multiple of 8" in p for p in
               at.validate_entry("q8_matmul", odd, shape))
    # the row kernels take a body their C entry has
    assert at.validate_entry("kv_dequant", {"body": 1}) == []
    assert at.validate_entry("kv_gather", {"body": 3})
    assert at.validate_entry("kv_gather", [256, 0, 0])
    # a packed kernel's tile at the key's width
    w4 = {"tile": "packed_matmul decode w4", "splits": 2}
    assert at.validate_entry("q4_matmul", w4, (8, 2048, 8192), "int4") == []
    assert at.validate_entry("q4_matmul", w4, (8, 2048, 8192), "int2")


def test_tile_candidates_cover_every_legal_split():
    """The sweep: each tile the kernel was built with (the int8 forward's
    decode and wide tiles, the SR twins when SR rounds) crossed with every
    split that leaves no slice empty, each a legal entry."""
    shape = (8, 2048, 8192)
    det = at.tile_candidates("fused_fwd", shape)
    sr = at.tile_candidates("fused_fwd", shape, sr=True)
    assert {c["tile"] for c in det} == {splitk.FWD_DECODE_TILE.name,
                                        splitk.FWD_WIDE_TILE.name}
    assert {c["tile"] for c in sr} == {splitk.FWD_DECODE_SR_TILE.name,
                                       splitk.FWD_WIDE_SR_TILE.name}
    assert len(det) == 16                      # 32 K steps: every split
    for c in det:
        assert at.validate_entry("fused_fwd", c, shape) == []
    small = at.tile_candidates("q8_matmul", (64, 128, 128))
    assert [c["splits"] for c in small] == [1, 2]
    assert at.tile_candidates("kv_gather", (8, 16, 16, 512)) == (
        {"body": 0}, {"body": 1}, {"body": 2})
    for c in at.tile_candidates("fused_packed", (8, 1001, 300), "int2"):
        assert c["tile"].endswith("w2")
        assert at.validate_entry("fused_packed", c, (8, 1001, 300),
                                 "int2") == []


@pytest.mark.parametrize("kernel,shape,dtype", [
    ("q8_matmul", (512, 1024, 512), "int8"),
    ("fused_dx", (512, 1024, 512), "int8"),
    ("fused_dw", (512, 512, 1024), "int8"),
    ("fused_fwd", (8, 2048, 2048), "int8"),
    ("fused_fwd", (2048, 2048, 8192), "int8"),
    ("fused_packed", (8, 2048, 512), "int4"),
    ("q4_matmul", (128, 2048, 8192), "int4")])
def test_lookup_falls_back_to_the_split_model(tmp_cache, kernel, shape,
                                              dtype):
    """With no cache entry and no shipped default (none at these shapes),
    the wrappers' lookup gives splitk.plan's plan for the tile the wrapper
    takes by M, and the GEMM-logical key reads (M, K, N) as (M, N, K) of
    the plan."""
    assert f"{kernel}/{at.shape_key(*shape)}/{dtype}" not in \
        at.SHIPPED_DEFAULTS
    M, K, N = shape
    tile = {"q8_matmul": splitk.Q8_TILE, "fused_dx": splitk.DX_TILE,
            "fused_dw": splitk.DW_TILE,
            "fused_fwd": splitk.fwd_tile(M, False),
            "fused_packed": splitk.packed_tile("fused_qlhs_packed", M, 4),
            "q4_matmul": splitk.packed_tile("packed_matmul", M, 4)}[kernel]
    p = at.lookup_tiles(kernel, shape, dtype)
    want = splitk.plan(tile, M, N, K)
    assert (p.tile, p.splits, p.k_span, p.M, p.N, p.K) == (
        tile, want.splits, want.k_span, M, N, K)


def test_forward_entry_applies_to_the_rounding_it_names(tmp_cache):
    """An int8-forward key has no rounding segment: an entry names the
    deterministic tile or its SR twin and applies to that rounding only;
    the other rounding reads past it to the model (the decode tile's SR
    twin runs one block an SM, not two, so its split differs)."""
    shape = (8, 2048, 8192)
    at.record_tiles("fused_fwd", shape, {"tile": splitk.FWD_WIDE_TILE.name,
                                         "splits": 3})
    det = at.lookup_tiles("fused_fwd", shape)
    sr = at.lookup_tiles("fused_fwd", shape, sr=True)
    assert (det.tile, det.splits) == (splitk.FWD_WIDE_TILE, 3)
    model = splitk.plan(splitk.FWD_DECODE_SR_TILE, 8, 8192, 2048)
    assert (sr.tile, sr.splits) == (splitk.FWD_DECODE_SR_TILE, model.splits)
    at.record_tiles("fused_fwd", shape,
                    {"tile": splitk.FWD_DECODE_SR_TILE.name, "splits": 2})
    sr = at.lookup_tiles("fused_fwd", shape, sr=True)
    det = at.lookup_tiles("fused_fwd", shape)
    assert (sr.tile, sr.splits) == (splitk.FWD_DECODE_SR_TILE, 2)
    assert (det.tile, det.splits) == (
        splitk.FWD_DECODE_TILE,
        splitk.plan(splitk.FWD_DECODE_TILE, 8, 8192, 2048).splits)


def test_memo_follows_the_cache_path(tmp_path, monkeypatch):
    """A lookup memoized under one ``$REPRO_TORCH_TUNING_CACHE`` is not
    served under another: each path's own entry answers."""
    shape = (512, 2048, 512)
    for name, splits in (("a.json", 5), ("b.json", 6)):
        monkeypatch.setenv(at.ENV_CACHE, str(tmp_path / name))
        at.record_tiles("q8_matmul", shape, _q8(splits))
    for name, splits in (("a.json", 5), ("b.json", 6), ("a.json", 5)):
        monkeypatch.setenv(at.ENV_CACHE, str(tmp_path / name))
        assert at.lookup_tiles("q8_matmul", shape).splits == splits
    at.reset_cache()


@pytest.mark.parametrize("kernel,shape,dtype", [
    ("fused_dx", (64, 256, 96), "int8"), ("q8_matmul", (64, 256, 96), "int8"),
    ("fused_dw", (64, 96, 128), "int8"), ("fused_fwd", (8, 256, 96), "int8"),
    ("fused_packed", (8, 256, 96), "int4"),
    ("fused_packed", (8, 256, 96), "int1"),
    ("q4_matmul", (8, 1001, 300), "int2"),
    ("kv_dequant", (200, 64), "int8"), ("kv_gather", (2, 4, 16, 64), "int8")])
def test_case_call_builds_the_main_paths_operands(kernel, shape, dtype):
    """The tuner's operands (the smoke run's and the CLI's): on the CPU
    the wrapper runs its plain version, so the pair agree bit for bit, at
    the output's shape, finite."""
    call, plain = at.case_call(kernel, shape, dtype,
                               torch.Generator().manual_seed(0))
    got, want = call(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w) and bool(torch.isfinite(g).all())
    if kernel in ("kv_dequant", "kv_gather"):
        assert (got[0].shape[0], got[0].shape[-1]) == (shape[0], shape[-1])
    else:
        assert got[0].shape == (shape[0], shape[2])


def test_shipped_defaults_are_legal_and_differ_from_the_model():
    """Each shipped default is legal at its key and is a card's winner
    that the split model does not pick (else it would not be shipped)."""
    report = check_kernels("/nonexistent/tuning.json")
    assert report.ok, report.format()
    assert report.n_shipped == len(at.SHIPPED_DEFAULTS)
    for key, entry in at.SHIPPED_DEFAULTS.items():
        kernel, shape, dtype = key.split("/")
        dims = tuple(int(d) for d in shape.split("x"))
        assert entry != at.model_entry(kernel, dims, dtype, card=False)


# ---------------------------------------------------------------------------
# The persisted cache and the lookup
# ---------------------------------------------------------------------------

def test_autotune_picks_fastest_and_persists(tmp_cache):
    calls = []
    us = {1: 50.0, 2: 10.0, 4: 99.0}

    def fake_timer(entry):
        calls.append(entry)
        return us[entry["splits"]]

    best = at.autotune("q8_matmul", (64, 512, 128), fake_timer,
                       candidates=[_q8(s) for s in (1, 2, 4)])
    assert best == _q8(2)
    assert len(calls) == 3
    assert tmp_cache.exists()
    # a fresh cache object reads the persisted winner back
    at.reset_cache()
    assert at.lookup_tiles("q8_matmul", (64, 512, 128)).splits == 2
    data = json.loads(tmp_cache.read_text())
    [key] = data
    assert key == f"q8_matmul/64x512x128/int8/{at.current_platform()}"
    assert data[key]["us_per_call"] == 10.0


def test_autotune_skips_raising_candidates(tmp_cache):
    def flaky(entry):
        if entry["splits"] == 1:
            raise RuntimeError("bad split")
        return 1.0

    best = at.autotune("q8_matmul", (64, 512, 128), flaky,
                       candidates=[_q8(1), _q8(2)])
    assert best == _q8(2)
    with pytest.raises(ValueError, match="every candidate failed"):
        at.autotune("q8_matmul", (64, 512, 128),
                    lambda e: (_ for _ in ()).throw(RuntimeError("x")),
                    candidates=[_q8(1)])


def test_corrupt_cache_falls_back(tmp_cache):
    tmp_cache.write_text("{not json")
    at.reset_cache()
    shape = (512, 10240, 512)
    with pytest.warns(UserWarning, match="corrupt tuning cache"):
        p = at.lookup_tiles("q8_matmul", shape)
    # the shipped default, else the model, through the degraded cache
    want = at.SHIPPED_DEFAULTS.get("q8_matmul/512x10240x512/int8",
                                   at.model_entry("q8_matmul", shape))
    assert p.splits == want["splits"]


def test_lookup_precedence(tmp_cache):
    shape = (512, 1024, 512)
    model = splitk.plan(splitk.Q8_TILE, 512, 512, 1024).splits
    assert at.lookup_tiles("q8_matmul", shape).splits == model
    # the legal splits of 16 K steps other than the model's
    other = [s for s in (1, 2, 3, 4, 6, 8) if s != model]
    # platform-agnostic "any" beats the model (and the shipped defaults)
    at.record_tiles("q8_matmul", shape, _q8(other[0]), platform="any")
    assert at.lookup_tiles("q8_matmul", shape).splits == other[0]
    # the platform's own entry beats "any"
    at.record_tiles("q8_matmul", shape, _q8(other[1]),
                    platform=at.current_platform())
    assert at.lookup_tiles("q8_matmul", shape).splits == other[1]
    # a row kernel: its body; the model's is the C entry's own choice (0)
    assert at.lookup_tiles("kv_dequant", (2048, 512)) == 0
    at.record_tiles("kv_dequant", (2048, 512), {"body": 2})
    assert at.lookup_tiles("kv_dequant", (2048, 512)) == 2


def test_lookup_is_memoized_and_record_invalidates(tmp_cache, monkeypatch):
    """A second lookup reads no file and resolves nothing; record_tiles
    and reset_cache drop the memo."""
    shape = (512, 2048, 512)
    first = at.lookup_tiles("q8_matmul", shape)

    def no_io(*a, **kw):
        raise AssertionError("the memoized lookup touched the cache")
    monkeypatch.setattr(at.TuningCache, "_load", no_io)
    monkeypatch.setattr(at, "_lookup", no_io)
    assert at.lookup_tiles("q8_matmul", shape) is first
    monkeypatch.undo()
    monkeypatch.setenv(at.ENV_CACHE, str(tmp_cache))
    at.record_tiles("q8_matmul", shape, _q8(5))
    assert at.lookup_tiles("q8_matmul", shape).splits == 5
    at.reset_cache()
    assert at.lookup_tiles("q8_matmul", shape).splits == 5   # from the file


def test_forced_entry_answers_inside_the_block_only(tmp_cache):
    shape = (512, 2048, 512)
    base = at.lookup_tiles("q8_matmul", shape)
    with at.forced("q8_matmul", shape, _q8(6)):
        assert at.lookup_tiles("q8_matmul", shape).splits == 6
    assert at.lookup_tiles("q8_matmul", shape) == base


def test_entries_naming_what_the_library_lacks_raise(tmp_cache):
    """No silent fallback: recording, or resolving, an entry with a tile
    or body the kernel does not have raises."""
    with pytest.raises(ValueError, match="built with"):
        at.record_tiles("q8_matmul", (512, 512, 512),
                        {"tile": "q8_matmul wide", "splits": 1})
    with pytest.raises(ValueError, match="bodies"):
        at.record_tiles("kv_gather", (8, 16, 16, 512), {"body": 5})
    with pytest.raises(ValueError, match="built with"):
        with at.forced("q8_matmul", (512, 512, 512),
                       {"tile": "nope", "splits": 1}):
            pass


# ---------------------------------------------------------------------------
# The loader and the checker (analysis/kernels.py)
# ---------------------------------------------------------------------------

_BAD_CACHE = {
    # legal
    "q8_matmul/64x512x128/int8/any": _q8(2),
    # a tile the kernel was not built with
    "q8_matmul/64x512x128/int8/cpu": {"tile": "q8_matmul wide",
                                      "splits": 1},
    # a split that empties a slice (16 K steps of 32 cannot make 7)
    "fused_dw/512x512x1024/int8/any": {"tile": "fused_qboth_tn",
                                       "splits": 7},
    # a tile over the 232,448-byte budget
    "fused_fwd/512x1024x1024/int8/any": {
        "tile": {"bm": 128, "bn": 512, "bk": 128, "stages": 4},
        "splits": 1},
    # malformed entry shape
    "fused_dx/512x1024x1024/int8/any": [128, 512, 512],
    # unknown kernel: kept by the loader, flagged stale by the checker
    "mystery_kernel/8x8x8/int8/any": {"tile": "x", "splits": 1},
}


def test_loader_drops_illegal_entries_with_warning(tmp_cache):
    tmp_cache.write_text(json.dumps(_BAD_CACHE))
    at.reset_cache()
    with pytest.warns(UserWarning, match="dropped 4 illegal entries"):
        p = at.lookup_tiles("q8_matmul", (64, 512, 128))
    assert p.splits == 2                      # the legal "any" entry
    cache = at.get_cache()
    assert cache.lookup("q8_matmul/64x512x128/int8/cpu") is None
    assert cache.lookup("fused_dw/512x512x1024/int8/any") is None
    assert cache.lookup("fused_fwd/512x1024x1024/int8/any") is None
    # unknown-kernel entry is kept (forward compat)
    assert cache.lookup("mystery_kernel/8x8x8/int8/any") == {
        "tile": "x", "splits": 1}


def test_kernel_checker_and_purge(tmp_cache):
    tmp_cache.write_text(json.dumps(dict(
        _BAD_CACHE, **{"q8_matmul/8x8": _q8(1),
                       "kv_dequant/2048x512/int8/any": {"body": 9}})))
    report = check_kernels(str(tmp_cache))
    assert not report.ok
    bad = {f.key for f in report.findings if f.severity == "error"}
    assert "q8_matmul/64x512x128/int8/cpu" in bad         # not built
    assert "fused_dw/512x512x1024/int8/any" in bad        # empty slice
    assert "fused_fwd/512x1024x1024/int8/any" in bad      # over budget
    assert "fused_dx/512x1024x1024/int8/any" in bad       # malformed
    assert "q8_matmul/8x8" in bad                         # bad key shape
    assert "kv_dequant/2048x512/int8/any" in bad          # no such body
    over = [f.detail for f in report.findings
            if f.key == "fused_fwd/512x1024x1024/int8/any"]
    assert any("shared memory" in d and "232448" in d for d in over)
    stale = {f.key for f in report.findings if f.severity == "stale"}
    assert "mystery_kernel/8x8x8/int8/any" in stale

    n = purge_bad_entries(report)
    assert n == 7
    clean = check_kernels(str(tmp_cache))
    assert clean.ok and clean.n_cache == 1                # only the good one


def _cli(argv, capsys):
    from repro_torch.analysis.__main__ import main
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_cli_kernels_json_and_purge(tmp_cache, capsys):
    rc, out = _cli(["kernels", "--format", "json"], capsys)
    doc = json.loads(out)
    assert doc["tool"] == "kernels" and doc["ok"] and rc == 0
    for f in doc["findings"]:
        assert {"rule", "severity", "path", "detail"} <= set(f)
    # a tile the kernel lacks, a split that empties a slice, a tile over
    # the budget: non-zero; --purge removes them
    tmp_cache.write_text(json.dumps(
        {k: v for k, v in _BAD_CACHE.items()
         if k.startswith(("q8", "fused_dw", "fused_fwd"))}))
    rc, out = _cli(["kernels", "--cache", str(tmp_cache)], capsys)
    assert rc == 1
    for key in ("q8_matmul/64x512x128/int8/cpu",
                "fused_dw/512x512x1024/int8/any",
                "fused_fwd/512x1024x1024/int8/any"):
        assert f"[error:cache] {key}" in out
    rc, out = _cli(["kernels", "--cache", str(tmp_cache), "--purge"], capsys)
    assert "purged 3 bad/stale cache entries" in out
    rc, _ = _cli(["kernels", "--cache", str(tmp_cache)], capsys)
    assert rc == 0
    assert list(json.loads(tmp_cache.read_text())) == [
        "q8_matmul/64x512x128/int8/any"]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) with the CUDA toolkit")
    return torch.device("cuda")


@pytest.mark.gpu
def test_smem_equals_each_librarys_tile_report(cuda):
    import ctypes

    from repro_torch.kernels.build import load_library
    for tile in ALL_TILES:
        cfg = (ctypes.c_int * 8)()
        fn = getattr(load_library(tile.lib), tile.lib + "_tile")
        if tile.lib in ("fused_qlhs_fwd",) + splitk.PACKED_LIBS:
            fn(tile.mode, cfg)
        else:
            fn(cfg)
        assert list(cfg)[:6] == [tile.bm, tile.bn, tile.bk, tile.threads,
                                 tile.nacc, tile.stages], tile.name
        assert (cfg[6], cfg[7]) == tile.smem == (
            at.tile_smem_bytes(tile, 0), at.tile_smem_bytes(tile, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,shape,dtype", [
    ("q8_matmul", (512, 512, 512), "int8"),
    ("fused_packed", (8, 1001, 300), "int2"),
    ("kv_dequant", (33, 128), "int8")])
def test_tune_case_on_the_card(cuda, tmp_cache, kernel, shape, dtype):
    """Every candidate through the wrapper, bit for bit with the planned
    call and the plain version; the winner persisted and served."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    r = at.tune_case(kernel, shape, dtype, gen, timer=lambda fn: 1.0)
    assert len(r["us"]) == len(at.tile_candidates(kernel, shape, dtype))
    at.reset_cache()
    got = at.lookup_tiles(kernel, shape, dtype)
    if "body" in r["best"]:
        assert got == r["best"]["body"]
    else:
        assert (got.tile.name, got.splits) == (r["best"]["tile"],
                                               r["best"]["splits"])

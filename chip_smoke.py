#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N]

From the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit.  It imports nothing of JAX or of the JAX package ``repro``.

  1. Prints the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
     name and power limit); exits non-zero with no result when there is no
     CUDA device or no ``src/repro_torch`` beside this file.
  2. Builds every kernel of ``src/repro_torch/csrc`` into
     ``build/repro_torch`` (one nvcc per source, in parallel) and times it.
  3. Holds each kernel against its plain PyTorch version on the card:
     ``fused_qlhs_matmul`` (forward) at every (K, N) of granite-3-2b's
     serving path for M in {1, 8, 128} plus ragged shapes; its dX/SR mode,
     ``q8_matmul`` and ``fused_qboth_tn_matmul`` at every GEMM of the
     statquant-tx training step (512 tokens), at granite-3-2b's (K, N)
     with 2048 tokens, and ragged; all within max|kernel - plain| <= 1e-6
     * max|plain| (float32 round-off; the kernels round each operation
     explicitly, so 0 is expected), and ``kv_dequant_rows`` bit for bit.
  4. Serves granite-3-2b at full width (40 layers, random weights from the
     seed) through ``ServeEngine(slots=8, max_seq=256, kv_quant=True)`` on
     the ``kernel`` backend: 16 requests, prompts of 16-128 tokens,
     ``max_new=32``, greedy plus a few temperature/top-k requests.  Launch
     counters are zeroed just before and read just after; each must
     equal the count the path implies.  Two requests served
     through the kernels and again through their plain versions (on the
     card) must give the same tokens and prefill logits.  Against the
     ``simulate`` backend (TF32 off), held to the repo's cross-backend
     tolerance (rtol 1e-3, atol 5e-3): every quantized GEMM of one
     full-width, full-depth prefill, each re-run on ``simulate`` from the
     input the kernel path gave it, and the prefill logits of the reduced
     config.  The full-width prefill logits are measured beside the
     quantizers' own effect (``simulate`` vs ``exact``) and not held to
     that tolerance: per-tensor ``Q_f`` turns the two backends' float32
     round-off into whole-code flips, and the JAX package's own backends
     differ as much at this width (tests/test_torch_fullwidth.py).
  5. A short statquant-tx full-width serving run (layernorm, gelu, qkv
     bias), with the same checks.
  6. Trains statquant-tx at full width and depth (6 layers, d=512,
     d_ff=1024, padded vocab 10,240; random weights from the seed) for 5
     steps of 8 x 64 tokens through the engine ``launch/train.py`` builds
     (AdamW, cosine schedule), on the ``kernel`` backend, under
     ``fqt(psq, 8)`` and under ``fqt(bhq, 5)`` (bhq_block 256, the
     launcher's default).  Checked: each policy's kernels launch exactly
     37 times a step (36 layer GEMMs and lm_head), the rest not at all;
     the same steps with the kernels swapped for their plain versions
     give the same loss and gradient norm; every backward GEMM of one
     step, re-run on ``simulate`` from its (x, w, key, dY), gives dX and
     dW within rtol 1e-3 / atol 5e-3 and, since the gradients are far
     smaller than that atol, within rtol 1e-3 plus an atol of 5e-3 times
     that GEMM's max|dX| or max|dW|.  The loss trajectory against
     ``simulate`` is printed, not held (per-tensor code flips, as in 4).
  7. Times each kernel at its path shapes (the serving kernels at the
     decode and prefill shapes, the training kernels at the statquant-tx
     step's) with CUDA events after warm-up, an L2 flush before every
     launch and every launch queued behind a spin kernel (device time,
     not host dispatch), beside its plain version, ``torch._int_mm`` on
     the same int8 shapes as the library yardstick (the bare int8
     product, without the quantize and epilogue), and its bound (bytes
     over 3.35 TB/s or int8 operations over 1,979 TOP/s, the H100 SXM
     data-sheet peaks).  Then profiles one granite decode step and one
     training step under each policy: wall time, device busy time and
     idle share, device time by op and by kernel.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Any failed phase exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12
# least device spin per timed call (about 2 ms at the H100's clocks), so
# the host queues every timed call before the card reaches the first
SPIN_CYCLES_PER_CALL = 4_000_000
KERNEL_TOL = 1e-6                  # max|kernel - plain| <= TOL * max|plain|
# the repo's cross-backend tolerance (tests/test_backend.py,
# tests/test_fqt.py)
RTOL, ATOL = 1e-3, 5e-3
# the backward GEMMs' atol as a fraction of the reference's largest entry
GRAD_ATOL_FRAC = 5e-3

# (K, N) of every fused_qlhs_matmul on granite-3-2b's serving path
GRANITE_KN = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
              (2048, 49408)]


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def log(*a) -> None:
    print(*a, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: no src/repro_torch beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"[device] {kind} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    report = {"device": kind, "nvidia_smi": smi, "seed": args.seed}

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {report['build_s']:.2f}s "
        + " ".join(f"{n}={r['seconds']:.2f}s" for n, r in built.items()))
    for name, r in built.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    errs = kernel_vs_plain(torch, report)
    errs.update(train_kernel_vs_plain(torch, report))
    serve, granite_engine = serve_granite(torch, args.seed, report)
    serve_statquant(torch, args.seed, report)
    train = train_statquant(torch, args.seed, report)
    timings = time_kernels(torch, report)
    serve["profile_decode_step"] = _profile_decode(torch, granite_engine)

    def entry(name, key, source, replaces, launches):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=errs[key], **timings[key])
    csrc = "src/repro_torch/csrc/"
    kernels = [
        entry("fused_qlhs_matmul", "fused_qlhs_matmul",
              csrc + "fused_qlhs.cu", "src/repro/kernels/fused_fqt.py:93",
              serve["launches"]["fused_qlhs_matmul"]),
        entry("kv_dequant_rows", "kv_dequant_rows", csrc + "kv_dequant.cu",
              "src/repro/kernels/kv_dequant.py:31",
              serve["launches"]["kv_dequant_rows"]),
        entry("fused_qlhs_matmul (dX, SR)", "fused_qlhs_matmul_dx",
              csrc + "fused_qlhs.cu", "src/repro/kernels/fused_fqt.py:93",
              train["launches"]["fused_qlhs_matmul_dx"]),
        entry("q8_matmul", "q8_matmul", csrc + "q8_matmul.cu",
              "src/repro/kernels/q8_matmul.py:38",
              train["launches"]["q8_matmul"]),
        entry("fused_qboth_tn_matmul", "fused_qboth_tn_matmul",
              csrc + "fused_qboth_tn.cu", "src/repro/kernels/fused_fqt.py:215",
              train["launches"]["fused_qboth_tn_matmul"]),
    ]
    report["kernels"] = kernels
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# kernel operands, shaped as the serving path builds them
# ---------------------------------------------------------------------------

def qlhs_operands(torch, gen, M, K, N):
    """fused_qlhs_matmul's arguments exactly as core/backend.fused_fqt_fwd
    builds them, from random activations and weights."""
    from repro_torch.core import affine_factors, quantize_ptq_det
    from repro_torch.core.backend import _ptq_range
    dev = gen.device
    x = torch.randn(M, K, generator=gen, device=dev)
    w = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
    wq = quantize_ptq_det(w, 8)
    w8 = wq.int8_codes
    ab, bb = affine_factors(wq.scale, wq.zero, 8)
    u = ab * w8.to(torch.int32).sum(dim=0).to(torch.float32) + float(K) * bb
    zero, scale = _ptq_range(x, 8)
    sa = scale.reshape(1, 1).expand(M, 1).contiguous()
    za = zero.reshape(1, 1).expand(M, 1).contiguous()
    return (x, sa, za, None, w8, ab, bb, u)


def gemm_vs_simulate(torch, gen, M, K, N, rows) -> None:
    """One quantized GEMM, ``fqt_matmul`` on the kernel backend vs the
    simulate backend, held to the repo's cross-backend tolerance."""
    from repro_torch.core import QuantPolicy, fqt_matmul
    x = torch.randn(M, K, generator=gen, device=gen.device)
    w = torch.randn(K, N, generator=gen, device=gen.device) / K ** 0.5
    a = fqt_matmul(x, w, None, QuantPolicy.qat(backend="kernel"))
    b = fqt_matmul(x, w, None, QuantPolicy.qat(backend="simulate"))
    err = float((a - b).abs().max())
    rows.append(dict(kernel="fqt_matmul kernel vs simulate", shape=[M, K, N],
                     max_abs_err=err))
    log(f"[kernel] fqt_matmul kernel vs simulate {(M, K, N)} "
        f"max|d|={err:.3g} (rtol {RTOL}, atol {ATOL})")
    check(within_tol(a, b), f"fqt_matmul {(M, K, N)}: kernel vs simulate "
                            f"differ by {err} beyond rtol {RTOL}/atol {ATOL}")


def within_tol(got, want) -> bool:
    """|got - want| <= ATOL + RTOL * |want| everywhere."""
    return bool(((got - want).abs() <= ATOL + RTOL * want.abs()).all())


def kv_operands(torch, gen, M, N):
    from repro_torch.core import quantize_kv_rows
    x = torch.randn(M, N, generator=gen, device=gen.device) * 3
    c, s, z = quantize_kv_rows(x)
    return c, s[:, None].contiguous(), z[:, None].contiguous()


def kernel_vs_plain(torch, report) -> dict:
    from repro_torch.kernels import (fused_qlhs_matmul,
                                     fused_qlhs_matmul_plain,
                                     kv_dequant_rows, kv_dequant_rows_plain)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows, worst = [], {"fused_qlhs_matmul": 0.0, "kv_dequant_rows": 0.0}
    shapes = [(m, k, n) for (k, n) in GRANITE_KN for m in (1, 8, 128)]
    shapes += [(37, 130, 67), (37, 67, 130)]
    for (M, K, N) in shapes:
        ops = qlhs_operands(torch, gen, M, K, N)
        got = fused_qlhs_matmul(*ops, bits=8)
        ref = fused_qlhs_matmul_plain(*ops, bits=8)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        rows.append(dict(kernel="fused_qlhs_matmul", shape=[M, K, N],
                         max_abs_err=err, max_abs_ref=scale))
        log(f"[kernel] fused_qlhs_matmul {(M, K, N)} max|d|={err:.3g} "
            f"max|ref|={scale:.4g}")
        check(bool(torch.isfinite(got).all()), f"non-finite output {M, K, N}")
        check(err <= KERNEL_TOL * scale,
              f"fused_qlhs_matmul {(M, K, N)}: max|d| {err} > "
              f"{KERNEL_TOL} * {scale}")
        worst["fused_qlhs_matmul"] = max(worst["fused_qlhs_matmul"], err)
        gemm_vs_simulate(torch, gen, M, K, N, rows)
    for (M, N) in [(2048, 512), (33, 130)]:
        c, s, z = kv_operands(torch, gen, M, N)
        got = kv_dequant_rows(c, s, z)
        ref = kv_dequant_rows_plain(c, s, z)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        err = float((got - ref).abs().max())
        rows.append(dict(kernel="kv_dequant_rows", shape=[M, N],
                         max_abs_err=err, bit_identical=same))
        log(f"[kernel] kv_dequant_rows {(M, N)} bit-identical={same}")
        check(same, f"kv_dequant_rows {(M, N)} differs from plain by {err}")
    report["kernel_vs_plain"] = rows
    return worst


def dx_operands(torch, gen, M, K, N, bits):
    """fused_qlhs_matmul's dX-mode arguments as core/backend.fused_fqt_dx
    builds them under PSQ: g (M, K) = dY, the (N, K) = (d_in, d_out)
    weight codes read transposed, SR bits from prng.bits."""
    from repro_torch import prng
    from repro_torch.core import QuantizerSpec, quantize_ptq_det
    import repro_torch.core.backend as backend
    dev = gen.device
    g = torch.randn(M, K, generator=gen, device=dev) * 1e-3
    wq = quantize_ptq_det(torch.randn(N, K, generator=gen, device=dev)
                          / K ** 0.5)
    rbits = prng.bits(prng.PRNGKey(M + K + N), (M, K), dev)
    captured = []
    saved = backend.fused_qlhs_matmul
    backend.fused_qlhs_matmul = lambda *a, **kw: captured.append((a, kw))
    try:
        backend.fused_fqt_dx(g, None, QuantizerSpec("psq", bits), wq,
                             backend="kernel", rbits=rbits)
    finally:
        backend.fused_qlhs_matmul = saved
    return captured[0][0]


def dw_operands(torch, gen, K, M, N, bits_b):
    """fused_qboth_tn_matmul's arguments as core/backend.fused_fqt_dw
    builds them: X (K tokens, M = d_in) with its forward (scale, zero),
    dY (K, N = d_out), SR bits, a_vec."""
    from repro_torch import prng
    from repro_torch.core.backend import _ptq_range, dw_operands as ops
    dev = gen.device
    x = torch.randn(K, M, generator=gen, device=dev)
    g = torch.randn(K, N, generator=gen, device=dev) * 1e-3
    zx, sx = _ptq_range(x, 8)
    rbits = prng.bits(prng.PRNGKey(K + M + N), (K, N), dev)
    return ops(x, sx, zx, 8, g, rbits, bits_b)


def q8_operands(torch, gen, M, K, N):
    """q8_matmul's arguments as core/backend.qt_gemm_nt builds them under
    BHQ: 5-bit Householder-domain codes (M, K) against the transposed
    (N, K) weight codes, with the epilogue vectors of q8_gemm."""
    from repro_torch.core import epilogue_coeffs, quantize_ptq_det
    from repro_torch.core import affine_factors
    dev = gen.device
    a8 = torch.randint(-16, 16, (M, K), generator=gen, device=dev,
                       dtype=torch.int8)
    wq = quantize_ptq_det(torch.randn(N, K, generator=gen, device=dev)
                          / K ** 0.5)
    bt8 = wq.int8_codes.T
    ab, bb = affine_factors(wq.scale, wq.zero, 8)
    beta_a = 16.0 + torch.randn(M, generator=gen, device=dev)
    coeffs = epilogue_coeffs(a8, 1.0, beta_a, bt8, ab, bb)
    return (a8, bt8) + tuple(c.contiguous() for c in coeffs)


def train_shapes():
    """(M, K, N) of each training kernel at every GEMM of the statquant-tx
    step (512 tokens; d_in -> d_out of q/k/v/o, fc1, fc2, lm_head), at
    granite-3-2b's (K, N) with 2048 tokens, and ragged.  dX GEMMs are
    (tokens, d_out, d_in); dW GEMMs (tokens, d_in, d_out)."""
    st = [(512, 512), (512, 1024), (1024, 512), (512, 10240)]
    gr = GRANITE_KN
    rag = [(33, 67, 130), (1, 64, 49), (37, 130, 67)]
    dx = [(512, n, k) for k, n in st] + [(2048, n, k) for k, n in gr] + rag
    dw = [(512, k, n) for k, n in st] + [(2048, k, n) for k, n in gr] + rag
    return dx, dw


def train_kernel_vs_plain(torch, report) -> dict:
    """The three training kernels against their plain versions on the card
    at every shape of ``train_shapes``, within KERNEL_TOL (0 expected)."""
    from repro_torch.kernels import (fused_qboth_tn_matmul,
                                     fused_qboth_tn_matmul_plain,
                                     fused_qlhs_matmul,
                                     fused_qlhs_matmul_plain, q8_matmul,
                                     q8_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(4321)
    dx, dw = train_shapes()
    rows = []
    worst = {"fused_qlhs_matmul_dx": 0.0, "q8_matmul": 0.0,
             "fused_qboth_tn_matmul": 0.0}

    def hold(name, shape, got, ref):
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        rows.append(dict(kernel=name, shape=list(shape), max_abs_err=err,
                         max_abs_ref=scale))
        log(f"[kernel] {name} {tuple(shape)} max|d|={err:.3g} "
            f"max|ref|={scale:.4g}")
        check(bool(torch.isfinite(got).all()), f"{name} {shape}: non-finite")
        check(err <= KERNEL_TOL * scale,
              f"{name} {shape}: max|d| {err} > {KERNEL_TOL} * {scale}")
        worst[name] = max(worst[name], err)

    for i, (M, K, N) in enumerate(dx):
        bits = 8 if i % 3 else 4
        ops = dx_operands(torch, gen, M, K, N, bits)
        hold("fused_qlhs_matmul_dx", (M, K, N),
             fused_qlhs_matmul(*ops, bits=bits, trans_b=True),
             fused_qlhs_matmul_plain(*ops, bits=bits, trans_b=True))
        ops = q8_operands(torch, gen, M, K, N)
        hold("q8_matmul", (M, K, N), q8_matmul(*ops), q8_matmul_plain(*ops))
    for i, (K, M, N) in enumerate(dw):
        bits_b = 8 if i % 3 else 5
        ops = dw_operands(torch, gen, K, M, N, bits_b)
        hold("fused_qboth_tn_matmul", (K, M, N),
             fused_qboth_tn_matmul(*ops, bits_a=8, bits_b=bits_b),
             fused_qboth_tn_matmul_plain(*ops, bits_a=8, bits_b=bits_b))
    report["train_kernel_vs_plain"] = rows
    return worst


# ---------------------------------------------------------------------------
# the main path: serving
# ---------------------------------------------------------------------------

def _kernel_wrappers():
    from repro_torch import kernels
    return (kernels.fused_qlhs_matmul, kernels.kv_dequant_rows,
            kernels.q8_matmul, kernels.fused_qboth_tn_matmul)


def _reset_counts():
    """Every kernel's launch count to 0."""
    for fn in _kernel_wrappers():
        fn.launches = 0
    _kernel_wrappers()[0].launches_dx = 0


def _read_counts():
    """Launches by kernel (and mode) since the last reset."""
    qlhs, kv, q8, qboth = _kernel_wrappers()
    return {"fused_qlhs_matmul": qlhs.launches - qlhs.launches_dx,
            "fused_qlhs_matmul_dx": qlhs.launches_dx,
            "kv_dequant_rows": kv.launches, "q8_matmul": q8.launches,
            "fused_qboth_tn_matmul": qboth.launches}


def _check_counts(counts, want, tag):
    """The path's kernels launched exactly as often as it implies; the
    others not at all."""
    for name, n in counts.items():
        w = want.get(name, 0)
        if w:
            check(n > 0, f"{tag}: {name} never launched on the main path")
        check(n == w, f"{tag}: {name} launched {n} times, the path implies "
                      f"{w}")


def _prefill_logits(torch, model, params, prompt, backend):
    """Prefill logits of one prompt, padded as the engine pads it (token 0
    up to the power-of-two bucket), under ``QuantPolicy.qat`` on
    ``backend``, or unquantized for ``backend="exact"``."""
    from repro_torch.core import QuantPolicy
    policy = (QuantPolicy.exact() if backend == "exact"
              else QuantPolicy.qat(backend=backend))
    lb = 1 << (len(prompt) - 1).bit_length()
    toks = torch.zeros((1, lb), dtype=torch.int64, device="cuda")
    toks[0, :len(prompt)] = torch.as_tensor(prompt, device="cuda")
    last = torch.tensor([len(prompt) - 1], device="cuda")
    logits, _ = model.prefill(params, {"tokens": toks}, policy, max_seq=lb,
                              last_pos=last)
    return logits


def _gemms_per_forward(cfg) -> int:
    """Quantized GEMMs in one forward: q, k, v, o and the MLP's two
    (gelu, relu2) or three (swiglu) projections per layer, and lm_head."""
    return cfg.n_layers * (4 + (3 if cfg.act == "swiglu" else 2)) + 1


def _prefill_gemms(torch, model, params, prompt):
    """Every quantized GEMM of one prefill through the kernels, as
    (path, x, w, y) in call order."""
    import repro_torch.layers.common as common
    import repro_torch.layers.embeddings as embeddings
    from repro_torch.core import fqt_matmul
    calls = []

    def spy(x, w, key, policy, path=""):
        y = fqt_matmul(x, w, key, policy, path=path)
        calls.append((path, x, w, y))
        return y

    saved = common.fqt_matmul, embeddings.fqt_matmul
    common.fqt_matmul = embeddings.fqt_matmul = spy
    try:
        logits = _prefill_logits(torch, model, params, prompt, "kernel")
    finally:
        common.fqt_matmul, embeddings.fqt_matmul = saved
    return logits, calls


def _full_width_vs_simulate(torch, cfg, params, prompt, tag) -> dict:
    """Kernel vs simulate at full width on one prompt's prefill.

    Checked: each quantized GEMM of the path,
    re-run on ``simulate`` from the very input the kernel path gave it,
    within rtol 1e-3 / atol 5e-3.  Measured: the prefill logits of the two
    backends, each driven end to end, beside the quantizers' own effect on
    them (``simulate`` vs ``exact``).  Once a float32 round-off difference
    moves one activation code across a rounding boundary, the per-tensor
    ``Q_f`` of every later GEMM sees another input; the JAX package's own
    backends part the same way at this width (tests/test_torch_fullwidth.py)."""
    from repro_torch.core import QuantPolicy, fqt_matmul
    from repro_torch.models import build_model
    model = build_model(cfg)
    a, calls = _prefill_gemms(torch, model, params, prompt)
    n = _gemms_per_forward(cfg)
    check(len(calls) == n, f"{tag}: {len(calls)} quantized GEMMs in one "
                           f"prefill, the path implies {n}")
    sim = QuantPolicy.qat(backend="simulate")
    worst = 0.0
    for i, (path, x, w, y) in enumerate(calls):
        ref = fqt_matmul(x, w, None, sim, path=path)
        worst = max(worst, float((y - ref).abs().max()))
        check(within_tol(y, ref),
              f"{tag}: GEMM {i} ({path}, x {tuple(x.shape)}) kernel vs "
              f"simulate differ by {float((y - ref).abs().max())} beyond "
              f"rtol {RTOL}/atol {ATOL}")
    del calls
    b = _prefill_logits(torch, model, params, prompt, "simulate")
    e = _prefill_logits(torch, model, params, prompt, "exact")
    check(bool(torch.isfinite(a).all()), f"{tag}: non-finite logits")
    res = dict(gemms_max_abs_diff=worst,
               logits_max_abs_diff=float((a - b).abs().max()),
               logits_max_abs=float(b.abs().max()),
               same_argmax=bool((a.argmax(-1) == b.argmax(-1)).all()),
               simulate_vs_exact_max_abs_diff=float((b - e).abs().max()))
    log(f"[{tag}] kernel vs simulate, full width, {cfg.n_layers} layers, "
        f"prompt {len(prompt)}: all {n} GEMMs on shared "
        f"inputs max|d|={worst:.3g} (checked, rtol {RTOL}, atol {ATOL}); "
        f"prefill logits max|d|={res['logits_max_abs_diff']:.4g} "
        f"max|logit|={res['logits_max_abs']:.4g} same argmax="
        f"{res['same_argmax']} (measured; simulate vs exact "
        f"max|d|={res['simulate_vs_exact_max_abs_diff']:.4g})")
    return res


def _reduced_vs_simulate(torch, name, seed):
    """Kernel vs simulate prefill logits on the reduced config, random
    prompts from the seed, within rtol 1e-3 / atol 5e-3."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(name, smoke=True)
    model = build_model(cfg)
    params = model.init(seed, device="cuda")
    rng = np.random.RandomState(seed + 7)
    worst = 0.0
    for n in (9, 23):
        prompt = rng.randint(0, cfg.vocab_size, size=n).tolist()
        a = _prefill_logits(torch, model, params, prompt, "kernel")
        b = _prefill_logits(torch, model, params, prompt, "simulate")
        err = float((a - b).abs().max())
        worst = max(worst, err)
        log(f"[{name} reduced] prefill logits kernel vs simulate, prompt "
            f"{n}: max|d|={err:.3g} (checked, rtol {RTOL}, atol {ATOL})")
        check(within_tol(a, b), f"{name} reduced: kernel vs simulate logits "
                                f"differ by {err} beyond rtol {RTOL}/atol "
                                f"{ATOL}")
    return worst


def _vs_plain(torch, cfg, params, prompts, tag):
    """The serving path through the kernels against the same path with each
    kernel wrapper replaced by its plain PyTorch version, on the card: same
    device, same ops around the kernels, so the tokens and the prefill
    logits must agree to the kernels' own tolerance (bit for bit here)."""
    import repro_torch.core.backend as backend
    import repro_torch.core.kv_cache as kv_cache
    from repro_torch.core import QuantPolicy
    from repro_torch.kernels import (fused_qlhs_matmul_plain,
                                     kv_dequant_rows_plain)
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    model = build_model(cfg)

    def run():
        eng = ServeEngine(cfg, params, policy=QuantPolicy.qat(
            backend="kernel"), slots=2, max_seq=256, kv_quant=True,
            device="cuda")
        for p in prompts:
            eng.submit(p, max_new=4)
        done = eng.run()
        logits = [_prefill_logits(torch, model, params, p, "kernel")
                  for p in prompts]
        return [done[r].tokens for r in sorted(done)], logits

    tok_k, log_k = run()
    saved = backend.fused_qlhs_matmul, kv_cache.kv_dequant_rows
    backend.fused_qlhs_matmul = fused_qlhs_matmul_plain
    kv_cache.kv_dequant_rows = kv_dequant_rows_plain
    try:
        tok_p, log_p = run()
    finally:
        backend.fused_qlhs_matmul, kv_cache.kv_dequant_rows = saved
    err = max(float((a - b).abs().max()) for a, b in zip(log_k, log_p))
    scale = max(float(b.abs().max()) for b in log_p)
    log(f"[{tag}] kernels vs plain versions through the whole serving path: "
        f"tokens equal={tok_k == tok_p}, prefill logits max|d|={err:.3g}")
    check(tok_k == tok_p, f"{tag}: tokens through the kernels differ from "
                          f"the plain path: {tok_k} vs {tok_p}")
    check(err <= KERNEL_TOL * scale, f"{tag}: logits through the kernels "
                                     f"differ from the plain path by {err}")
    return err


def _profile_decode(torch, eng):
    """One full-batch granite decode step, profiled by ``_profile``."""
    B = eng.slots
    cache = eng.model.init_cache_quant(eng.cfg, B, eng.max_seq, device="cuda")
    tok = torch.ones((B, 1), dtype=torch.int64, device="cuda")
    pos = torch.full((B,), eng.max_seq // 2, dtype=torch.int64, device="cuda")
    step = lambda: eng.model.decode(eng.params, cache, {"tokens": tok},  # noqa: E731
                                    eng.policy, positions=pos, kv_quant=True)
    return _profile(torch, step, f"one decode step ({B} slots)")


def _profile(torch, step, label):
    """``step``'s wall time (median of 5 runs without the profiler), and
    from one profiled run (torch.profiler) the device's busy time (the sum
    over kernels and copies on the card), the idle share, and the device
    time by kernel and by the PyTorch op that launched it."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels, ops = [], []
    for e in prof.key_averages():
        dev_ms = e.self_device_time_total / 1e3
        if dev_ms <= 0 or e.is_user_annotation:
            continue
        on_card = e.device_type == DeviceType.CUDA
        (kernels if on_card else ops).append((dev_ms, e.count, e.key))
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    busy = sum(r[0] for r in kernels)
    log(f"[profile] {label}: wall {wall:.2f} ms (median of 5, no profiler), "
        f"device busy {busy:.2f} ms, idle share {1 - busy / wall:.3f}, "
        f"{sum(r[1] for r in kernels)} device kernels")
    for ms, n, name in ops[:12]:
        log(f"[profile]   op     {ms:9.3f} ms {n:6d}x {name[:80]}")
    for ms, n, name in kernels[:10]:
        log(f"[profile]   kernel {ms:9.3f} ms {n:6d}x {name[:80]}")
    return dict(wall_ms=wall, walls_ms=walls, device_busy_ms=busy,
                device_kernels=sum(r[1] for r in kernels),
                ops=[dict(ms=ms, count=n, name=name) for ms, n, name
                     in ops[:25]],
                kernels=[dict(ms=ms, count=n, name=name) for ms, n, name
                         in kernels[:25]])


def serve_granite(torch, seed, report):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    cfg = get_config("granite-3-2b")
    t0 = time.perf_counter()
    params = build_model(cfg).init(seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(t.shape)) for t in _leaves(params))
    log(f"[granite] {cfg.name} full width: {cfg.n_layers} layers, "
        f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f}s")
    eng = ServeEngine(cfg, params, policy=QuantPolicy.qat(backend="kernel"),
                      slots=8, max_seq=256, kv_quant=True, seed=seed,
                      device="cuda")
    # warm-up (kernel libraries load, allocator, cuBLAS), off the counts
    eng.submit([1] * 16, max_new=2)
    eng.run()
    eng.step_times.clear()

    rng = np.random.RandomState(seed)
    prompts = []
    for i in range(16):
        prompt = rng.randint(0, cfg.vocab_size,
                             size=int(rng.randint(16, 129))).tolist()
        prompts.append(prompt)
        sampled = i % 5 == 3
        eng.submit(prompt, max_new=32, temperature=0.8 if sampled else 0.0,
                   top_k=40 if sampled else 0)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()

    steps = len(eng.step_times)
    n_tok = sum(len(c.tokens) for c in done.values())
    dts = np.asarray([dt for dt, n in eng.step_times])
    per_fwd = _gemms_per_forward(cfg)
    want = {"fused_qlhs_matmul": per_fwd * (len(prompts) + steps),
            "kv_dequant_rows": 2 * cfg.n_layers * steps}
    res = dict(requests=len(done), tokens=n_tok, wall_s=wall,
               tok_per_s=n_tok / wall, decode_steps=steps,
               p50_step_ms=float(np.percentile(dts, 50)) * 1e3,
               p95_step_ms=float(np.percentile(dts, 95)) * 1e3,
               launches=counts, expected_launches=want,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[granite] served {len(done)} requests, {n_tok} tokens in "
        f"{wall:.2f}s ({res['tok_per_s']:.1f} tok/s), {steps} decode steps, "
        f"p50 {res['p50_step_ms']:.2f} ms p95 {res['p95_step_ms']:.2f} ms, "
        f"peak {res['peak_mem_gb']:.1f} GB")
    log(f"[granite] launches {counts} expected {want}")
    _check_counts(counts, want, "granite")
    check(len(done) == 16, f"granite: {len(done)} of 16 requests completed")
    check(all(len(c.tokens) == 32 for c in done.values()),
          "granite: a request ended before max_new")
    check(all(0 <= t < cfg.vocab_size for c in done.values()
              for t in c.tokens), "granite: token outside the vocabulary")
    res["max_abs_diff_vs_plain_path"] = _vs_plain(
        torch, cfg, params, prompts[:2], "granite")
    res["vs_simulate"] = _full_width_vs_simulate(
        torch, cfg, params, prompts[0], "granite")
    res["reduced_max_abs_diff_vs_simulate"] = _reduced_vs_simulate(
        torch, cfg.name, seed)
    report["granite"] = res
    return res, eng


def serve_statquant(torch, seed, report) -> None:
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    cfg = get_config("statquant-tx")
    params = build_model(cfg).init(seed, device="cuda")
    eng = ServeEngine(cfg, params, policy=QuantPolicy.qat(backend="kernel"),
                      slots=4, max_seq=64, kv_quant=True, seed=seed,
                      device="cuda")
    rng = np.random.RandomState(seed + 1)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(rng.randint(4, 33)))
               .tolist() for _ in range(4)]
    for p in prompts:
        eng.submit(p, max_new=8)
    _reset_counts()
    done = eng.run()
    counts = _read_counts()
    log(f"[statquant] {cfg.name} full width: {len(done)} requests, "
        f"launches {counts}")
    check(len(done) == 4 and all(len(c.tokens) == 8 for c in done.values()),
          "statquant-tx: requests did not complete")
    steps = len(eng.step_times)
    want = {"fused_qlhs_matmul": _gemms_per_forward(cfg) * (len(prompts)
                                                           + steps),
            "kv_dequant_rows": 2 * cfg.n_layers * steps}
    _check_counts(counts, want, "statquant-tx")
    report["statquant"] = dict(
        requests=len(done), launches=counts,
        max_abs_diff_vs_plain_path=_vs_plain(torch, cfg, params, prompts[:2],
                                             "statquant"),
        vs_simulate=_full_width_vs_simulate(torch, cfg, params, prompts[0],
                                            "statquant"),
        reduced_max_abs_diff_vs_simulate=_reduced_vs_simulate(
            torch, cfg.name, seed))


# ---------------------------------------------------------------------------
# the main path: training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 5


def _train_policy(quant, bits, backend):
    """The launcher's FQT policy (``launch/train.py``: bhq_block=256)."""
    from repro_torch.core import QuantPolicy
    return QuantPolicy.fqt(quant, bits, bhq_block=256, backend=backend)


def _train_engine(cfg, quant, bits, backend, seed):
    """The engine ``python -m repro_torch.launch.train --full --quant
    QUANT --grad-bits BITS --backend BACKEND`` builds (batch 8, seq 64)."""
    from repro_torch.engine import Engine
    return Engine(cfg, _train_policy(quant, bits, backend),
                  steps=TRAIN_STEPS, batch_size=8, seq_len=64, seed=seed,
                  device="cuda", log_every=1, log_fn=log)


def _replay(torch, eng, steps=TRAIN_STEPS):
    """``steps`` steps of the engine's own step from its initial state:
    [(loss, grad_norm)] per step."""
    state, out = eng.init_state(), []
    for s in range(steps):
        state, m = eng.step_fn(state, eng.loader.get(s))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _replay_plain(torch, eng):
    """``_replay`` with every training kernel's wrapper swapped for its
    plain version (on the card): same device, same ops around them."""
    import repro_torch.core.backend as backend
    from repro_torch.kernels import (fused_qboth_tn_matmul_plain,
                                     fused_qlhs_matmul_plain,
                                     q8_matmul_plain)
    saved = (backend.fused_qlhs_matmul, backend.fused_qboth_tn_matmul,
             backend.q8_matmul)
    backend.fused_qlhs_matmul = fused_qlhs_matmul_plain
    backend.fused_qboth_tn_matmul = fused_qboth_tn_matmul_plain
    backend.q8_matmul = q8_matmul_plain
    try:
        return _replay(torch, eng)
    finally:
        (backend.fused_qlhs_matmul, backend.fused_qboth_tn_matmul,
         backend.q8_matmul) = saved


def _step_gemms(torch, eng):
    """Every quantized GEMM of one training step, as (path, x, w, key, g):
    its inputs and the gradient that reached its output."""
    import repro_torch.layers.common as common
    import repro_torch.layers.embeddings as embeddings
    from repro_torch.core import fqt_matmul
    calls = []

    def spy(x, w, key, policy, path=""):
        y = fqt_matmul(x, w, key, policy, path=path)
        rec = [path, x.detach().clone(), w.detach().clone(), key, None]
        calls.append(rec)
        y.register_hook(lambda g: rec.__setitem__(4, g.detach().clone()))
        return y

    saved = common.fqt_matmul, embeddings.fqt_matmul
    common.fqt_matmul = embeddings.fqt_matmul = spy
    try:
        eng.step_fn(eng.init_state(), eng.loader.get(0))
    finally:
        common.fqt_matmul, embeddings.fqt_matmul = saved
    return calls


def _backward_vs_simulate(torch, eng, quant, bits, tag) -> dict:
    """Each backward GEMM of one step re-run from its (x, w, key, g) on the
    kernel backend and on ``simulate``: dX and dW within rtol 1e-3 / atol
    5e-3 (the repo's cross-backend tolerance), and within rtol 1e-3 plus
    an atol of ``GRAD_ATOL_FRAC`` times the reference's max|.| — the
    gradients lie far below 5e-3, so only this second check can catch a
    wrong backward GEMM.  ``margin`` is the largest share of that scaled
    tolerance any entry used (at most 1)."""
    from repro_torch.core import fqt_matmul
    calls = _step_gemms(torch, eng)
    n = _gemms_per_forward(eng.cfg)
    check(len(calls) == n, f"{tag}: {len(calls)} quantized GEMMs in one "
                           f"step, the path implies {n}")
    worst = {k: 0.0 for k in ("dx", "dw", "dx_ref", "dw_ref", "dx_margin",
                              "dw_margin")}
    for path, x, w, key, g in calls:
        check(g is not None, f"{tag}: no gradient reached {path}")
        grads = []
        for backend in ("kernel", "simulate"):
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            y = fqt_matmul(xr, wr, key, _train_policy(quant, bits, backend),
                           path=path)
            grads.append(torch.autograd.grad(y, (xr, wr), g))
        for name, got, ref in zip(("dx", "dw"), grads[0], grads[1]):
            d = (got - ref).abs()
            peak = float(ref.abs().max())
            tol = RTOL * ref.abs() + GRAD_ATOL_FRAC * peak
            margin = (float((d / tol).max()) if peak > 0 else
                      0.0 if float(d.max()) == 0 else float("inf"))
            worst[name] = max(worst[name], float(d.max()))
            worst[name + "_ref"] = max(worst[name + "_ref"], peak)
            worst[name + "_margin"] = max(worst[name + "_margin"], margin)
            check(within_tol(got, ref),
                  f"{tag}: {path} x {tuple(x.shape)}: kernel vs simulate "
                  f"{name} differ by {float(d.max())} beyond rtol "
                  f"{RTOL}/atol {ATOL}")
            check(margin <= 1.0,
                  f"{tag}: {path} x {tuple(x.shape)}: kernel vs simulate "
                  f"{name} differ by {float(d.max())} beyond rtol {RTOL} "
                  f"+ {GRAD_ATOL_FRAC} * max|{name}| ({peak:.3g}); share "
                  f"of that tolerance used {margin:.3g}")
    log(f"[{tag}] every backward GEMM of one step ({n}) re-run from its "
        f"(x, w, key, g): kernel vs simulate max|d| dX {worst['dx']:.3g} "
        f"(max|dX| {worst['dx_ref']:.3g}), dW {worst['dw']:.3g} (max|dW| "
        f"{worst['dw_ref']:.3g}) (checked, rtol {RTOL}, atol {ATOL}); "
        f"share of rtol {RTOL} + {GRAD_ATOL_FRAC}*max|ref| used, worst "
        f"GEMM: dX {worst['dx_margin']:.3g}, dW {worst['dw_margin']:.3g} "
        f"(checked, <= 1)")
    return worst


def train_statquant(torch, seed, report) -> dict:
    """statquant-tx at full width and depth trains TRAIN_STEPS steps under
    fqt(psq, 8) and fqt(bhq, 5) on the kernel backend through the engine,
    with the checks of the module docstring."""
    import numpy as np
    from repro_torch.configs import get_config
    cfg = get_config("statquant-tx")
    n = _gemms_per_forward(cfg)
    total = {}
    res = {}
    for quant, bits in (("psq", 8), ("bhq", 5)):
        tag = f"train {quant}{bits}"
        eng = _train_engine(cfg, quant, bits, "kernel", seed)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        want = {"fused_qlhs_matmul": n * TRAIN_STEPS,
                "fused_qboth_tn_matmul": n * TRAIN_STEPS,
                ("fused_qlhs_matmul_dx" if quant == "psq" else "q8_matmul"):
                    n * TRAIN_STEPS}
        log(f"[{tag}] {cfg.name} full width: {cfg.n_layers} layers, "
            f"{TRAIN_STEPS} steps of 8 x 64 tokens in {wall:.2f}s, "
            f"launches {counts} expected {want}")
        _check_counts(counts, want, tag)
        for name, c in counts.items():
            total[name] = total.get(name, 0) + c
        losses = [loss for _, loss in history]
        check(len(losses) == TRAIN_STEPS and all(
            np.isfinite(v) for v in losses), f"{tag}: losses {losses}")
        kern = _replay(torch, eng)
        check([k[0] for k in kern] == losses,
              f"{tag}: the engine's run and its replay differ: {losses} vs "
              f"{[k[0] for k in kern]}")
        plain = _replay_plain(torch, eng)
        err = max(max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(k, p))
                  for k, p in zip(kern, plain))
        log(f"[{tag}] kernels vs plain versions, {TRAIN_STEPS} steps: "
            f"(loss, grad norm) {kern} vs {plain}, max rel |d| {err:.3g}")
        check(err <= KERNEL_TOL, f"{tag}: the steps through the kernels "
                                 f"differ from the plain versions by {err}")
        gemms = _backward_vs_simulate(torch, eng, quant, bits, tag)
        sim = _replay(torch, _train_engine(cfg, quant, bits, "simulate",
                                           seed))
        log(f"[{tag}] loss trajectory kernel {[k[0] for k in kern]} vs "
            f"simulate {[v[0] for v in sim]} (measured, not held)")
        res[quant] = dict(
            wall_s=wall, step_s=wall / TRAIN_STEPS, launches=counts,
            expected_launches=want, kernel=kern, plain=plain,
            max_rel_diff_vs_plain=err, simulate=sim,
            backward_gemms_vs_simulate=gemms,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        res[quant]["profile_step"] = _profile(
            torch, _one_step(eng), f"one training step, {quant}{bits}")
    res["launches"] = total
    report["train"] = res
    return res


def _one_step(eng):
    """A closure running one step of ``eng`` from a fresh state."""
    batch = eng.loader.get(0)
    state0 = eng.init_state()
    return lambda: eng.step_fn(state0, batch)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# timings
# ---------------------------------------------------------------------------

def _time_ms(torch, fn, flush, iters: int) -> float:
    """Mean device time of one call of ``fn``: CUDA events around each of
    ``iters`` calls, each after an L2 flush (the serving path meets every
    weight cold: 280 other projections stream through between two uses).
    All calls are queued behind a spin kernel, so the events time the
    device's work and not the host's dispatch of the call; the spin is
    sized from the host's time to queue a call (measured after warm-up),
    and the check below holds the host to having queued them all before
    the spin ended."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    torch.cuda.synchronize()
    # at least 1e6 spin cycles per ms of host time (the H100's SM clock is
    # above 1 GHz), twice over
    cycles = max(SPIN_CYCLES_PER_CALL, int(2e6 * host_ms)) * iters
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
          for _ in range(iters + 1)]
    ev[0][0].record()
    torch.cuda._sleep(cycles)
    ev[0][1].record()
    t0 = time.perf_counter()
    for a, b in ev[1:]:
        flush.zero_()
        a.record()
        fn()
        b.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = ev[0][0].elapsed_time(ev[0][1])
    check(queued_ms < spin_ms, f"timing: the host took {queued_ms:.2f} ms to "
                               f"queue {iters} calls, the spin only {spin_ms:.2f} ms")
    return sum(a.elapsed_time(b) for a, b in ev[1:]) / iters


def _bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(torch, report) -> dict:
    from repro_torch.kernels import (fused_qlhs_matmul,
                                     fused_qlhs_matmul_plain,
                                     kv_dequant_rows, kv_dequant_rows_plain)
    gen = torch.Generator(device="cuda").manual_seed(99)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    for M in (8, 128):
        for (K, N) in GRANITE_KN:
            ops = qlhs_operands(torch, gen, M, K, N)
            x, w8 = ops[0], ops[4]
            ms = _time_ms(torch, lambda: fused_qlhs_matmul(*ops, bits=8),
                          flush, 20)
            plain = _time_ms(
                torch, lambda: fused_qlhs_matmul_plain(*ops, bits=8), flush, 5)
            # cuBLASLt's int8 GEMM needs M > 16: the yardstick pads to 32
            a8 = torch.zeros((max(M, 32), K), dtype=torch.int8, device="cuda")
            lib = _time_ms(torch, lambda: torch._int_mm(a8, w8), flush, 20)
            nbytes = M * K * 4 + K * N + M * N * 4 + M * 8 + N * 4 + 8
            bound, by = _bound(nbytes, 2.0 * M * N * K, INT8_OPS_PER_S)
            rows.append(dict(kernel="fused_qlhs_matmul", shape=[M, K, N],
                             ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=bound, bound_by=by))
            log(f"[time] fused_qlhs_matmul {(M, K, N)}: kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, _int_mm(M={max(M, 32)}) {lib:.4f} "
                f"ms, bound {bound:.4f} ms ({by})")
    for (M, N) in [(2048, 512), (33, 130)]:
        c, s, z = kv_operands(torch, gen, M, N)
        ms = _time_ms(torch, lambda: kv_dequant_rows(c, s, z), flush, 50)
        plain = _time_ms(torch, lambda: kv_dequant_rows_plain(c, s, z),
                         flush, 50)
        bound, by = _bound(M * N + 8 * M + 4 * M * N, M * N, FP32_OPS_PER_S)
        rows.append(dict(kernel="kv_dequant_rows", shape=[M, N], ms=ms,
                         plain_ms=plain, library_ms=None, bound_ms=bound,
                         bound_by=by))
        log(f"[time] kv_dequant_rows {(M, N)}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bound:.5f} ms ({by})")
    rows += time_train_kernels(torch, gen, flush)
    report["timings"] = rows

    def pick(kernel, shape):
        r = next(r for r in rows
                 if r["kernel"] == kernel and r["shape"] == shape)
        return {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}
    # the line's numbers: the decode-step shapes for the serving kernels
    # (MLP up-projection, and one layer's K or V read at 8 slots x 256
    # positions), the lm_head GEMMs (the largest) for the training kernels
    return {"fused_qlhs_matmul": pick("fused_qlhs_matmul", [8, 2048, 8192]),
            "kv_dequant_rows": pick("kv_dequant_rows", [2048, 512]),
            "fused_qlhs_matmul_dx": pick("fused_qlhs_matmul_dx",
                                         [512, 10240, 512]),
            "q8_matmul": pick("q8_matmul", [512, 10240, 512]),
            "fused_qboth_tn_matmul": pick("fused_qboth_tn_matmul",
                                          [512, 512, 10240])}


def time_train_kernels(torch, gen, flush) -> list:
    """Each training kernel at its statquant-tx path shapes (512 tokens),
    beside its plain version, its bound, and ``torch._int_mm`` as the
    yardstick: the bare int8 product of codes of the same shapes, laid
    out as the path stores them (the dX GEMMs' B is the transpose of the
    (d_in, d_out) weight codes, the dW GEMM's A the transpose of the
    (tokens, d_in) activations), without the kernels' quantize, SR bits
    and epilogue."""
    from repro_torch.kernels import (fused_qboth_tn_matmul,
                                     fused_qboth_tn_matmul_plain,
                                     fused_qlhs_matmul,
                                     fused_qlhs_matmul_plain, q8_matmul,
                                     q8_matmul_plain)
    dx, dw = train_shapes()
    rows = []

    def codes(*shape):
        return torch.zeros(shape, dtype=torch.int8, device="cuda")

    def one(name, shape, fn, plain, lib_args, mnk, nbytes):
        M, N, K = mnk
        ms = _time_ms(torch, fn, flush, 20)
        plain_ms = _time_ms(torch, plain, flush, 5)
        lib = _time_ms(torch, lambda: torch._int_mm(*lib_args), flush, 20)
        bound, by = _bound(nbytes, 2.0 * M * N * K, INT8_OPS_PER_S)
        rows.append(dict(kernel=name, shape=list(shape), ms=ms,
                         plain_ms=plain_ms, library_ms=lib, bound_ms=bound,
                         bound_by=by))
        log(f"[time] {name} {tuple(shape)}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, _int_mm {lib:.4f} ms, bound {bound:.4f} ms "
            f"({by})")

    for (M, K, N) in dx[:4]:
        lib_args = (codes(M, K), codes(N, K).T)
        ops = dx_operands(torch, gen, M, K, N, 8)
        # f32 dY and int64 SR bits in (the kernel reads the 8-byte entries
        # as they are), (N, K) codes, (M,1) scale/zero, (N,) u, f32 dX out
        one("fused_qlhs_matmul_dx", (M, K, N),
            lambda: fused_qlhs_matmul(*ops, bits=8, trans_b=True),
            lambda: fused_qlhs_matmul_plain(*ops, bits=8, trans_b=True),
            lib_args, (M, N, K),
            12 * M * K + K * N + 8 * M + 4 * N + 4 * M * N + 8)
        ops = q8_operands(torch, gen, M, K, N)
        one("q8_matmul", (M, K, N), lambda: q8_matmul(*ops),
            lambda: q8_matmul_plain(*ops), lib_args, (M, N, K),
            M * K + K * N + 12 * (M + N) + 4 * M * N)
    for (K, M, N) in dw[:4]:
        ops = dw_operands(torch, gen, K, M, N, 8)
        # f32 X and dY, int64 SR bits (read as they are), 4 scalars, (M,)
        # a_vec in; f32 dW out
        one("fused_qboth_tn_matmul", (K, M, N),
            lambda: fused_qboth_tn_matmul(*ops, bits_a=8, bits_b=8),
            lambda: fused_qboth_tn_matmul_plain(*ops, bits_a=8, bits_b=8),
            (codes(K, M).T, codes(K, N)), (M, N, K),
            4 * K * M + 12 * K * N + 16 + 4 * M + 4 * M * N)
    return rows


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        sys.exit(1)

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
     explicitly, so 0 is expected), and ``kv_dequant_rows`` bit for bit;
     ``kv_gather_pages`` at granite-3-2b's paged shapes (8 lanes, D = 512,
     P = 8 and 16, nb*P = 256) and ragged ones (P = 3, D = 40; tables that
     repeat pages and point at page 0; zero scales), and
     ``quantize_sr_rows``/``quantize_sr_tensor`` at every backward shape
     of the statquant-tx step, at granite's (2048, N) and ragged, with SR
     bits spanning all 32 bits, all bit for bit; ``q8_matmul`` also at the
     forward and dW (``tn``) shapes of the unfused step.
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
  5. Paged serving, granite-3-2b at full width and depth:
     ``ServeEngine(paged=True, page_size=16)`` with the same 8 slots,
     ``max_seq``, warm-up and 16 requests as 4, whole-prompt prefill, spec
     decode off.  Its tokens must equal the dense engine's (a one-token
     paged step is the dense step, arithmetically); ``kv_gather_pages``
     launches exactly 2 x 40 times per paged forward and
     ``kv_dequant_rows`` never; a replay through ``kv_gather_pages``'s
     plain version gives the same tokens and logits.  Then the paged
     features at full width: requests sharing a 64-token system prompt and
     extensions of earlier prompts (copy-on-write), ``prefill_chunk=32``, a
     pool small enough to preempt, ``spec_decode=True, spec_k=3``;
     checked: the invariants after every step, prefix hits, copies and
     preemptions, the launch count, identity with its plain-gather replay;
     printed: token agreement with the dense engine (chunked prefill and
     the (k+1)-token verify change the per-tensor ``Q_f`` batch).  And at
     the reduced config under ``QuantPolicy(enabled=False,
     backend="kernel")``: paged tokens equal the dense engine's with
     whole-prompt and chunked prefill, prefix reuse, preemption and spec
     decode.
  6. A short statquant-tx full-width serving run (layernorm, gelu, qkv
     bias), with the checks of 4.
  7. Trains statquant-tx at full width and depth (6 layers, d=512,
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
     Then the unfused path: 5 steps each under ``fqt(psq, 8)`` and
     ``fqt(ptq, 8)`` with ``fused=False`` (per step: PSQ 37
     ``quantize_sr_rows``, 37 ``quantize_sr_tensor``, 111 ``q8_matmul``;
     PTQ 74 ``quantize_sr_tensor``; the fused kernels never), the same
     checks against the plain versions and ``simulate``, and every
     backward GEMM also against the fused kernels from the same (x, w,
     key, dY).
  8. Times each kernel at its path shapes (the serving kernels at the
     decode and prefill shapes, the training kernels at the statquant-tx
     step's) with CUDA events after warm-up, an L2 flush before every
     launch and every launch queued behind a spin kernel (device time,
     not host dispatch), beside its plain version, ``torch._int_mm`` on
     the same int8 shapes as the library yardstick (the bare int8
     product, without the quantize and epilogue), and its bound (bytes
     over 3.35 TB/s or int8 operations over 1,979 TOP/s, the H100 SXM
     data-sheet peaks).  Then profiles one granite decode step (dense and
     paged) and one training step under each policy (fused and unfused):
     wall time, device busy time and idle share, device time by op and by
     kernel.

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
    serve, granite_engine, workload = serve_granite(torch, args.seed, report)
    paged, paged_engine = serve_granite_paged(torch, args.seed, report,
                                              granite_engine, workload)
    paged_features(torch, args.seed, report, granite_engine.params)
    paged_reduced_exact(torch, args.seed, report)
    serve_statquant(torch, args.seed, report)
    train = train_statquant(torch, args.seed, report)
    unfused = train_unfused(torch, args.seed, report)
    timings = time_kernels(torch, report)
    serve["profile_decode_step"] = _profile_decode(torch, granite_engine)
    paged["profile_decode_step"] = _profile_paged_decode(torch, paged_engine)

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
              train["launches"]["q8_matmul"]
              + unfused["launches"]["q8_matmul"]),
        entry("fused_qboth_tn_matmul", "fused_qboth_tn_matmul",
              csrc + "fused_qboth_tn.cu", "src/repro/kernels/fused_fqt.py:215",
              train["launches"]["fused_qboth_tn_matmul"]),
        entry("kv_gather_pages", "kv_gather_pages", csrc + "kv_gather.cu",
              "src/repro/kernels/kv_gather.py:43",
              paged["launches"]["kv_gather_pages"]),
        entry("quantize_sr_rows", "quantize_sr_rows", csrc + "quantize_sr.cu",
              "src/repro/kernels/quantize_sr.py:34",
              unfused["launches"]["quantize_sr_rows"]),
        entry("quantize_sr_tensor", "quantize_sr_tensor",
              csrc + "quantize_sr.cu", "src/repro/kernels/quantize_sr.py:98",
              unfused["launches"]["quantize_sr_tensor"]),
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


def pool_operands(torch, gen, B, P, D, ragged=False):
    """kv_gather_pages's arguments as the paged engine holds them: a pool
    of ``1 + B * nb`` pages (nb * P = 256, or 5 blocks when ragged) of
    quantized random rows, page 0 the garbage page, and block tables that
    give each lane its own pages, point its tail blocks at page 0 and, when
    ragged, repeat a page and zero some scales."""
    from repro_torch.core import kv_fresh_code, quantize_kv_rows
    nb = 5 if ragged else 256 // P
    n_pages = 1 + B * nb
    x = torch.randn(n_pages, P, D, generator=gen, device=gen.device) * 3
    codes, scale, zero = quantize_kv_rows(x)
    codes[0], scale[0], zero[0] = kv_fresh_code(), 1.0, 0.0
    table = torch.arange(1, n_pages, device=gen.device,
                         dtype=torch.int32).reshape(B, nb)
    table[:, nb - nb // 4:] = 0                  # unallocated tail blocks
    table[0] = 0                                 # an idle lane
    if ragged:
        scale[0] = 0.0
        scale[3, 1] = 0.0
        table[1, 1] = table[1, 0]                # a repeated page
    return codes, scale, zero, table.contiguous()


def kernel_vs_plain(torch, report) -> dict:
    from repro_torch.kernels import (fused_qlhs_matmul,
                                     fused_qlhs_matmul_plain,
                                     kv_dequant_rows, kv_dequant_rows_plain,
                                     kv_gather_pages, kv_gather_pages_plain)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows, worst = [], {"fused_qlhs_matmul": 0.0, "kv_dequant_rows": 0.0,
                       "kv_gather_pages": 0.0}
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
    for (B, P, D, ragged) in [(8, 16, 512, False), (8, 8, 512, False),
                              (8, 3, 40, True), (3, 16, 512, True)]:
        ops = pool_operands(torch, gen, B, P, D, ragged)
        got = kv_gather_pages(*ops)
        ref = kv_gather_pages_plain(*ops)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        err = float((got - ref).abs().max())
        finite = bool(torch.isfinite(got).all())
        shape = [B, ops[3].shape[1] * P, D]
        rows.append(dict(kernel="kv_gather_pages", shape=shape, page_size=P,
                         max_abs_err=err, bit_identical=same))
        log(f"[kernel] kv_gather_pages (B, nb*P, D) = {tuple(shape)} P={P}"
            f"{' ragged' if ragged else ''} bit-identical={same} "
            f"finite={finite}")
        check(finite, f"kv_gather_pages {shape} P={P}: non-finite output")
        check(same, f"kv_gather_pages {shape} P={P} differs from plain by "
                    f"{err}")
        worst["kv_gather_pages"] = max(worst["kv_gather_pages"], err)
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
    from repro_torch.kernels import (quantize_sr_rows, quantize_sr_rows_plain,
                                     quantize_sr_tensor,
                                     quantize_sr_tensor_plain)
    gen = torch.Generator(device="cuda").manual_seed(4321)
    dx, dw = train_shapes()
    rows = []
    worst = {"fused_qlhs_matmul_dx": 0.0, "q8_matmul": 0.0,
             "fused_qboth_tn_matmul": 0.0, "quantize_sr_rows": 0.0,
             "quantize_sr_tensor": 0.0}

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
    # the unfused step's forward (M tokens, d_in, d_out; B row-major) and
    # dW (d_in, M tokens, d_out; A a transposed copy) GEMMs
    for (M, K, N) in unfused_q8_shapes():
        ops = q8_unfused_operands(torch, gen, M, K, N)
        hold("q8_matmul", (M, K, N), q8_matmul(*ops), q8_matmul_plain(*ops))
    for i, (M, N) in enumerate(sr_shapes()):
        bits = 8 if i % 3 else 4
        x, rb = sr_operands(torch, gen, M, N)
        for name, kern, plain in (
                ("quantize_sr_rows", quantize_sr_rows, quantize_sr_rows_plain),
                ("quantize_sr_tensor", quantize_sr_tensor,
                 quantize_sr_tensor_plain)):
            got, ref = kern(x, rb, bits), plain(x, rb, bits)
            torch.cuda.synchronize()
            same = all(g.shape == r.shape and torch.equal(g, r)
                       for g, r in zip(got, ref))
            err = max(float((g.float() - r.float()).abs().max())
                      for g, r in zip(got, ref))
            rows.append(dict(kernel=name, shape=[M, N], bits=bits,
                             max_abs_err=err, bit_identical=same))
            log(f"[kernel] {name} {(M, N)} bits={bits} codes, scale, zero "
                f"bit-identical={same}")
            check(same, f"{name} {(M, N)} bits={bits}: differs from plain "
                        f"by {err}")
            worst[name] = max(worst[name], err)
    report["train_kernel_vs_plain"] = rows
    return worst


def unfused_q8_shapes():
    """(M, K, N) of q8_matmul's forward and dW GEMMs at every statquant-tx
    GEMM (512 tokens) and ragged."""
    st = [(512, 512), (512, 1024), (1024, 512), (512, 10240)]
    fwd = [(512, k, n) for k, n in st]
    tn = [(k, 512, n) for k, n in st]
    return fwd + tn + [(33, 67, 130), (130, 33, 67)]


def q8_unfused_operands(torch, gen, M, K, N):
    """q8_matmul's arguments as core/backend.qt_gemm / qt_gemm_tn build them
    on the unfused path: 8-bit per-tensor codes (M, K) against row-major
    (K, N) codes, with the epilogue vectors of q8_gemm."""
    from repro_torch.core import affine_factors, epilogue_coeffs
    from repro_torch.core import quantize_ptq_det
    dev = gen.device
    aq = quantize_ptq_det(torch.randn(M, K, generator=gen, device=dev))
    bq = quantize_ptq_det(torch.randn(K, N, generator=gen, device=dev) * 1e-3)
    a8, b8 = aq.int8_codes, bq.int8_codes
    aa, ba = affine_factors(aq.scale, aq.zero, 8)
    ab, bb = affine_factors(bq.scale, bq.zero, 8)
    coeffs = epilogue_coeffs(a8, aa, ba, b8, ab, bb)
    return (a8, b8) + tuple(c.contiguous() for c in coeffs)


def sr_shapes():
    """(M, N) of every backward quantize of the statquant-tx step (512
    tokens x d_out), of granite-3-2b's with 2048 tokens, and ragged."""
    return ([(512, n) for n in (512, 1024, 10240)]
            + [(2048, n) for n in (2048, 512, 8192, 49408)]
            + [(33, 130), (1, 64), (16, 1), (3, 5)])


def sr_operands(torch, gen, M, N):
    """A gradient-like (M, N) (one wider row, one constant row) and int64
    SR bits over all 32 bits, the edge values first."""
    dev = gen.device
    x = torch.randn(M, N, generator=gen, device=dev) * 1e-3
    x[0, 0] = 5e-3
    if M > 2:
        x[2] = 0.25
    rb = torch.randint(0, 2 ** 32, (M, N), generator=gen, device=dev,
                       dtype=torch.int64)
    edge = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1,
                         2 ** 32 - 129, 2 ** 32 - 128, 2 ** 32 - 1],
                        dtype=torch.int64, device=dev)
    n = min(8, M * N)
    rb.view(-1)[:n] = edge[:n]
    return x, rb


# ---------------------------------------------------------------------------
# the main path: serving
# ---------------------------------------------------------------------------

def _kernel_wrappers():
    from repro_torch import kernels
    return (kernels.fused_qlhs_matmul, kernels.kv_dequant_rows,
            kernels.q8_matmul, kernels.fused_qboth_tn_matmul,
            kernels.kv_gather_pages, kernels.quantize_sr_rows,
            kernels.quantize_sr_tensor)


def _reset_counts():
    """Every kernel's launch count to 0."""
    for fn in _kernel_wrappers():
        fn.launches = 0
    _kernel_wrappers()[0].launches_dx = 0


def _read_counts():
    """Launches by kernel (and mode) since the last reset."""
    qlhs, kv, q8, qboth, gather, sr_rows, sr_tensor = _kernel_wrappers()
    return {"fused_qlhs_matmul": qlhs.launches - qlhs.launches_dx,
            "fused_qlhs_matmul_dx": qlhs.launches_dx,
            "kv_dequant_rows": kv.launches, "q8_matmul": q8.launches,
            "fused_qboth_tn_matmul": qboth.launches,
            "kv_gather_pages": gather.launches,
            "quantize_sr_rows": sr_rows.launches,
            "quantize_sr_tensor": sr_tensor.launches}


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

    workload = granite_workload(cfg, seed)
    prompts = [p for p, _ in workload]
    for prompt, kw in workload:
        eng.submit(prompt, **kw)
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
    res["tokens"] = {r: c.tokens for r, c in done.items()}
    res["max_abs_diff_vs_plain_path"] = _vs_plain(
        torch, cfg, params, prompts[:2], "granite")
    res["vs_simulate"] = _full_width_vs_simulate(
        torch, cfg, params, prompts[0], "granite")
    res["reduced_max_abs_diff_vs_simulate"] = _reduced_vs_simulate(
        torch, cfg.name, seed)
    report["granite"] = res
    return res, eng, workload


def granite_workload(cfg, seed):
    """The 16 granite requests: prompts of 16-128 tokens from the seed,
    ``max_new=32``, greedy but for every fifth (temperature 0.8, top-k
    40)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out = []
    for i in range(16):
        prompt = rng.randint(0, cfg.vocab_size,
                             size=int(rng.randint(16, 129))).tolist()
        sampled = i % 5 == 3
        out.append((prompt, dict(max_new=32,
                                 temperature=0.8 if sampled else 0.0,
                                 top_k=40 if sampled else 0)))
    return out


# ---------------------------------------------------------------------------
# the main path: paged serving
# ---------------------------------------------------------------------------

def _paged_engine(cfg, params, policy, seed, **kw):
    from repro_torch.serve import ServeEngine
    return ServeEngine(cfg, params, policy=policy, kv_quant=True, seed=seed,
                       paged=True, device="cuda", **kw)


def _plain_gather():
    """A context in which the paged attention gathers through
    ``kv_gather_pages``'s plain version (on the card)."""
    import contextlib
    import importlib
    from repro_torch.kernels import kv_gather_pages_plain
    # the module, not the function ``repro_torch.layers.attention``
    attention = importlib.import_module("repro_torch.layers.attention")

    @contextlib.contextmanager
    def ctx():
        saved = attention.kv_gather_pages
        attention.kv_gather_pages = kv_gather_pages_plain
        try:
            yield
        finally:
            attention.kv_gather_pages = saved
    return ctx()


def serve_granite_paged(torch, seed, report, dense_eng, workload):
    """granite-3-2b at full width through the paged engine, the dense
    phase's workload: tokens equal to the dense engine's, exact launch
    counts, and a plain-gather replay with the same tokens and logits."""
    import numpy as np
    from repro_torch.core import QuantPolicy
    cfg, params = dense_eng.cfg, dense_eng.params
    policy = QuantPolicy.qat(backend="kernel")

    def run():
        eng = _paged_engine(cfg, params, policy, seed, slots=8, max_seq=256,
                            page_size=16)
        eng.submit([1] * 16, max_new=2)             # the dense warm-up
        eng.run()
        eng.step_times.clear()
        for prompt, kw in workload:
            eng.submit(prompt, **kw)
        seen = _record_sampling_logits(eng)
        f0 = eng.paged_forwards
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = []       # per decode step: wall of step() minus its forward
        while eng.queued or eng.active_slots:
            n, ts = len(eng.step_times), time.perf_counter()
            eng.step()
            if len(eng.step_times) > n:
                host.append(time.perf_counter() - ts - eng.step_times[-1][0])
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return eng, done, _read_counts(), eng.paged_forwards - f0, wall, \
            host, seen

    eng, done, counts, fwd, wall, host, seen = run()
    tokens = {r: c.tokens for r, c in done.items()}
    per_fwd = _gemms_per_forward(cfg)
    want = {"fused_qlhs_matmul": per_fwd * (len(workload) + fwd),
            "kv_gather_pages": 2 * cfg.n_layers * fwd}
    n_tok = sum(len(t) for t in tokens.values())
    dts = np.asarray([dt for dt, _ in eng.step_times])
    res = dict(requests=len(done), tokens=n_tok, wall_s=wall,
               tok_per_s=n_tok / wall, paged_forwards=fwd,
               p50_step_ms=float(np.percentile(dts, 50)) * 1e3,
               p95_step_ms=float(np.percentile(dts, 95)) * 1e3,
               host_ms_per_step_outside_forward=dict(
                   median=float(np.median(host)) * 1e3,
                   mean=float(np.mean(host)) * 1e3),
               pool=eng.pool_stats(), launches=counts,
               expected_launches=want)
    log(f"[paged] granite full width, 8 slots, page 16: {len(done)} "
        f"requests, {n_tok} tokens in {wall:.2f}s ({res['tok_per_s']:.1f} "
        f"tok/s), {fwd} paged forwards, p50 {res['p50_step_ms']:.2f} ms "
        f"p95 {res['p95_step_ms']:.2f} ms, host outside the forward "
        f"{res['host_ms_per_step_outside_forward']['median']:.3f} ms/step "
        f"(median), peak pages {res['pool']['peak_pages_in_use']}/"
        f"{res['pool']['n_pages']}")
    log(f"[paged] launches {counts} expected {want}")
    _check_counts(counts, want, "paged granite")
    same = tokens == report["granite"]["tokens"]
    log(f"[paged] tokens equal the dense engine's: {same}")
    check(same, "paged granite: tokens differ from the dense engine's")
    with _plain_gather():
        _, done_p, _, fwd_p, _, _, seen_p = run()
    same_tok = {r: c.tokens for r, c in done_p.items()} == tokens
    same_log = seen.keys() == seen_p.keys() and all(
        torch.equal(seen[k], seen_p[k]) for k in seen)
    log(f"[paged] replay through kv_gather_pages_plain: tokens equal "
        f"{same_tok}, logits of all {len(seen)} decode samples "
        f"bit-identical {same_log}")
    check(same_tok and same_log and fwd_p == fwd,
          "paged granite: the plain-gather replay differs")
    res["plain_replay_identical"] = True
    report["paged"] = res
    return res, eng


def _feature_workload(cfg, seed):
    """Two rounds: (1) two prompts sharing a 64-token system prompt;
    (2) extensions of both (each adopts the other's registered prompt and
    copies its partial tail page on write) and two more system-prompt
    requests, one long, in a pool too small for all of them."""
    import numpy as np
    rng = np.random.RandomState(seed + 11)
    sys_p = rng.randint(0, cfg.vocab_size, 64).tolist()

    def ext(p, n):
        return p + rng.randint(0, cfg.vocab_size, n).tolist()
    r0, r1 = ext(sys_p, 10), ext(sys_p, 23)
    return [[r0, r1], [ext(r0, 7), ext(r1, 5), ext(sys_p, 37),
                       ext(sys_p, 90)]]


def paged_features(torch, seed, report, params):
    """Prefix reuse, copy-on-write, chunked prefill, preemption and spec
    decode at full width; see the module docstring."""
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.serve import ServeEngine
    cfg = get_config("granite-3-2b")
    policy = QuantPolicy.qat(backend="kernel")
    rounds = _feature_workload(cfg, seed)
    kw = dict(slots=4, max_seq=256, page_size=16, pages=17,
              prefill_chunk=32, spec_decode=True, spec_k=3)
    max_new = 12

    def run():
        eng = _paged_engine(cfg, params, policy, seed, **kw)
        prefills = [0]
        inner = eng._prefill

        def counted(tokens):
            prefills[0] += 1
            return inner(tokens)
        eng._prefill = counted
        _reset_counts()
        done, steps = {}, 0
        for batch in rounds:
            for p in batch:
                eng.submit(p, max_new=max_new)
            while eng.queued or eng.active_slots:
                eng.step()
                eng.check_invariants()
                steps += 1
            done.update(eng.run())
        return eng, {r: c.tokens for r, c in done.items()}, \
            _read_counts(), prefills[0], steps

    t0 = time.perf_counter()
    eng, tokens, counts, prefills, steps = run()
    wall = time.perf_counter() - t0
    st = eng.pool_stats()
    fwd = st["paged_forwards"]
    want = {"fused_qlhs_matmul": _gemms_per_forward(cfg) * (prefills + fwd),
            "kv_gather_pages": 2 * cfg.n_layers * fwd}
    log(f"[paged features] granite full width, 4 slots, page 16, pool "
        f"{st['n_pages']} pages, chunk 32, spec k=3: {len(tokens)} "
        f"requests in {steps} steps, {wall:.2f}s; prefix hits "
        f"{st['prefix_hits']}, cow copies {st['cow_copies']}, preemptions "
        f"{st['preemptions']}, {fwd} paged forwards, {prefills} bucket "
        f"prefills; spec {eng.spec_stats.as_dict()}")
    log(f"[paged features] launches {counts} expected {want}")
    _check_counts(counts, want, "paged features")
    check(len(tokens) == 6 and all(len(t) == max_new
                                   for t in tokens.values()),
          "paged features: requests did not complete")
    check(st["prefix_hits"] >= 1, "paged features: no prefix hit")
    check(st["cow_copies"] >= 1, "paged features: no copy-on-write")
    check(st["preemptions"] >= 1, "paged features: no preemption")
    with _plain_gather():
        _, tokens_p, _, _, _ = run()
    log(f"[paged features] replay through kv_gather_pages_plain: tokens "
        f"equal {tokens_p == tokens}")
    check(tokens_p == tokens, "paged features: the plain-gather replay "
                              "differs")
    dense = ServeEngine(cfg, params, policy=policy, slots=4, max_seq=256,
                        kv_quant=True, seed=seed, device="cuda")
    dense_tok = {}
    for batch in rounds:
        for p in batch:
            dense.submit(p, max_new=max_new)
        dense_tok.update({r: c.tokens for r, c in dense.run().items()})
    agree = sum(a == b for r in tokens
                for a, b in zip(tokens[r], dense_tok[r]))
    total = sum(len(t) for t in tokens.values())
    log(f"[paged features] token agreement with the dense engine: "
        f"{agree}/{total} (measured, not held: chunked prefill and the "
        f"(k+1)-token verify change the per-tensor Q_f batch)")
    report["paged_features"] = dict(
        pool=st, spec=eng.spec_stats.as_dict(), launches=counts,
        expected_launches=want, wall_s=wall, steps=steps,
        dense_token_agreement=[agree, total])


def _record_sampling_logits(eng):
    """``{(rid, token index): logits row}`` of every token ``eng`` samples
    from a one-token step under its own policy (prefills and spec rounds
    are not recorded)."""
    import dataclasses
    from repro_torch.serve import PagedServeEngine
    rec = {}

    def note(logits):
        for i, slot in enumerate(eng._slots):
            if slot.active and getattr(slot, "phase", "decode") == "decode":
                rec[(slot.req.rid, len(slot.tokens))] = logits[i, -1].clone()
    if isinstance(eng, PagedServeEngine):
        forward = eng._forward

        def paged(tokens, table, start, policy):
            logits = forward(tokens, table, start, policy)
            if tokens.shape[1] == 1 and policy is eng.policy:
                note(logits)
            return logits
        eng._forward = paged
    else:
        decode = eng.model.decode

        def dense(*a, **kw):
            logits, cache = decode(*a, **kw)
            note(logits)
            return logits, cache
        eng.model = dataclasses.replace(eng.model, decode=dense)
    return rec


# where a request re-prefilled through chunks parts from the dense engine,
# the logits it sampled from may differ by at most this share of their
# largest entry: the chunks attend over earlier chunks' int8 K/V (8-bit
# rows, a 1/255 step of each row's range), the dense prefill over its own
# float32 K/V
REPREFILL_LOGIT_SHARE = 0.01


def _explain_divergence(tag, dense, paged, rec_d, rec_p, vocab):
    """Where the two engines' greedy tokens part, show a near-tie decided
    by a small logit difference: the logits each sampled from differ by at
    most ``REPREFILL_LOGIT_SHARE`` of their largest entry, and the dense
    engine's two candidates lie within twice that difference (the most by
    which it can reorder two entries).  A misplaced page or row moves
    logits by whole units.  Tokens before the parting must be equal.
    Returns the partings as (rid, index, margin, max|d|, max|logit|)."""
    partings = []
    for rid, want in dense.items():
        got = paged[rid]
        t = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
                 None)
        if t is None:
            check(len(got) == len(want), f"{tag}: request {rid} lengths "
                                         f"{len(got)} vs {len(want)}")
            continue
        check((rid, t) in rec_d and (rid, t) in rec_p,
              f"{tag}: request {rid} parts at token {t}, where no logits "
              f"were recorded")
        ld, lp = rec_d[(rid, t)][:vocab], rec_p[(rid, t)][:vocab]
        diff = float((ld - lp).abs().max())
        peak = float(ld.abs().max())
        margin = float(ld[want[t]] - ld[got[t]])
        partings.append((rid, t, margin, diff, peak))
        log(f"[{tag}] request {rid} parts at token {t}: dense {want[t]} vs "
            f"paged {got[t]}, dense top-2 margin {margin:.3g}, logits "
            f"max|d| {diff:.3g} = {diff / peak:.3g} of max|logit| "
            f"{peak:.3g}")
        check(diff <= REPREFILL_LOGIT_SHARE * peak and margin <= 2 * diff,
              f"{tag}: request {rid} parts at token {t} by more than a "
              f"near-tie (margin {margin}, logits max|d| {diff}, max|logit| "
              f"{peak})")
    return partings


def paged_reduced_exact(torch, seed, report):
    """Reduced granite under ``QuantPolicy(enabled=False,
    backend="kernel")``: the paged engine's tokens equal the dense
    engine's with whole-prompt and chunked prefill, prefix reuse with
    copy-on-write, preemption and spec decode (as tests/test_paged.py
    holds the JAX package's on the CPU).  Whole-prompt prefill and spec
    decode must give the dense tokens exactly.  A request that prefills
    through chunks (chunked prefill, a prefix hit, a resume after
    preemption) attends over its earlier chunks' int8 K/V where the dense
    prefill attends over float32 K/V, in the JAX package too; where such a
    request parts from the dense engine, ``_explain_divergence`` must show
    a near-tie."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    cfg = get_config("granite-3-2b", smoke=True)
    params = build_model(cfg).init(seed, device="cuda")
    policy = QuantPolicy(enabled=False, backend="kernel")

    def prompts(sizes, s):
        rng = np.random.RandomState(s)
        return [rng.randint(0, cfg.vocab_size, n).tolist() for n in sizes]
    rng = np.random.RandomState(seed + 4)
    base = rng.randint(0, cfg.vocab_size, 13).tolist()
    cow = [base + rng.randint(0, cfg.vocab_size, n).tolist() for n in (4, 6)]
    cow += [cow[0] + rng.randint(0, cfg.vocab_size, n).tolist()
            for n in (3, 5)]
    # name: (prompts, max_new, temperature, engine knobs, re-prefills)
    cases = {
        "whole": (prompts((3, 7, 5, 9), seed + 1), 6, 0.7, {}, False),
        "chunked": (prompts((13, 9, 17), seed + 3), 6, 0.0,
                    dict(prefill_chunk=4, page_size=4), True),
        "prefix_cow": (cow, 6, 0.0, dict(page_size=4), True),
        "preemption": (prompts((7, 12, 5), seed + 5), 10, 0.0,
                       dict(page_size=4, pages=9, prefill_chunk=4), True),
        "spec": (prompts((5, 9, 3), seed + 7), 9, 0.0,
                 dict(spec_decode=True, spec_k=3), False),
    }
    res = {}
    for name, (ps, max_new, temp, kw, chunks) in cases.items():
        out, recs = [], []
        for paged in (False, True):
            extra = dict(paged=True, **kw) if paged else {}
            eng = ServeEngine(cfg, params, policy=policy, slots=2,
                              max_seq=32, kv_quant=True, seed=seed,
                              device="cuda", **extra)
            recs.append(_record_sampling_logits(eng))
            _reset_counts()
            for p in ps:
                eng.submit(p, max_new=max_new, temperature=temp, top_k=8)
            done = eng.run()
            out.append({r: c.tokens for r, c in done.items()})
        eng.check_invariants()
        counts = _read_counts()
        st = eng.pool_stats()
        same = out[0] == out[1]
        log(f"[paged reduced exact] {name}: tokens equal the dense "
            f"engine's {same}; prefix hits {st['prefix_hits']}, cow "
            f"{st['cow_copies']}, preemptions {st['preemptions']}, "
            f"kv_gather_pages {counts['kv_gather_pages']}")
        check(sorted(out[0]) == sorted(out[1]),
              f"paged reduced exact {name}: requests differ")
        check(same or chunks, f"paged reduced exact {name}: tokens differ "
                              f"from the dense engine's: {out[1]} vs "
                              f"{out[0]}")
        partings = _explain_divergence(f"paged reduced exact {name}", out[0],
                                       out[1], *recs, cfg.vocab_size)
        res[name] = dict(same_tokens=same, partings=partings, pool=st)
        check(counts["kv_gather_pages"] == 2 * cfg.n_layers
              * st["paged_forwards"] and counts["kv_dequant_rows"] == 0,
              f"paged reduced exact {name}: launches {counts}")
    check(res["prefix_cow"]["pool"]["cow_copies"] >= 1
          and res["preemption"]["pool"]["preemptions"] >= 1,
          "paged reduced exact: no copy-on-write or no preemption")
    report["paged_reduced_exact"] = res


def _profile_paged_decode(torch, eng):
    """One full-batch paged decode step at granite's width (8 lanes of 16
    pages, every lane at position 128), profiled by ``_profile``."""
    B, nb = eng.slots, eng.nb
    pool = eng.model.init_paged_pool(eng.cfg, eng.n_pages, eng.page_size,
                                     device="cuda")
    table = torch.arange(1, 1 + B * nb, dtype=torch.int32,
                         device="cuda").reshape(B, nb)
    tok = torch.ones((B, 1), dtype=torch.int64, device="cuda")
    start = torch.full((B,), eng.max_seq // 2, dtype=torch.int64,
                       device="cuda")
    step = lambda: eng.model.paged_decode(  # noqa: E731
        eng.params, pool, {"tokens": tok}, eng.policy, table, start,
        kv_quant=True)
    return _profile(torch, step, f"one paged decode step ({B} lanes)")


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


def _train_policy(quant, bits, backend, fused=None):
    """The launcher's FQT policy (``launch/train.py``: bhq_block=256);
    ``fused=False`` takes every role off the fused kernels."""
    from repro_torch.core import QuantPolicy
    return QuantPolicy.fqt(quant, bits, bhq_block=256, backend=backend,
                           fused=fused)


def _train_engine(cfg, quant, bits, backend, seed, fused=None):
    """The engine ``python -m repro_torch.launch.train --full --quant
    QUANT --grad-bits BITS --backend BACKEND`` builds (batch 8, seq 64),
    with the policy's ``fused`` knob."""
    from repro_torch.engine import Engine
    return Engine(cfg, _train_policy(quant, bits, backend, fused),
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
    from repro_torch import kernels
    names = ("fused_qlhs_matmul", "fused_qboth_tn_matmul", "q8_matmul",
             "quantize_sr_rows", "quantize_sr_tensor")
    saved = {n: getattr(backend, n) for n in names}
    for n in names:
        setattr(backend, n, getattr(kernels, n + "_plain"))
    try:
        return _replay(torch, eng)
    finally:
        for n, fn in saved.items():
            setattr(backend, n, fn)


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


def _backward_vs(torch, eng, quant, bits, tag, fused=None,
                          against=("simulate", None)) -> dict:
    """Each backward GEMM of one step re-run from its (x, w, key, g) on the
    kernel backend (with ``fused``) and on the reference ``against``
    (backend, fused): dX and dW within rtol 1e-3 / atol 5e-3 (the repo's
    cross-backend tolerance), and within rtol 1e-3 plus an atol of
    ``GRAD_ATOL_FRAC`` times the reference's max|.| — the gradients lie
    far below 5e-3, so only this second check can catch a wrong backward
    GEMM.  ``margin`` is the largest share of that scaled tolerance any
    entry used (at most 1)."""
    from repro_torch.core import fqt_matmul
    calls = _step_gemms(torch, eng)
    n = _gemms_per_forward(eng.cfg)
    check(len(calls) == n, f"{tag}: {len(calls)} quantized GEMMs in one "
                           f"step, the path implies {n}")
    worst = {k: 0.0 for k in ("dx", "dw", "dx_ref", "dw_ref", "dx_margin",
                              "dw_margin")}
    ref_name = (against[0] if against[1] is None
                else f"{against[0]} fused={against[1]}")
    for path, x, w, key, g in calls:
        check(g is not None, f"{tag}: no gradient reached {path}")
        grads = []
        for backend, fz in (("kernel", fused), against):
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            y = fqt_matmul(xr, wr, key,
                           _train_policy(quant, bits, backend, fz),
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
                  f"{tag}: {path} x {tuple(x.shape)}: kernel vs {ref_name} "
                  f"{name} differ by {float(d.max())} beyond rtol "
                  f"{RTOL}/atol {ATOL}")
            check(margin <= 1.0,
                  f"{tag}: {path} x {tuple(x.shape)}: kernel vs {ref_name} "
                  f"{name} differ by {float(d.max())} beyond rtol {RTOL} "
                  f"+ {GRAD_ATOL_FRAC} * max|{name}| ({peak:.3g}); share "
                  f"of that tolerance used {margin:.3g}")
    log(f"[{tag}] every backward GEMM of one step ({n}) re-run from its "
        f"(x, w, key, g): kernel vs {ref_name} max|d| dX {worst['dx']:.3g} "
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
        gemms = _backward_vs(torch, eng, quant, bits, tag)
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


def train_unfused(torch, seed, report) -> dict:
    """statquant-tx at full width and depth trains TRAIN_STEPS steps under
    fqt(psq, 8) and fqt(ptq, 8) with ``fused=False`` on the kernel
    backend: the quantize_sr kernels and q8_matmul in all three roles."""
    import numpy as np
    from repro_torch.configs import get_config
    cfg = get_config("statquant-tx")
    n = _gemms_per_forward(cfg)
    total, res = {}, {}
    for quant in ("psq", "ptq"):
        tag = f"train {quant}8 unfused"
        eng = _train_engine(cfg, quant, 8, "kernel", seed, fused=False)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        want = {"q8_matmul": 3 * n * TRAIN_STEPS}
        if quant == "psq":
            want.update(quantize_sr_rows=n * TRAIN_STEPS,
                        quantize_sr_tensor=n * TRAIN_STEPS)
        else:
            want.update(quantize_sr_tensor=2 * n * TRAIN_STEPS)
        log(f"[{tag}] {cfg.name} full width: {TRAIN_STEPS} steps of 8 x 64 "
            f"tokens in {wall:.2f}s, launches {counts} expected {want}")
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
        vs_sim = _backward_vs(torch, eng, quant, 8, tag, False)
        vs_fused = _backward_vs(torch, eng, quant, 8, tag, False,
                                         against=("kernel", True))
        res[quant] = dict(
            wall_s=wall, step_s=wall / TRAIN_STEPS, launches=counts,
            expected_launches=want, kernel=kern, plain=plain,
            max_rel_diff_vs_plain=err, backward_gemms_vs_simulate=vs_sim,
            backward_gemms_vs_fused=vs_fused)
        res[quant]["profile_step"] = _profile(
            torch, _one_step(eng), f"one training step, {quant}8 unfused")
    res["launches"] = total
    report["train_unfused"] = res
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
                                     kv_dequant_rows, kv_dequant_rows_plain,
                                     kv_gather_pages, kv_gather_pages_plain,
                                     quantize_sr_rows, quantize_sr_rows_plain,
                                     quantize_sr_tensor,
                                     quantize_sr_tensor_plain)
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
    # one layer's K or V read of a paged decode step: 8 lanes x 256
    # positions x 512 features, pages of 16 (the smoke run's) and 8
    for P in (16, 8):
        ops = pool_operands(torch, gen, 8, P, 512)
        B, nb = ops[3].shape
        S, D = nb * P, 512
        ms = _time_ms(torch, lambda: kv_gather_pages(*ops), flush, 50)
        plain = _time_ms(torch, lambda: kv_gather_pages_plain(*ops), flush,
                         50)
        # codes and (scale, zero) of every gathered row, the table, f32 out
        bound, by = _bound(B * S * (D + 8) + 4 * B * nb + 4 * B * S * D,
                           B * S * D, FP32_OPS_PER_S)
        rows.append(dict(kernel="kv_gather_pages", shape=[B, S, D],
                         page_size=P, ms=ms, plain_ms=plain, library_ms=None,
                         bound_ms=bound, bound_by=by))
        log(f"[time] kv_gather_pages (B, nb*P, D) = {(B, S, D)} P={P}: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.5f} "
            f"ms ({by})")
    # the backward quantizes of the statquant-tx step and one of granite's
    for (M, N) in [(512, 512), (512, 1024), (512, 10240), (2048, 8192)]:
        x, rb = sr_operands(torch, gen, M, N)
        for name, kern, plain_fn in (
                ("quantize_sr_rows", quantize_sr_rows, quantize_sr_rows_plain),
                ("quantize_sr_tensor", quantize_sr_tensor,
                 quantize_sr_tensor_plain)):
            ms = _time_ms(torch, lambda: kern(x, rb, 8), flush, 20)
            plain = _time_ms(torch, lambda: plain_fn(x, rb, 8), flush, 5)
            # f32 x and int64 bits in, int8 codes and (scale, zero) out;
            # the tensor mode's wrapper reads x once more for its aminmax
            bound, by = _bound(13 * M * N + 8 * M, 6 * M * N,
                               FP32_OPS_PER_S)
            rows.append(dict(kernel=name, shape=[M, N], ms=ms,
                             plain_ms=plain, library_ms=None,
                             bound_ms=bound, bound_by=by))
            log(f"[time] {name} {(M, N)}: kernel {ms:.4f} ms, plain "
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
    # positions, pages of 16 for the gather), the lm_head GEMMs and
    # gradient (the largest) for the training kernels
    return {"fused_qlhs_matmul": pick("fused_qlhs_matmul", [8, 2048, 8192]),
            "kv_dequant_rows": pick("kv_dequant_rows", [2048, 512]),
            "fused_qlhs_matmul_dx": pick("fused_qlhs_matmul_dx",
                                         [512, 10240, 512]),
            "q8_matmul": pick("q8_matmul", [512, 10240, 512]),
            "fused_qboth_tn_matmul": pick("fused_qboth_tn_matmul",
                                          [512, 512, 10240]),
            "kv_gather_pages": pick("kv_gather_pages", [8, 256, 512]),
            "quantize_sr_rows": pick("quantize_sr_rows", [512, 10240]),
            "quantize_sr_tensor": pick("quantize_sr_tensor", [512, 10240])}


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

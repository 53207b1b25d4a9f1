#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --step-wall TREE [TREE ...] [--host-only]
                          [--rounds N]
    python3 chip_smoke.py --phases PHASE [PHASE ...]

The second form only times the GEMM wrappers' host cost a call, the KV
reads' and SR quantizers' device time, the training step's wall and
profiles granite's decode step (dense, paged, from packed weights) and
the unfused training step for the package of each checkout TREE, one
process each, in the order given (``step_wall_trees``); with
``--host-only`` only the wrappers' host cost, with ``--rounds N`` N
passes over the trees.  The third
builds the kernels and runs only the named phases (``ONLY_PHASES``: vlm,
hybrid, rwkv, audio, moe_serve, moe_train, dist, dryrun, audit,
autotune), to iterate on them; it prints no result line.

From the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit.  It imports nothing of JAX or of the JAX package ``repro``.

  1. Prints the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
     name and power limit); exits non-zero with no result when there is no
     CUDA device or no ``src/repro_torch`` beside this file.
  2. Builds every kernel of ``src/repro_torch/csrc`` into
     ``build/repro_torch`` (one nvcc per source, in parallel) and times it;
     prints ``-Xptxas -v``'s registers, shared memory and spills, and for
     each tile of the int8 tensor-core kernels (``q8_matmul``, the dX
     entry ``fused_qlhs_dx``, dW ``fused_qboth_tn``, the int8 forward
     ``fused_qlhs_fwd``'s decode and wide tiles, deterministic and SR, and
     the packed GEMMs' ``fused_qlhs_packed`` and ``packed_matmul`` decode
     and wide tiles at 1, 2, 4 and 8 bits) one
     line with its shape and dynamic shared memory and one with the
     blocks the card runs at once in clusters of 1..8 as the library
     reports it (what the wrappers plan with) beside
     ``kernels/splitk.py``'s table; and the SR quantizers' card numbers
     (``quantize_sr.on_card``) beside their H100 default, with each
     ``sr_shapes`` plan's occupancy model held to the card's occupancy
     calculator.
  3. Holds each kernel against its plain PyTorch version on the card, bit
     for bit, and a second call against the first: ``fused_qlhs_matmul``
     (the int8 forward) at every (K, N) of granite-3-2b's serving path for
     M in {1, 8, 16, 128} and at 2048 rows, at statquant-tx's training
     forward, deterministic and SR, K = 1030, unaligned rows, full-range
     codes at K = 8192, and ragged; its dX/SR mode, ``q8_matmul`` and
     ``fused_qboth_tn_matmul`` (5- and 8-bit dY) at every GEMM of the
     statquant-tx training step (512 tokens), at granite-3-2b's (K, N)
     with 2048 tokens, full-range codes and unaligned rows, and ragged;
     ``kv_dequant_rows`` bit for bit;
     ``kv_gather_pages`` at granite-3-2b's paged shapes (8 lanes, D = 512,
     P = 8 and 16, nb*P = 256) and ragged ones (P = 3, D = 40; tables that
     repeat pages and point at page 0; zero scales); their K-and-V pairs
     ``kv_dequant_rows_kv`` and ``kv_gather_pages_kv`` (one launch, scales
     clamped) at the same shapes, rows off the 16-byte grid, and 8 slots
     or lanes at a 4,096-token context ((32768, 512) a side; pages of 16
     from 1 + 2,048), every kernel body forced through the C entry; and
     ``quantize_sr_rows``/``quantize_sr_tensor`` at every backward shape
     of the statquant-tx step, at granite's (2048, N), ragged and at
     widths off the 4-code grid, with SR bits spanning all 32 bits, codes,
     scale and zero bit for bit and twice: through the wrappers and under
     every plan forced through the C entries (each cluster size with the
     row's share staged whole, a third and none; the tensor's planned
     grid, 7 blocks, one an SM and the resident grid, staged as far as
     shared memory holds, an eighth and none), also on row views off the
     16-byte grid, and on a constant tensor, one of -0.0 and +0.0 only and
     one whose extremes are its last elements, at 4 and 8 bits
     (``sr_kernels_vs_plain``); ``q8_matmul`` also at the forward and dW
     (``tn``) shapes of the unfused step.
  4. Serves granite-3-2b at full width, its depth cut from 40 to
     ``GRANITE_LAYERS`` (20) layers (random weights from the seed),
     through ``ServeEngine(slots=8, max_seq=256, kv_quant=True)`` on the
     ``kernel`` backend: 16 requests, prompts of 16-128 tokens,
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
  5. Paged serving, granite-3-2b at full width and ``GRANITE_LAYERS``
     (20) layers:
     ``ServeEngine(paged=True, page_size=16)`` with the same 8 slots,
     ``max_seq``, warm-up and 16 requests as 4, whole-prompt prefill, spec
     decode off.  Its tokens must equal the dense engine's (a one-token
     paged step is the dense step, arithmetically); ``kv_gather_pages_kv``
     launches once per layer per paged forward (K and V of a layer in
     one launch) and the single-side KV kernels never; a replay through
     its plain version gives the same tokens and logits.  Then the paged
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
  6. Serving from bit-packed weights, granite-3-2b at full width and
     ``GRANITE_LAYERS`` (20) layers
     (``ServeEngine(weight_bits=...)``: every dense kernel quantized once
     at load and packed): at 8 bits, the dense phase's 8 slots, warm-up
     and 16 requests; tokens must equal the dense engine's and each
     prompt's prefill logits must be bit-identical to it (the same codes,
     column sums and epilogue), ``fused_qlhs_packed_matmul`` launches
     once per GEMM of each forward (141 at 20 layers) and
     ``fused_qlhs_matmul`` never;
     resident GEMM-weight bytes are printed beside fp32's.  At 4 bits, the
     same workload (fused), and a 4-request workload under
     ``fused=False`` through ``packed_matmul``; each against its replay
     with that kernel's plain version swapped in (same tokens, the logits
     of every decode sample bit-identical), exact launch counts, and every
     GEMM of one prefill within rtol 1e-3 / atol 5e-3 of ``simulate`` on
     the same packed weights.  Before that, both packed kernels against
     their plain versions bit for bit at every (K, N) of granite's path
     for M in {8, 128}, at 1, 2, 4 and 8 bits, and ragged, and at 8 bits
     ``fused_qlhs_packed_matmul`` against ``fused_qlhs_matmul`` on the
     same codes; and every split of K, forced through the C entries, at
     (8, 2048, 8192) (the decode tile) and (40, 1001, 300) (the wide tile,
     K ragged at every width), at each width.
  7. A short statquant-tx full-width serving run (layernorm, gelu, qkv
     bias), with the checks of 4.
  8. Trains statquant-tx at full width and depth (6 layers, d=512,
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
     key, dY).  Then 3 steps under ``fqt(psq, 8)`` with the forward
     weight quantizer overridden to ``int4w:4`` (``launch/train.py
     --override '.*=fwd_weight:int4w:4'``), fused (per step 37
     ``fused_qlhs_packed_matmul``, 37 dX, 37 dW) and unfused (37
     ``packed_matmul``, 74 ``q8_matmul``, 37 of each ``quantize_sr``):
     finite loss and gradient norm, identical through the plain versions.
  9. Prints the timing harness's per-call floor first (``time_floor``:
     the events alone, and the KV read at (1, 16) after the ``zero_()``
     flush and after a read flush), then the KV reads one side and as the
     pair at 8 slots or lanes x 256 and x 4,096 positions, beside two
     single calls, the plain pair, every body, the floor and the bound
     (``time_kv``).  Times each kernel at its path shapes (the serving
     kernels at the
     decode and prefill shapes, the training kernels at the statquant-tx
     step's) with CUDA events after warm-up, an L2 flush before every
     launch and every launch queued behind a spin kernel (device time,
     not host dispatch), beside its plain version, ``torch._int_mm`` on
     the same int8 shapes as the library yardstick (the bare int8
     product, without the quantize and epilogue), and its bound (bytes
     over 3.35 TB/s or int8 operations over 1,979 TOP/s, the H100 SXM
     data-sheet peaks), ``q8_matmul`` with an N-major B too, at the
     unfused step's lm_head forward and dW (512, 512, 10240), the int8
     forward at the fused step's lm_head (512, 512, 10240); the packed
     kernels at the
     decode up-projection at 8, 4, 2 and 1 bits (at 8 bits also at every
     other decode GEMM of granite), and at lm_head, (128, 2048, 8192) and
     (512, 512, 10240) at 4 bits, with ``torch._int_mm`` on the unpacked
     codes; both SR quantizers at (512, 512), (512, 1024), (512, 10240)
     and (2048, 8192) beside their plain versions, the floor and the
     bound, each one device kernel a call (``time_sr``).  Then profiles
     one granite decode step
     (dense, paged, and from 8- and 4-bit packed weights, with the packed
     forward's share) and one training step under each policy (fused and
     unfused): wall time, device busy time and idle share, device time by
     op and by kernel.
 10. (run after 8, before the timings of 9) ``[ckpt train]``:
     statquant-tx at full width trains 6 steps under ``fqt(bhq,5)`` and
     ``fqt(psq,8)`` against 3 steps with an asynchronous checkpoint and a
     new engine resuming to 6, and against a run stopped by
     ``PreemptionHandler.request_stop`` after step 4 (checkpointed
     synchronously) and resumed: losses and every leaf of params, m and
     v, step, t and rng equal (``torch.equal``; a leaf that differs is a
     port fault).  Prints the checkpoint's bytes on disk, the snapshot
     time in the loop, the write time on the worker thread and the
     restore time.  ``[ckpt serve]``: ``ServeEngine.from_checkpoint`` on
     that checkpoint dense, ``paged=True`` and ``weight_bits=4`` serves
     the statquant-tx requests of 7 with the tokens of the engine built
     from the same params in memory, through its kernels.
 11. ``[native]``: statquant-tx training on the ``native`` backend
     (``torch._int_mm``), each step from ``simulate``'s state: full
     width, losses within rtol 1e-3 / atol 5e-3 and every backward GEMM
     within rtol 1e-3 + 5e-3 x max|ref| of ``simulate``, no hand-written
     kernel launched; reduced config, losses and gradient norms within
     rtol 1e-3 / atol 5e-3; the step wall beside the ``kernel`` backend's.
 12. ``[theory]``: ``quantizer_variance`` (exact) against
     ``empirical_mean_and_variance`` (64 draws) for PTQ and PSQ (through
     the ``quantize_sr`` kernels) and BHQ at 5 and 8 bits on a (512,
     10240) gradient in the paper's outlier regime: the empirical
     variance within 6 sd of its expectation, the unbiasedness ratio in
     [0.5, 2], bhq < psq < ptq; and ``fqt_gradient_stats`` of full-width
     statquant-tx (16 draws) against its QAT gradient under
     ``fqt(psq,8)`` and ``fqt(bhq,5)`` (Theorem 1 on the card).

 13. ``[moe serve]`` (``serve_moe``): granite-moe-1b-a400m at full width
     (d=1024, 32 experts top-8, d_ff 512), its depth cut from 24 to 12
     layers (``MOE_SERVE_LAYERS``; random weights from the seed) so that
     the whole run fits its limit, through the dense, the
     paged (pages of 16) and the ``weight_bits=4`` engine, 8 slots,
     ``max_seq=256``, int8 KV, 16 requests of 16-128 prompt and 16 new
     tokens: exact launch counts (every router and expert GEMM on every
     forward), paged tokens equal to the dense engine's or parting at a
     near-tie; for each engine, one request of each prefill bucket
     through the kernels and through their plain versions: the same
     tokens and every forward's logits bit for bit, the kernels handed
     every argument shape of the main run (recorded there); every GEMM of
     one prefill within tolerance of ``simulate``; tok/s, p50/p95 step
     and resident GEMM-weight bytes of each, a profiled decode step of
     the dense and the 4-bit engine.
 14. ``[moe train]`` (``train_moe``): granite-moe-1b-a400m at full width
     with its depth cut to 2 layers, 8 x 64 tokens, AdamW: 2 steps under
     ``fqt(psq,8)`` and 1 under ``fqt(bhq,5)``: exact launch counts,
     (loss, aux, grad norm) identical through the plain versions, every
     backward GEMM of the first step within tolerance of ``simulate``;
     the step wall and a profiled ``fqt(psq,8)`` step.
 15. ``[vlm]``, ``[hybrid]``, ``[rwkv]`` (``vlm_phase``, ``hybrid_phase``,
     ``rwkv_phase``): qwen2-vl-2b (M-RoPE, stub vision embeddings; 28
     layers, d=1536), zamba2-2.7b (54 Mamba2 layers in 9 outer blocks,
     each followed by the one shared attention block; d=2560) and
     rwkv6-1.6b (24 layers, d=2048) at full width and depth, random
     weights from the seed, under ``qat`` on the ``kernel`` backend:
     prefill 4 prompts (128 stub embeddings whose M-RoPE positions span
     four frames of a 4 x 4 patch grid, then text; 256 tokens, two SSD
     chunks; 64 tokens), ``generate`` 8 tokens, and for the VLM 8 decode
     steps on the int8 cache and one 16-token paged chunk; exact launch
     counts; the same sequence through the kernels' plain versions gives
     bit-identical logits and equal tokens and hands each kernel every
     argument shape of the kernel run; a profiled decode step.  Then each
     trains at full width with its depth cut (4, 12 = two outer blocks,
     4 layers; 4 x 64, 2 x 128, 2 x 64 tokens): 2 steps under
     ``fqt(psq,8)`` and 1 under ``fqt(bhq,5)``, with ``[moe train]``'s
     checks (``_train_cut``) and one profiled psq step, with the device
     time inside the SSD and WKV markers.
 16. ``[audio]`` (``audio_phase``): whisper-medium (encoder-decoder; 24
     encoder and 24 decoder layers, d=1024, cross-attention over 1,500
     stub frames) at full width and depth, random weights from the seed,
     under ``qat`` on the ``kernel`` backend: prefill 4 rows of 1,500
     frames and 32-token prompts, ``generate`` 8 tokens; exact launch
     counts (385 GEMMs a prefill: 6 an encoder layer, 10 a decoder layer
     and lm_head; 193 a decode step: 8 a decoder layer and lm_head); the
     plain replay as in 15; every GEMM of one prefill within rtol 1e-3 /
     atol 5e-3 of ``simulate`` from its input; a profiled decode step.
     Then it trains at full width with 2 encoder and 2 decoder layers, 2
     x 1,500 frames and 64 tokens, with ``_train_cut``'s checks.
 17. ``[ops]`` (``ops_phase``): ``kernels/ops.py`` through the kernels
     against the plain versions bit for bit: ``fused_qlinear`` at (512,
     512, 10240) and ``fused_qlinear_bwd`` under ptq, psq and bhq at
     (512, 512, 512).
 18. ``[dist]`` (``dist_phase``): a one-rank NCCL process group and a
     (1, 1) mesh on the card; statquant-tx at full width trains on the
     mesh engine (every per-tensor range all-reduced, parameters and
     moments as ``DTensor`` shards) against the flat engine from the same
     seed: 3 steps each under ``fqt(psq,8)`` and ``fqt(bhq,5)``, 2
     unfused ``fqt(ptq,8)`` steps and 2 ``fqt(psq,8)`` steps with
     ``loss_chunks=4``, losses, grad norms, parameters and moments after
     each step bit-identical, launch counts exact; 2 steps
     with ``compress_axis="data"``, 2 ``quantize_sr_rows`` a gradient leaf,
     the exchange bit-identical with the plain quantize; ``quantize_sr_tensor``
     given a range; ``quantize_sr_rows`` timed at the exchange's shapes;
     one mesh step profiled beside the flat step's wall.
 19. ``[dryrun]`` (``dryrun_phase``): the dry run (``launch/dryrun.py``)
     of statquant-tx's training step (the smoke's 8 x 64 tokens, AdamW,
     ``fqt(psq,8)`` and ``fqt(bhq,5)``, ``remat`` off and on) beside the
     step on the card: GEMM FLOPs equal, exactly (the kernels' launches
     recorded, and the attention's ``bmm``); the peak bytes above the
     resident ones beside ``max_memory_allocated``'s; the roofline bound
     beside the busy time.
     The remat step bit-identical to the stored one, launches exact (each
     layer's forward GEMMs but its last twice), peak lower.
     granite-3-2b at full width and 4 layers: a bfloat16 prefill and 4
     decode steps on a bfloat16 cache bit-identical to the plain replay.
     One production cell through the CLI (granite-3-2b ``decode_32k`` on
     the 16x16 mesh of a fake process group of 256 ranks).

 20. ``[audit]`` (``audit_phase``): the quantization-contract audit
     (``analysis/audit.py``) on the meta device, CPU time only: the engine
     step of statquant-tx at full width under ``fqt(psq,8)`` and
     ``fqt(bhq,5)``, the loss and gradient of granite-3-2b at full width
     and its 40 layers and of whisper-medium at full width
     (``AUDIT_WHISPER_LAYERS`` layers a stack), on the ``kernel`` backend:
     coverage 1.0, no violation; coverage, GEMMs and range findings
     printed.
 21. ``[autotune]`` (``autotune_phase``): the autotuner
     (``kernels/autotune.py``) into a temporary cache at
     ``autotune.SWEEP_CASES``, on the operands of ``autotune.case_call``:
     dX, ``q8_matmul`` (K-major B) and dW at lm_head, ``q8_matmul`` at
     (512, 512, 512), (2048, 2048, 2048) and (128, 2048, 8192), the int8
     forward and both packed kernels (8 and 4 bits) at (8, 2048, 8192)
     and at decode lm_head, every tile each kernel was built
     with (decode and wide) at every split of K, and both KV reads at
     every body; each candidate through its wrapper, bit-identical to the
     planned call, which equals the plain version (``[split]`` lines);
     the split model's pick beside the card's winner (``[autotune]``);
     ``tile_smem_bytes`` equal to every library's ``_tile`` report;
     ``analysis.check_kernels`` clean on the shipped defaults and on the
     tuned cache.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Any failed phase exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import shutil
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
# passes over the wrappers whose median is a wrapper's host time a call
# (``step_wall``): the host is shared, one pass can read 2x another
HOST_REPEATS = 9
KERNEL_TOL = 1e-6                  # max|kernel - plain| <= TOL * max|plain|
# the repo's cross-backend tolerance (tests/test_backend.py,
# tests/test_fqt.py)
RTOL, ATOL = 1e-3, 5e-3
# the backward GEMMs' atol as a fraction of the reference's largest entry
GRAD_ATOL_FRAC = 5e-3

# (K, N) of every fused_qlhs_matmul on granite-3-2b's serving path
GRANITE_KN = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
              (2048, 49408)]
# the granite serving phases' depth (full width; the config has 40
# layers): cut so the whole run, MoE phases included, fits its limit
GRANITE_LAYERS = 20


def granite_config():
    """granite-3-2b at full width, depth cut to ``GRANITE_LAYERS``."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("granite-3-2b"),
                               n_layers=GRANITE_LAYERS)


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
    ap.add_argument("--step-wall", nargs="+", metavar="TREE", type=Path,
                    help="only time the training step's wall and the GEMM "
                         "wrappers' host time a call, for the package of "
                         "each checkout TREE in turn (one process each)")
    ap.add_argument("--host-only", action="store_true",
                    help="with --step-wall: only the GEMM wrappers' host "
                         "time a call")
    ap.add_argument("--rounds", type=int, default=1,
                    help="with --step-wall: pass over the trees this many "
                         "times (one process a tree and round)")
    ap.add_argument("--step-wall-of", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--phases", nargs="+", metavar="PHASE",
                    choices=sorted(ONLY_PHASES),
                    help="build, then run only these phases (to iterate on "
                         "them); prints no result line")
    args = ap.parse_args(argv)

    if args.step_wall:
        return step_wall_trees(args.step_wall, args.seed, args.host_only,
                               args.rounds)
    tree = args.step_wall_of or ROOT
    if not (tree / "src" / "repro_torch").is_dir():
        print(f"chip_smoke.py: no src/repro_torch in {tree}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree / "src"))
    if args.step_wall_of:
        print(json.dumps(step_wall(torch, args.seed, args.host_only)))
        return 0

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
    report["int8_mma_build"] = int8_mma_build(built)
    report["quantize_sr_build"] = quantize_sr_build(built)

    def phase(fn, *a):
        """``fn(torch, *a)``, its seconds printed and kept."""
        t0 = time.perf_counter()
        out = fn(torch, *a)
        s = time.perf_counter() - t0
        report.setdefault("phase_s", {})[fn.__name__] = s
        log(f"[phase] {fn.__name__} {s:.1f}s")
        return out

    seed = args.seed
    if args.phases:
        for name in args.phases:
            phase(globals()[ONLY_PHASES[name]], seed, report)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_phases.json").write_text(
            json.dumps(report, indent=1, default=str))
        return 0
    errs = phase(kernel_vs_plain, report)
    errs.update(phase(train_kernel_vs_plain, report))
    serve, granite_engine, workload = phase(serve_granite, seed, report)
    paged, paged_engine = phase(serve_granite_paged, seed, report,
                                granite_engine, workload)
    errs.update(phase(packed_kernel_vs_plain, report))
    packed, packed_engines = phase(serve_granite_packed, seed, report,
                                   granite_engine, workload)
    phase(paged_features, seed, report, granite_engine.params)
    phase(paged_reduced_exact, seed, report)
    phase(serve_statquant, seed, report)
    train = phase(train_statquant, seed, report)
    unfused = phase(train_unfused, seed, report)
    packed_train = phase(train_packed, seed, report)
    serve_from = phase(ckpt_train, seed, report)
    phase(ckpt_serve, seed, report, serve_from)
    phase(native_train, seed, report)
    phase(theory_phase, seed, report)
    moe = phase(serve_moe, seed, report)["launches"]
    moe_train = phase(train_moe, seed, report)["launches"]
    families = [phase(fn, seed, report)
                for fn in (vlm_phase, hybrid_phase, rwkv_phase, audio_phase)]
    fam = {k: sum(f[k] for f in families) for k in families[0]}
    phase(ops_phase, seed, report)
    dist = phase(dist_phase, seed, report)
    errs["quantize_sr_rows"] = max(errs["quantize_sr_rows"],
                                   dist["max_abs_err"])
    dist = dist["launches"]
    dry = phase(dryrun_phase, seed, report)["launches"]
    dist = {k: dist.get(k, 0) + dry.get(k, 0) for k in set(dist) | set(dry)}
    phase(audit_phase, seed, report)
    phase(autotune_phase, seed, report)
    timings = phase(time_kernels, report)
    serve["profile_decode_step"] = _profile_decode(torch, granite_engine,
                                                   share=KV_SHARE)
    paged["profile_decode_step"] = _profile_paged_decode(torch, paged_engine)
    for bits, eng in packed_engines.items():
        # the packed forward's kernels: a packed engine runs no other
        # fused-quantize kernel
        packed[f"w{bits}"]["profile_decode_step"] = _profile_decode(
            torch, eng, f"w{bits} packed", share=("qlhs",) + KV_SHARE)
    # each KV kernel serves its single-side and its pair wrapper; the main
    # paths launch the pair (timed at the decode shape as the line's row)
    for name in ("kv_dequant_rows", "kv_gather_pages"):
        errs[name] = max(errs[name], errs.pop(name + "_kv"))

    def entry(name, key, source, replaces, launches):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=errs[key], **timings[key])
    csrc = "src/repro_torch/csrc/"
    # the MoE phases' launches join each kernel's (serving: dense, paged and
    # 4-bit engines; training: both policies), the VLM, hybrid, RWKV6
    # and audio phases' (serving and training), and [dist]'s mesh steps
    # with [dryrun]'s steps and granite's bf16 prefill and decode
    kernels = [
        entry("fused_qlhs_matmul", "fused_qlhs_matmul",
              csrc + "fused_qlhs_fwd.cu", "src/repro/kernels/fused_fqt.py:93",
              serve["launches"]["fused_qlhs_matmul"]
              + moe["fused_qlhs_matmul"] + moe_train["fused_qlhs_matmul"]
              + fam["fused_qlhs_matmul"] + dist["fused_qlhs_matmul"]),
        entry("kv_dequant_rows", "kv_dequant_rows", csrc + "kv_dequant.cu",
              "src/repro/kernels/kv_dequant.py:31",
              serve["launches"]["kv_dequant_rows"]
              + serve["launches"]["kv_dequant_rows_kv"]
              + moe["kv_dequant_rows"] + moe["kv_dequant_rows_kv"]
              + fam["kv_dequant_rows_kv"]),
        entry("fused_qlhs_matmul (dX, SR)", "fused_qlhs_matmul_dx",
              csrc + "fused_qlhs_dx.cu", "src/repro/kernels/fused_fqt.py:93",
              train["launches"]["fused_qlhs_matmul_dx"]
              + moe_train["fused_qlhs_matmul_dx"]
              + fam["fused_qlhs_matmul_dx"] + dist["fused_qlhs_matmul_dx"]),
        entry("q8_matmul", "q8_matmul", csrc + "q8_matmul.cu",
              "src/repro/kernels/q8_matmul.py:38",
              train["launches"]["q8_matmul"]
              + unfused["launches"]["q8_matmul"] + moe_train["q8_matmul"]
              + fam["q8_matmul"] + dist["q8_matmul"]),
        entry("fused_qboth_tn_matmul", "fused_qboth_tn_matmul",
              csrc + "fused_qboth_tn.cu", "src/repro/kernels/fused_fqt.py:215",
              train["launches"]["fused_qboth_tn_matmul"]
              + moe_train["fused_qboth_tn_matmul"]
              + fam["fused_qboth_tn_matmul"] + dist["fused_qboth_tn_matmul"]),
        entry("kv_gather_pages", "kv_gather_pages", csrc + "kv_gather.cu",
              "src/repro/kernels/kv_gather.py:43",
              paged["launches"]["kv_gather_pages"]
              + paged["launches"]["kv_gather_pages_kv"]
              + moe["kv_gather_pages"] + moe["kv_gather_pages_kv"]
              + fam["kv_gather_pages_kv"]),
        entry("quantize_sr_rows", "quantize_sr_rows", csrc + "quantize_sr.cu",
              "src/repro/kernels/quantize_sr.py:34",
              unfused["launches"]["quantize_sr_rows"]
              + dist["quantize_sr_rows"]),
        entry("quantize_sr_tensor", "quantize_sr_tensor",
              csrc + "quantize_sr.cu", "src/repro/kernels/quantize_sr.py:98",
              unfused["launches"]["quantize_sr_tensor"]
              + dist["quantize_sr_tensor"]),
        entry("fused_qlhs_packed_matmul", "fused_qlhs_packed_matmul",
              csrc + "fused_qlhs_packed.cu",
              "src/repro/kernels/fused_fqt.py:328",
              packed["launches"]["fused_qlhs_packed_matmul"]
              + packed_train["launches"]["fused_qlhs_packed_matmul"]
              + moe["fused_qlhs_packed_matmul"]),
        entry("packed_matmul", "packed_matmul", csrc + "packed_matmul.cu",
              "src/repro/kernels/q4_matmul.py:71",
              packed["launches"]["packed_matmul"]
              + packed_train["launches"]["packed_matmul"]),
    ]
    report["kernels"] = kernels
    report["profiler_repeats"] = PROFILER_REPEATS
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def int8_mma_build(built) -> dict:
    """One line for each tile of the int8 tensor-core kernels (the packed
    GEMMs' at each width too): its shape (the library's ``*_tile``), the
    dynamic shared memory it asks for, and ``-Xptxas -v``'s registers,
    static shared memory and spills over its library's instantiations (one
    per cluster size and layout, SR mode, width or tile); and one with the
    blocks the card runs at once in
    clusters of 1..8 (the library's ``*_capacity``,
    cudaOccupancyMaxActiveClusters, which the wrappers plan with through
    ``splitk.on_card``) beside the table ``kernels/splitk.py`` keeps as
    its CPU default.  Each tile's stages and shared memory must equal its
    table's and ``autotune.tile_smem_bytes``'s."""
    import re
    from repro_torch.kernels import autotune, splitk
    from repro_torch.kernels.build import load_library
    out = {}
    for tile in (splitk.Q8_TILE, splitk.DX_TILE, splitk.DW_TILE,
                 splitk.FWD_DECODE_TILE, splitk.FWD_DECODE_SR_TILE,
                 splitk.FWD_WIDE_TILE, splitk.FWD_WIDE_SR_TILE,
                 *splitk.PACKED_TILES.values()):
        lib, modes = tile.lib, splitk.SMEM_VARIANTS[tile.lib]
        log_text = built.get(lib, {}).get("log", "")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers",
                                           log_text)]
        smem = [int(x) for x in re.findall(r"(\d+) bytes smem", log_text)]
        spill = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                            log_text)]
        cfg = (ctypes.c_int * 8)()
        if lib in ("fused_qlhs_fwd",) + splitk.PACKED_LIBS:
            getattr(load_library(lib), lib + "_tile")(tile.mode, cfg)
        else:
            getattr(load_library(lib), lib + "_tile")(cfg)
        bm, bn, bk, threads, nacc, stages, dyn0, dyn1 = list(cfg)
        want = (autotune.tile_smem_bytes(tile, 0),
                autotune.tile_smem_bytes(tile, 1))
        check([bm, bn, bk, threads, nacc, stages] == [
            tile.bm, tile.bn, tile.bk, tile.threads, tile.nacc, tile.stages]
            and (dyn0, dyn1) == tile.smem == want,
            f"{tile.name}: {lib}_tile reports {list(cfg)}; the table "
            f"{tile}, tile_smem_bytes {want}")
        dyn = (f"{modes[0]} {dyn0} B / {modes[1]} {dyn1} B" if modes[0]
               else f"{dyn0} B")
        got = splitk.on_card(tile).capacity
        rec = dict(library=lib, tile=[bm, bn, bk], threads=threads,
                   stages=stages, dynamic_smem=[dyn0, dyn1],
                   kernels=len(regs), registers=regs, static_smem=smem,
                   spill_store_bytes=spill, cluster_capacity=list(got),
                   planned_capacity=list(tile.capacity))
        out[tile.name] = rec
        log(f"[build] {tile.name} ({lib}.cu, int8_mma.cuh): tile "
            f"{bm}x{bn}x{bk}, {threads} threads, {stages} stages, dynamic "
            f"smem {dyn}; ptxas over the library's {len(regs)} kernels: "
            f"registers {min(regs, default=0)}-{max(regs, default=0)}, "
            f"static smem {max(smem, default=0)} B, spill stores "
            f"{min(spill, default=0)}-{max(spill, default=0)} B")
        log(f"[build] {tile.name} blocks at once in clusters of 1..8: "
            f"queried {list(got)}; kernels/splitk.py table "
            f"{list(tile.capacity)}")
    return out


def quantize_sr_build(built) -> dict:
    """The SR quantizers' card numbers as their library reports them
    (``quantize_sr.on_card``: SMs, shared memory, and each kernel mode's
    blocks an SM by threads and registers, what the wrappers plan with)
    beside ``kernels/quantize_sr.py``'s H100 default, ``-Xptxas -v``'s
    registers and spills, and at every ``sr_shapes`` shape each plan
    beside the occupancy calculator's blocks an SM at its shared memory,
    which must equal the plan's model (a cooperative grid the model
    overcounts would be refused)."""
    import ctypes
    import re
    from repro_torch.kernels import quantize_sr as q
    from repro_torch.kernels.build import load_function
    text = built.get("quantize_sr", {}).get("log", "")
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", text)]
    spill = [int(v) for v in re.findall(r"(\d+) bytes spill stores", text)]
    card = q.on_card()
    log(f"[build] quantize_sr: card {card}; kernels/quantize_sr.py H100 "
        f"default {'equal' if card == q.H100 else q.H100}; ptxas over "
        f"{len(regs)} kernels: registers {regs}, spill stores {spill}")
    occ = load_function("quantize_sr", "quantize_sr_occupancy",
                        (ctypes.c_int, ctypes.c_int))
    plans = []
    for M, N in sr_shapes():
        for plan in (q.rows_plan(M, N, card), q.tensor_plan(M * N, card)):
            model = card.blocks_per_sm(plan.mode, plan.smem)
            got = occ(plan.mode, plan.smem)
            plans.append(dict(plan=str(plan), model=model, occupancy=got))
            check(model == got, f"quantize_sr plan {plan}: the model says "
                                f"{model} blocks an SM, the card {got}")
        log(f"[build] quantize_sr {(M, N)}: {plans[-2]['plan']}, "
            f"{plans[-1]['plan']}; blocks an SM {plans[-2]['occupancy']}, "
            f"{plans[-1]['occupancy']} (the model's too)")
    return dict(card=dataclasses.asdict(card), default_equal=card == q.H100,
                registers=regs, spill_store_bytes=spill, plans=plans)


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


def pool_operands(torch, gen, B, P, D, ragged=False, S=256):
    """kv_gather_pages's arguments as the paged engine holds them: a pool
    of ``1 + B * nb`` pages (nb * P = S, or 5 blocks when ragged) of
    quantized random rows, page 0 the garbage page, and block tables that
    give each lane its own pages, point its tail blocks at page 0 and, when
    ragged, repeat a page and zero some scales."""
    from repro_torch.core import kv_fresh_code, quantize_kv_rows
    nb = 5 if ragged else S // P
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


def fwd_shapes():
    """(M, K, N) of the int8 forward: every (K, N) of granite-3-2b's serving
    path at 1, 8 and 16 slots (the decode tile) and at 128 rows (a prefill
    bucket), statquant-tx's training forward at lm_head (512 tokens) and
    granite's (K, N) at 2048 tokens (the wide tile), a K off the 16-code
    grid, and ragged."""
    dec = [(m, k, n) for (k, n) in GRANITE_KN for m in (1, 8, 16, 128)]
    wide = [(512, 512, 10240), (512, 512, 512)] + [(2048, k, n)
                                                   for k, n in GRANITE_KN]
    return dec + wide + [(8, 1030, 200), (128, 1030, 200), (37, 130, 67),
                         (37, 67, 130)]


def kernel_vs_plain(torch, report) -> dict:
    from repro_torch.kernels import (fused_qlhs_matmul,
                                     fused_qlhs_matmul_plain,
                                     kv_dequant_rows, kv_dequant_rows_plain,
                                     kv_gather_pages, kv_gather_pages_plain)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows, worst = [], {"fused_qlhs_matmul": 0.0, "kv_dequant_rows": 0.0,
                       "kv_gather_pages": 0.0}

    def exact(name, shape, fn, plain, tag=""):
        got = fn()
        again = fn()
        ref = plain()
        torch.cuda.synchronize()
        same, repeat = torch.equal(got, ref), torch.equal(got, again)
        err = float((got - ref).abs().max())
        rows.append(dict(kernel=name, shape=list(shape), case=tag,
                         max_abs_err=err, bit_identical=same,
                         repeat_identical=repeat))
        log(f"[kernel] {name} {tuple(shape)}{' ' + tag if tag else ''} "
            f"bit-identical={same} repeat-identical={repeat}")
        check(bool(torch.isfinite(got).all()), f"{name} {shape}: non-finite")
        check(same, f"{name} {shape} {tag}: differs from plain by {err}")
        check(repeat, f"{name} {shape} {tag}: two calls differ")
        worst[name] = max(worst[name], err)

    # the int8 forward, deterministic (every shape; the original serving
    # set also against simulate) and SR (every third shape)
    for i, (M, K, N) in enumerate(fwd_shapes()):
        ops = qlhs_operands(torch, gen, M, K, N)
        exact("fused_qlhs_matmul", (M, K, N),
              lambda: fused_qlhs_matmul(*ops, bits=8),
              lambda: fused_qlhs_matmul_plain(*ops, bits=8), "deterministic")
        if i % 3 == 0:
            rb = torch.randint(0, 2 ** 32, (M, K), generator=gen,
                               device="cuda", dtype=torch.int64)
            sr = ops[:3] + (rb,) + ops[4:]
            exact("fused_qlhs_matmul", (M, K, N),
                  lambda: fused_qlhs_matmul(*sr, bits=8),
                  lambda: fused_qlhs_matmul_plain(*sr, bits=8), "SR")
        if (M in (1, 8, 128) and (K, N) in GRANITE_KN) or M == 37:
            gemm_vs_simulate(torch, gen, M, K, N, rows)
    forward_edge_cases(torch, gen, exact)
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
    kv_pairs_vs_plain(torch, gen, rows, worst)
    report["kernel_vs_plain"] = rows
    return worst


def kv_pair_operands(torch, gen, M, N, unaligned=False):
    """K and V of one dense cache layer, ``(codes, scale (M, 1), zero (M,
    1))`` each, a zero scale every 97th row; ``unaligned``: rows 1.. of
    M + 1, codes off the 16-byte grid."""
    sides = []
    for _ in range(2):
        c, s, z = kv_operands(torch, gen, M + unaligned, N)
        s[::97] = 0.0
        sides.append((c[unaligned:], s[unaligned:], z[unaligned:]))
    return sides


def pool_pair_operands(torch, gen, B, P, D, ragged=False, S=256):
    """K and V pools of one layer and their block table
    (``pool_operands``), ``S = nb * P`` positions a lane."""
    k = pool_operands(torch, gen, B, P, D, ragged, S)
    v = pool_operands(torch, gen, B, P, D, ragged, S)
    return k[:3], v[:3], k[3]


# the pair kernels' shapes: dense (M, N, codes off the 16-byte grid) and
# paged (B, P, D, ragged, positions a lane): the single kernels' shapes
# and 8 slots or lanes at granite's 4,096-token context
KV_PAIR_DENSE = [(2048, 512, False), (33, 130, False), (8, 40, True),
                 (32768, 512, False)]
KV_PAIR_PAGED = [(8, 16, 512, False, 256), (8, 8, 512, False, 256),
                 (8, 3, 40, True, 256), (3, 16, 512, True, 256),
                 (8, 16, 512, False, 4096)]
# the bodies of csrc/kv_dequant.cu and csrc/kv_gather.cu
KV_BODIES = {"bulk": 1, "element": 2}


def kv_pairs_vs_plain(torch, gen, rows, worst):
    """``kv_dequant_rows_kv`` and ``kv_gather_pages_kv`` (K and V in one
    launch, scales clamped) against their plain pairs, bit for bit and
    finite, at ``KV_PAIR_DENSE`` and ``KV_PAIR_PAGED``, each body the
    operands allow forced through the C entry too; a second call equals
    the first."""
    from repro_torch.kernels import (kv_dequant, kv_dequant_rows_kv,
                                     kv_dequant_rows_kv_plain, kv_gather,
                                     kv_gather_pages_kv,
                                     kv_gather_pages_kv_plain)

    def same_pair(name, shape, got, ref, tag):
        torch.cuda.synchronize()
        same = all(torch.equal(g, r) for g, r in zip(got, ref))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        rows.append(dict(kernel=name, shape=list(shape), case=tag,
                         max_abs_err=err, bit_identical=same))
        log(f"[kernel] {name} {tuple(shape)} {tag} bit-identical={same} "
            f"finite={finite}")
        check(finite, f"{name} {shape} {tag}: non-finite output")
        check(same, f"{name} {shape} {tag}: differs from plain by {err}")
        worst[name] = max(worst.get(name, 0.0), err)

    for M, N, unaligned in KV_PAIR_DENSE:
        k, v = kv_pair_operands(torch, gen, M, N, unaligned)
        ref = kv_dequant_rows_kv_plain(k, v)
        got = kv_dequant_rows_kv(k, v)
        same_pair("kv_dequant_rows_kv", (M, N), got, ref, "planned")
        same_pair("kv_dequant_rows_kv", (M, N), kv_dequant_rows_kv(k, v),
                  got, "second call")
        whole = N % 16 == 0 and not unaligned
        for body, b in KV_BODIES.items():
            if whole or body == "element":
                same_pair("kv_dequant_rows_kv", (M, N), kv_dequant._launch(
                    "kv_dequant_rows_kv", [k, v], M, N, 8, 1, b), ref, body)
        del k, v, ref, got
    for B, P, D, ragged, S in KV_PAIR_PAGED:
        k, v, table = pool_pair_operands(torch, gen, B, P, D, ragged, S)
        shape = (B, table.shape[1] * P, D)
        ref = kv_gather_pages_kv_plain(k, v, table)
        got = kv_gather_pages_kv(k, v, table)
        tag = f"P={P}{' ragged' if ragged else ''}"
        same_pair("kv_gather_pages_kv", shape, got, ref, tag)
        same_pair("kv_gather_pages_kv", shape, kv_gather_pages_kv(k, v, table),
                  got, tag + " second call")
        for body, b in KV_BODIES.items():
            if body == "element" or (D % 16 == 0 and P % 4 == 0):
                same_pair("kv_gather_pages_kv", shape, kv_gather._launch(
                    "kv_gather_pages_kv", [k, v], table, 8, b), ref,
                    f"{tag} {body}")
        del k, v, ref, got
    torch.cuda.empty_cache()


def forward_edge_cases(torch, gen, exact) -> None:
    """The int8 forward on LHS rows off the 16-byte grid (row views with K
    = 67 and 130) at 8 and 128 rows, and at K = 8192 with weight codes over
    all of -128..127 (rows at the extremes) against LHS rows clipped to
    each end of the code range: the int32 accumulator's worst case, across
    the split-K reduction."""
    from repro_torch.kernels import fused_qlhs_matmul, fused_qlhs_matmul_plain
    dev = gen.device
    for M in (8, 128):
        for (K, N) in [(67, 130), (130, 72)]:
            x, s, z, _, w8, ab, bb, u = qlhs_operands(torch, gen, M + 1, K,
                                                      N)
            ops = (x[1:], s[1:].contiguous(), z[1:].contiguous(), None, w8,
                   ab, bb, u)
            exact("fused_qlhs_matmul", (M, K, N),
                  lambda: fused_qlhs_matmul(*ops, bits=8),
                  lambda: fused_qlhs_matmul_plain(*ops, bits=8),
                  "unaligned rows")
        K, N = 8192, 2048
        x, s, z, _, _, ab, bb, _ = qlhs_operands(torch, gen, M, K, N)
        s, z = s.clone(), z.clone()
        s[0], z[0] = 1e3, x[0].max() + 1.0     # every code -128
        s[1], z[1] = 1e3, x[1].min() - 1.0     # every code 127
        w8 = torch.randint(-128, 128, (N, K), generator=gen, device=dev,
                           dtype=torch.int8)
        w8[0], w8[1], w8[2] = -128, 127, -128
        w8 = w8.T.contiguous()
        u = ab * w8.to(torch.int32).sum(0).to(torch.float32) + float(K) * bb
        ops = (x, s, z, None, w8, ab, bb, u)
        exact("fused_qlhs_matmul", (M, K, N),
              lambda: fused_qlhs_matmul(*ops, bits=8),
              lambda: fused_qlhs_matmul_plain(*ops, bits=8),
              "full-range codes")


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
    """The training kernels against their plain versions on the card, bit
    for bit and a second call bit-identical to the first, at every shape
    of ``train_shapes`` (dW at both 5- and 8-bit dY, and at the ragged
    shapes of tests/test_torch_gpu.py), plus the edge cases."""
    from repro_torch.kernels import (fused_qboth_tn_matmul,
                                     fused_qboth_tn_matmul_plain,
                                     fused_qlhs_matmul,
                                     fused_qlhs_matmul_plain, q8_matmul,
                                     q8_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(4321)
    dx, dw = train_shapes()
    rows = []
    worst = {"fused_qlhs_matmul_dx": 0.0, "q8_matmul": 0.0,
             "fused_qboth_tn_matmul": 0.0, "quantize_sr_rows": 0.0,
             "quantize_sr_tensor": 0.0}

    def exact(name, shape, fn, plain, tag=""):
        """A kernel against its plain version bit for bit, and a second
        call bit-identical to the first."""
        got = fn()
        again = fn()
        ref = plain()
        torch.cuda.synchronize()
        same, repeat = torch.equal(got, ref), torch.equal(got, again)
        err = float((got - ref).abs().max())
        rows.append(dict(kernel=name, shape=list(shape), case=tag,
                         max_abs_err=err, bit_identical=same,
                         repeat_identical=repeat))
        log(f"[kernel] {name} {tuple(shape)}{' ' + tag if tag else ''} "
            f"bit-identical={same} repeat-identical={repeat}")
        check(same, f"{name} {shape} {tag}: differs from plain by {err}")
        check(repeat, f"{name} {shape} {tag}: two calls differ")
        worst[name] = max(worst[name], err)

    # the dX GEMMs, a K off the 16-code grid at a multi-slice split
    for i, (M, K, N) in enumerate(dx + [(256, 1030, 200)]):
        bits = 8 if i % 3 else 4
        ops = dx_operands(torch, gen, M, K, N, bits)
        exact("fused_qlhs_matmul_dx", (M, K, N),
              lambda: fused_qlhs_matmul(*ops, bits=bits, trans_b=True),
              lambda: fused_qlhs_matmul_plain(*ops, bits=bits, trans_b=True),
              f"SR {bits}-bit")
        det = ops[:3] + (None,) + ops[4:]
        exact("fused_qlhs_matmul_dx", (M, K, N),
              lambda: fused_qlhs_matmul(*det, bits=bits, trans_b=True),
              lambda: fused_qlhs_matmul_plain(*det, bits=bits, trans_b=True),
              f"deterministic {bits}-bit")
        ops = q8_operands(torch, gen, M, K, N)
        exact("q8_matmul", (M, K, N), lambda: q8_matmul(*ops),
              lambda: q8_matmul_plain(*ops), "K-major B")
        nmaj = (ops[0], ops[1].contiguous()) + ops[2:]
        exact("q8_matmul", (M, K, N), lambda: q8_matmul(*nmaj),
              lambda: q8_matmul_plain(*nmaj), "N-major B")
    redesign_edge_cases(torch, gen, exact)
    for (K, M, N) in dw + [(130, 33, 67), (64, 1, 49), (5, 3, 3)]:
        for bits_b in (5, 8):
            ops = dw_operands(torch, gen, K, M, N, bits_b)
            exact("fused_qboth_tn_matmul", (K, M, N),
                  lambda: fused_qboth_tn_matmul(*ops, bits_a=8,
                                                bits_b=bits_b),
                  lambda: fused_qboth_tn_matmul_plain(*ops, bits_a=8,
                                                      bits_b=bits_b),
                  f"{bits_b}-bit dY")
    dw_edge_cases(torch, gen, exact)
    # the unfused step's forward (M tokens, d_in, d_out; B row-major) and
    # dW (d_in, M tokens, d_out; A a transposed copy) GEMMs
    for (M, K, N) in unfused_q8_shapes():
        ops = q8_unfused_operands(torch, gen, M, K, N)
        exact("q8_matmul", (M, K, N), lambda: q8_matmul(*ops),
              lambda: q8_matmul_plain(*ops), "unfused roles")
    report["sr_device_kernels_per_call"] = sr_kernels_vs_plain(
        torch, gen, rows, worst)
    report["train_kernel_vs_plain"] = rows
    return worst


def sr_rows_plans(M, N, card):
    """Every plan of quantize_sr_rows at (M, N) the C entry can be forced
    to: the row held in registers where it fits, and each cluster size
    with the row's share staged whole, a third of it, and not at all
    (read twice)."""
    from repro_torch.kernels import quantize_sr as q
    if N <= q.REG_ROW:
        yield q.RowsPlan(M, N, 1, q._span(N, 1), 0, 0, regs=True)
    for c in (1, 2, 4, 8):
        span = q._span(N, c)
        for stage in sorted({0, span + 4, max(4, span // 12 * 4)}):
            smem = q.stage_bytes(stage)
            mode = q.rows_mode(c, stage < span + 4)
            if smem + card.static_smem[mode] <= card.smem_per_block:
                yield q.RowsPlan(M, N, c, span, stage, smem)


def sr_tensor_plans(n, card):
    """Plans of quantize_sr_tensor over n elements: the planned grid, 7
    blocks, one an SM and the card's resident grid (and one block up to 6
    M elements), each chunk staged whole where the blocks' shared memory
    holds it, as far as it reaches, an eighth of it, and not at all."""
    from repro_torch.kernels import quantize_sr as q
    grids = {q.tensor_plan(n, card).grid, 7, card.sms,
             card.sms * min(card.blocks[q.TENSOR:])}
    if n <= 6_000_000:
        grids.add(1)
    for g in sorted(grids):
        chunk, per = q._span(n, g), -(-g // card.sms)
        most = min(chunk + 4, card.stage_for(q.TENSOR + 1, per))
        for stage in sorted({0, most, min(most, max(4, chunk // 32 * 4))}):
            plan = q.TensorPlan(n, g, chunk, stage, q.stage_bytes(stage))
            if card.blocks_per_sm(plan.mode, plan.smem) >= per:
                yield plan


def sr_kernels_vs_plain(torch, gen, rows, worst) -> dict:
    """quantize_sr_rows and quantize_sr_tensor against their plain versions,
    codes, scale and zero bit for bit and a second call bit-identical to
    the first: the wrappers at every ``sr_shapes`` shape and at widths off
    the 4-code grid, and every plan of ``sr_rows_plans`` /
    ``sr_tensor_plans`` forced through the C entries there, also on row
    views off the 16-byte grid (the tensor minus its first row); then a
    constant tensor (scale B / 1e-12), one whose only values are -0.0 and
    +0.0, and one whose extremes are its last two elements (the last
    chunk, the last block), at 4 and 8 bits.  The sign of a zero ``zero``
    is not held: ``torch.amin`` over -0.0 and +0.0 returns either, by the
    order it reduces in.  Then the device kernels a call of each wrapper
    at the timed shapes (``SR_TIMED``), which must be one: the range is
    reduced in the same launch.  Returns those counts."""
    from repro_torch.kernels import quantize_sr as q
    card = q.on_card()

    def same(got, ref):
        return all(g.shape == r.shape and torch.equal(g, r)
                   for g, r in zip(got, ref))

    def exact3(name, shape, fn, ref, tag):
        got, again = fn(), fn()
        torch.cuda.synchronize()
        ok, repeat = same(got, ref), same(got, again)
        err = max(float((g.float() - r.float()).abs().max())
                  for g, r in zip(got, ref))
        rows.append(dict(kernel=name, shape=list(shape), case=tag,
                         max_abs_err=err, bit_identical=ok,
                         repeat_identical=repeat))
        check(ok, f"{name} {shape} {tag}: differs from plain by {err}")
        check(repeat, f"{name} {shape} {tag}: two calls differ")
        worst[name] = max(worst[name], err)

    shapes = sr_shapes() + [(64, 4099), (7, 8191), (5, 40003), (3, 140001)]
    for i, (M, N) in enumerate(shapes):
        bits = 8 if i % 3 else 4
        x, rb = sr_operands(torch, gen, M, N)
        views = [("", x, rb)]
        if M > 1 and M * N < 30_000_000:
            views.append(("rows off the 16-byte grid", x[1:], rb[1:]))
        forced = 0
        for vtag, xv, rv in views:
            Mv = xv.shape[0]
            ref_r = q.quantize_sr_rows_plain(xv, rv, bits)
            ref_t = q.quantize_sr_tensor_plain(xv, rv, bits)
            for name, fn, ref in (
                    ("quantize_sr_rows", q.quantize_sr_rows, ref_r),
                    ("quantize_sr_tensor", q.quantize_sr_tensor, ref_t)):
                exact3(name, (Mv, N), lambda: fn(xv, rv, bits), ref,
                       f"{bits}-bit {vtag}")
            for plan in sr_rows_plans(Mv, N, card):
                exact3("quantize_sr_rows", (Mv, N),
                       lambda: q._rows_launch(xv, rv, bits, plan), ref_r,
                       f"{bits}-bit {vtag} forced {plan}")
                forced += 1
            for plan in sr_tensor_plans(Mv * N, card):
                exact3("quantize_sr_tensor", (Mv, N),
                       lambda: q._tensor_launch(xv, rv, bits, plan), ref_t,
                       f"{bits}-bit {vtag} forced {plan}")
                forced += 1
        log(f"[kernel] quantize_sr_rows/_tensor {(M, N)} bits={bits}: "
            f"codes, scale, zero bit-identical to plain, twice, through "
            f"the wrappers and {forced} forced plans"
            + (", also on rows off the 16-byte grid" if len(views) > 1
               else ""))
        del x, rb, views
        torch.cuda.empty_cache()
    for tag, make in (
            ("constant", lambda x: torch.full_like(x, 0.25)),
            ("only -0.0 and +0.0", lambda x: torch.where(
                x < 0, torch.zeros_like(x).neg_(), torch.zeros_like(x))),
            ("extremes last", None)):
        for M, N in ((512, 10240), (2048, 8192), (33, 130)):
            x, rb = sr_operands(torch, gen, M, N)
            if make is None:
                x[-1, -1], x[-1, -2] = 1.0, -1.0
            else:
                x = make(x)
            for bits in (4, 8):
                for name, fn, plain in (
                        ("quantize_sr_rows", q.quantize_sr_rows,
                         q.quantize_sr_rows_plain),
                        ("quantize_sr_tensor", q.quantize_sr_tensor,
                         q.quantize_sr_tensor_plain)):
                    exact3(name, (M, N), lambda: fn(x, rb, bits),
                           plain(x, rb, bits), f"{tag}, {bits}-bit")
        log(f"[kernel] quantize_sr_rows/_tensor {tag} at (512, 10240), "
            f"(2048, 8192), (33, 130), 4 and 8 bits: bit-identical, twice")
    per_call = {}
    for M, N in SR_TIMED:
        x, rb = sr_operands(torch, gen, M, N)
        for name, fn in (("quantize_sr_rows", q.quantize_sr_rows),
                         ("quantize_sr_tensor", q.quantize_sr_tensor)):
            n = _kernels_per_call(torch, lambda: fn(x, rb, 8))
            per_call[f"{name} {(M, N)}"] = n
            check(n == 1, f"{name} {(M, N)}: {n} device kernels a call")
        del x, rb
    log(f"[kernel] quantize_sr device kernels a call (torch.profiler): "
        f"{per_call}")
    return per_call


def redesign_edge_cases(torch, gen, exact) -> None:
    """The int8 tensor-core kernels on rows off the 16-byte grid (row views
    of a larger matrix with K = 67 or 130), and on codes over all of
    -128..127 at K = 10,240, with rows and columns at the extremes: the
    int32 accumulator's worst case, across the split-K reduction."""
    from repro_torch.kernels import (fused_qlhs_matmul,
                                     fused_qlhs_matmul_plain, q8_matmul,
                                     q8_matmul_plain)
    dev = gen.device
    for (M, K, N) in [(33, 67, 130), (40, 130, 72)]:
        g, s, z, rb, w8, ab, bb, u = dx_operands(torch, gen, M + 1, K, N, 8)
        ops = (g[1:], s[1:].contiguous(), z[1:].contiguous(), rb[1:], w8, ab,
               bb, u)
        exact("fused_qlhs_matmul_dx", (M, K, N),
              lambda: fused_qlhs_matmul(*ops, bits=8, trans_b=True),
              lambda: fused_qlhs_matmul_plain(*ops, bits=8, trans_b=True),
              "unaligned rows")
        q = q8_operands(torch, gen, M + 1, K, N)
        x8 = q[0][1:]
        vec = (q[2][1:].contiguous(),) + q[3:4] + (q[4][1:].contiguous(),) \
            + q[5:6] + (q[6][1:].contiguous(),) + q[7:]
        exact("q8_matmul", (M, K, N), lambda: q8_matmul(x8, q[1], *vec),
              lambda: q8_matmul_plain(x8, q[1], *vec), "unaligned rows")

    def full_range(shape):
        c = torch.randint(-128, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        c[0], c[1], c[2] = -128, 127, -128
        return c

    M, K, N = 512, 10240, 512
    x8, w8 = full_range((M, K)), full_range((N, K))
    vec = [torch.randn(n, generator=gen, device=dev)
           for n in (M, N, M, N, M, N)]
    for tag, y8 in (("K-major B", w8.T), ("N-major B", w8.T.contiguous())):
        exact("q8_matmul", (M, K, N), lambda: q8_matmul(x8, y8, *vec),
              lambda: q8_matmul_plain(x8, y8, *vec),
              f"full-range codes, {tag}")
    for bits in (8, 4):
        g, s, z, rb, _, ab, bb, _ = dx_operands(torch, gen, M, K, N, bits)
        s, z = s.clone(), z.clone()
        s[0], z[0] = 1e3, g[0].max() + 1.0     # every code -2^(b-1)
        s[1], z[1] = 1e3, g[1].min() - 1.0     # every code 2^(b-1) - 1
        u = ab * w8.to(torch.int32).sum(1).to(torch.float32) + float(K) * bb
        ops = (g, s, z, rb, w8, ab, bb, u)
        exact("fused_qlhs_matmul_dx", (M, K, N),
              lambda: fused_qlhs_matmul(*ops, bits=bits, trans_b=True),
              lambda: fused_qlhs_matmul_plain(*ops, bits=bits, trans_b=True),
              f"full-range codes, SR {bits}-bit")


def dw_edge_cases(torch, gen, exact) -> None:
    """dW at K = 8192 tokens (M = N = 512) with columns of X and dY at the
    ends of their ranges (every code -2^(b-1) or 2^(b-1) - 1) beside
    random ones, at 5- and 8-bit dY; then at widths of 67 and 130 on
    tensors whose first element is off the 16-byte grid, so no row is
    aligned."""
    from repro_torch.core.backend import dw_operands as ops_of
    from repro_torch.kernels import (fused_qboth_tn_matmul,
                                     fused_qboth_tn_matmul_plain)
    dev = gen.device
    K, M, N = 8192, 512, 512
    x = torch.randn(K, M, generator=gen, device=dev)
    g = torch.randn(K, N, generator=gen, device=dev) * 1e-3
    x[:, 0], x[:, 1] = x.min(), x.max()
    g[:, 0], g[:, 1] = g.min(), g.max()
    rb = torch.randint(0, 2 ** 32, (K, N), generator=gen, device=dev,
                       dtype=torch.int64)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        return buf[1:].view(t.shape).copy_(t)

    for tag, xs, gs, rs in (
            ("full-range codes", x, g, rb),
            ("unaligned rows", shifted(x[:, :67]), shifted(g[:, :130]),
             shifted(rb[:, :130]))):
        zx, hx = torch.aminmax(xs)
        sx = 255.0 / torch.clamp_min(hx - zx, 1e-12)
        for bits_b in (5, 8):
            ops = ops_of(xs, sx, zx, 8, gs, rs, bits_b)
            exact("fused_qboth_tn_matmul", (K,) + tuple(ops[7].shape)
                  + (gs.shape[1],),
                  lambda: fused_qboth_tn_matmul(*ops, bits_a=8,
                                                bits_b=bits_b),
                  lambda: fused_qboth_tn_matmul_plain(*ops, bits_a=8,
                                                      bits_b=bits_b),
                  f"{tag}, {bits_b}-bit dY")


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


def packed_operands(torch, gen, M, K, N, wbits):
    """Both packed kernels' arguments as core/backend builds them on the
    serving path, from random activations and a weight quantized and
    packed at ``wbits`` (``ptq_det``, or the ``binary`` sign plane at 1
    bit): ``fused_qlhs_packed_matmul``'s (as ``fused_fqt_fwd``), then
    ``packed_matmul``'s (as ``_packed_gemm``), then the PackedTensor."""
    from repro_torch.core import (QuantizerSpec, affine_factors,
                                  epilogue_coeffs, get_quantizer,
                                  quantize_ptq_det)
    from repro_torch.core.backend import _ptq_range
    from repro_torch.kernels import pack_qtensor
    dev = gen.device
    x = torch.randn(M, K, generator=gen, device=dev)
    w = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
    if wbits == 1:
        pt = get_quantizer("binary").quantize(
            w, None, QuantizerSpec.of("binary"), backend="kernel")
    else:
        pt = pack_qtensor(quantize_ptq_det(w, wbits))
    ab, bb = affine_factors(pt.scale, pt.zero, wbits)
    u = ab * pt.colsum.to(torch.float32) + float(K) * bb
    zero, scale = _ptq_range(x, 8)
    sa = scale.reshape(1, 1).expand(M, 1).contiguous()
    za = zero.reshape(1, 1).expand(M, 1).contiguous()
    aq = quantize_ptq_det(x, 8)
    a8 = aq.int8_codes
    aa, ba = affine_factors(aq.scale, aq.zero, 8)
    coeffs = epilogue_coeffs(a8, aa, ba, None, ab, bb, colsum=pt.colsum)
    return ((x, sa, za, pt.packed, ab, bb, u),
            (a8, pt.packed) + tuple(c.contiguous() for c in coeffs), pt)


def packed_kernel_vs_plain(torch, report) -> dict:
    """Both packed kernels against their plain versions on the card, bit
    for bit, at every (K, N) of granite's serving path for M in {8, 128}
    and ragged, at 1, 2, 4 and 8 bits; at 8 bits the packed forward also
    against ``fused_qlhs_matmul`` on the same codes; and at every split of
    K each tile takes, at each width."""
    from repro_torch.kernels import (fused_qlhs_matmul,
                                     fused_qlhs_packed_matmul,
                                     fused_qlhs_packed_matmul_plain,
                                     packed_matmul, packed_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(2468)
    rows = []
    worst = {"fused_qlhs_packed_matmul": 0.0, "packed_matmul": 0.0}
    shapes = [(m, k, n) for (k, n) in GRANITE_KN for m in (8, 128)]
    shapes += [(33, 67, 130), (1, 130, 49)]
    for wbits in (1, 2, 4, 8):
        for (M, K, N) in shapes:
            fused, unfused, pt = packed_operands(torch, gen, M, K, N, wbits)
            outs = {}
            for name, kern, plain, args, kw in (
                    ("fused_qlhs_packed_matmul", fused_qlhs_packed_matmul,
                     fused_qlhs_packed_matmul_plain, fused,
                     dict(bits=8, wbits=wbits)),
                    ("packed_matmul", packed_matmul, packed_matmul_plain,
                     unfused, dict(wbits=wbits, kdim=K))):
                got, ref = kern(*args, **kw), plain(*args, **kw)
                torch.cuda.synchronize()
                same = torch.equal(got, ref)
                err = float((got - ref).abs().max())
                check(bool(torch.isfinite(got).all()),
                      f"{name} {(M, K, N)} w{wbits}: non-finite output")
                check(same, f"{name} {(M, K, N)} w{wbits}: differs from "
                            f"plain by {err}")
                rows.append(dict(kernel=name, shape=[M, K, N], wbits=wbits,
                                 max_abs_err=err, bit_identical=same))
                worst[name] = max(worst[name], err)
                outs[name] = got
            line = (f"[kernel] packed w{wbits} {(M, K, N)}: "
                    f"fused_qlhs_packed_matmul and packed_matmul "
                    f"bit-identical to plain")
            if wbits == 8:
                x, sa, za, _, ab, bb, u = fused
                q = fused_qlhs_matmul(x, sa, za, None, pt.int8_codes, ab, bb,
                                      u, bits=8)
                torch.cuda.synchronize()
                same8 = torch.equal(outs["fused_qlhs_packed_matmul"], q)
                check(same8, f"fused_qlhs_packed_matmul {(M, K, N)} w8 "
                             f"differs from fused_qlhs_matmul on the same "
                             f"codes")
                rows[-2]["equals_fused_qlhs_matmul"] = same8
                line += "; w8 fused == fused_qlhs_matmul"
            log(line)
    # every split of K each tile takes, forced through the C entries, at
    # the decode tile's MLP up-projection and a wide tile's ragged shape
    from repro_torch.kernels import splitk
    from repro_torch.kernels.build import load_function
    stream = torch.cuda.current_stream().cuda_stream
    for wbits in (1, 2, 4, 8):
        for (M, K, N) in ((8, 2048, 8192), (40, 1001, 300)):
            for name, lib, ref, call in _packed_calls(torch, gen, M, K, N,
                                                      wbits, stream):
                tile = splitk.packed_tile(lib, M, wbits)
                fn = load_function(lib, lib, _packed_argtypes(lib))
                steps = -(-K // tile.bk)
                splits = []
                for s in range(1, 9):
                    per = -(-steps // s)
                    if -(-steps // per) != s:
                        continue
                    out = torch.full_like(ref, float("nan"))
                    check(call(fn, out, tile.mode, s, per * tile.bk) == 0,
                          f"{tile.name} split {s}: launch failed")
                    torch.cuda.synchronize()
                    check(torch.equal(out, ref), f"{tile.name} {(M, K, N)} "
                                                 f"split {s}: differs")
                    splits.append(s)
                log(f"[kernel] {tile.name} {(M, K, N)}: splits {splits} "
                    f"each bit-identical to plain")
    report["packed_kernel_vs_plain"] = rows
    return worst


# ---------------------------------------------------------------------------
# the main path: serving
# ---------------------------------------------------------------------------

def _kernel_wrappers():
    from repro_torch import kernels
    return (kernels.fused_qlhs_matmul, kernels.kv_dequant_rows,
            kernels.q8_matmul, kernels.fused_qboth_tn_matmul,
            kernels.kv_gather_pages, kernels.quantize_sr_rows,
            kernels.quantize_sr_tensor, kernels.fused_qlhs_packed_matmul,
            kernels.packed_matmul, kernels.kv_dequant_rows_kv,
            kernels.kv_gather_pages_kv)


def _reset_counts():
    """Every kernel's launch count to 0."""
    for fn in _kernel_wrappers():
        fn.launches = 0
    _kernel_wrappers()[0].launches_dx = 0


def _read_counts():
    """Launches by kernel (and mode) since the last reset."""
    (qlhs, kv, q8, qboth, gather, sr_rows, sr_tensor, qlhs_packed,
     packed, kv_pair, gather_pair) = _kernel_wrappers()
    return {"fused_qlhs_matmul": qlhs.launches - qlhs.launches_dx,
            "fused_qlhs_matmul_dx": qlhs.launches_dx,
            "kv_dequant_rows": kv.launches, "q8_matmul": q8.launches,
            "fused_qboth_tn_matmul": qboth.launches,
            "kv_gather_pages": gather.launches,
            "quantize_sr_rows": sr_rows.launches,
            "quantize_sr_tensor": sr_tensor.launches,
            "fused_qlhs_packed_matmul": qlhs_packed.launches,
            "packed_matmul": packed.launches,
            "kv_dequant_rows_kv": kv_pair.launches,
            "kv_gather_pages_kv": gather_pair.launches}


def _check_counts(counts, want, tag):
    """The path's kernels launched exactly as often as it implies; the
    others not at all."""
    for name, n in counts.items():
        w = want.get(name, 0)
        if w:
            check(n > 0, f"{tag}: {name} never launched on the main path")
        check(n == w, f"{tag}: {name} launched {n} times, the path implies "
                      f"{w}")


def _prefill_logits(torch, model, params, prompt, backend, policy=None):
    """Prefill logits of one prompt, padded as the engine pads it (token 0
    up to the power-of-two bucket), under ``policy`` or else
    ``QuantPolicy.qat`` on ``backend``, or unquantized for
    ``backend="exact"``."""
    from repro_torch.core import QuantPolicy
    if policy is None:
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
    (gelu, relu2) or three (swiglu) projections per layer (a MoE layer:
    its router and every expert's projections), and lm_head.  The hybrid:
    5 projections a Mamba2 layer, and after each of its outer blocks the
    fuse and the shared block's attention and MLP; RWKV6: 8 a layer (r, k,
    v, g, o and the channel mix's 3); the encoder-decoder: 6 an encoder
    layer, 10 a decoder layer (the self-attention's 4, the
    cross-attention's k and v of the encoder output and its q and o, the
    MLP's 2)."""
    mlp = 3 if cfg.act == "swiglu" else 2
    if cfg.family == "audio":
        return cfg.enc_layers * (4 + mlp) + cfg.n_layers * (8 + mlp) + 1
    if cfg.family == "hybrid":
        n_outer = cfg.n_layers // cfg.hybrid_period
        return cfg.n_layers * 5 + n_outer * (1 + 4 + mlp) + 1
    if cfg.ssm_kind == "rwkv6":
        return cfg.n_layers * 8 + 1
    ffn = 1 + cfg.moe_experts * mlp if cfg.moe_experts else mlp
    return cfg.n_layers * (4 + ffn) + 1


def _decode_gemms(cfg) -> int:
    """Quantized GEMMs in one decode step: a forward's, but the
    encoder-decoder's step runs no encoder and reads the cross-attention's
    K and V from its cache (6 + the MLP's a decoder layer, and lm_head)."""
    if cfg.family == "audio":
        return cfg.n_layers * (6 + (3 if cfg.act == "swiglu" else 2)) + 1
    return _gemms_per_forward(cfg)


def _gemms_vs_simulate(torch, run, n, tag, sim=None):
    """``run()``, one forward through the kernels, with every quantized
    GEMM of the layers and lm_head re-run on ``sim`` (default
    ``QuantPolicy.qat`` on ``simulate``) from the very input the kernel
    path gave it, as the forward goes: each within rtol 1e-3 / atol 5e-3,
    and ``n`` of them.  Returns (``run()``'s result, the largest
    max|d|)."""
    import repro_torch.layers.common as common
    import repro_torch.layers.embeddings as embeddings
    from repro_torch.core import QuantPolicy, fqt_matmul
    sim = sim or QuantPolicy.qat(backend="simulate")
    seen = {"n": 0, "worst": 0.0}

    def spy(x, w, key, policy, path=""):
        y = fqt_matmul(x, w, key, policy, path=path)
        ref = fqt_matmul(x, w, None, sim, path=path)
        d = float((y - ref).abs().max())
        check(within_tol(y, ref),
              f"{tag}: GEMM {seen['n']} ({path}, x {tuple(x.shape)}) kernel "
              f"vs simulate differ by {d} beyond rtol {RTOL}/atol {ATOL}")
        seen["n"] += 1
        seen["worst"] = max(seen["worst"], d)
        return y

    saved = common.fqt_matmul, embeddings.fqt_matmul
    common.fqt_matmul = embeddings.fqt_matmul = spy
    try:
        with torch.no_grad():
            out = run()
    finally:
        common.fqt_matmul, embeddings.fqt_matmul = saved
    check(seen["n"] == n, f"{tag}: {seen['n']} quantized GEMMs in one "
                          f"forward, the path implies {n}")
    return out, seen["worst"]


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
    from repro_torch.models import build_model
    model = build_model(cfg)
    n = _gemms_per_forward(cfg)
    a, worst = _gemms_vs_simulate(
        torch, lambda: _prefill_logits(torch, model, params, prompt,
                                       "kernel"), n, tag)
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
                                     kv_dequant_rows_kv_plain,
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
    saved = (backend.fused_qlhs_matmul, kv_cache.kv_dequant_rows,
             kv_cache.kv_dequant_rows_kv)
    backend.fused_qlhs_matmul = fused_qlhs_matmul_plain
    kv_cache.kv_dequant_rows = kv_dequant_rows_plain
    kv_cache.kv_dequant_rows_kv = kv_dequant_rows_kv_plain
    try:
        tok_p, log_p = run()
    finally:
        (backend.fused_qlhs_matmul, kv_cache.kv_dequant_rows,
         kv_cache.kv_dequant_rows_kv) = saved
    err = max(float((a - b).abs().max()) for a, b in zip(log_k, log_p))
    scale = max(float(b.abs().max()) for b in log_p)
    log(f"[{tag}] kernels vs plain versions through the whole serving path: "
        f"tokens equal={tok_k == tok_p}, prefill logits max|d|={err:.3g}")
    check(tok_k == tok_p, f"{tag}: tokens through the kernels differ from "
                          f"the plain path: {tok_k} vs {tok_p}")
    check(err <= KERNEL_TOL * scale, f"{tag}: logits through the kernels "
                                     f"differ from the plain path by {err}")
    return err


# the KV reads' kernels in a profiled decode step (both trees' names), and
# the clamps the dense read launched before them
KV_SHARE = ("kv_dequant", "kv_gather", "aten::clamp_min")


def _profile_decode(torch, eng, what="dense", share=None):
    """One full-batch granite decode step, profiled by ``_profile``."""
    B = eng.slots
    cache = eng.model.init_cache_quant(eng.cfg, B, eng.max_seq, device="cuda")
    tok = torch.ones((B, 1), dtype=torch.int64, device="cuda")
    pos = torch.full((B,), eng.max_seq // 2, dtype=torch.int64, device="cuda")
    step = lambda: eng.model.decode(eng.params, cache, {"tokens": tok},  # noqa: E731
                                    eng.policy, positions=pos, kv_quant=True)
    return _profile(torch, step, f"one decode step ({B} slots, {what})",
                    share)


def _wall_ms(torch, step):
    """``step``'s wall time in ms: the median of 5 runs after one, and the
    5."""
    import numpy as np
    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls)), walls


# the names torch.profiler leaves out of its tables
_UNLISTED_EVENTS = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"))


def _event_averages(torch, prof) -> list:
    """The rows of ``prof.key_averages()`` (key, count, device type,
    user annotation, and in µs the self CPU, self device and device
    totals), computed from the profile's raw events: each kernel goes to
    the op whose correlation id it carries, a runtime call such as
    ``cudaLaunchKernel`` to that op's thread, ops nest by their intervals
    on each thread, and an op that is the only child of an op of its name
    merges into it, as in torch's own tree.  ``key_averages`` builds a
    Python object per event and spent up to 43 s on one profile of the
    MoE phases; this walk, with the cyclic collector paused, a small share
    of that."""
    import gc
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    demangled = {}
    gc_was = gc.isenabled()
    gc.disable()
    try:
        ev = []          # [name, device, annotation, sync, thread, t0, t1]
        ops, linked = {}, []
        for e in prof.profiler.kineto_results.events():
            n = e.name()
            if n in _UNLISTED_EVENTS or e.is_hidden_event():
                continue
            d = demangled.get(n)
            if d is None:
                d = demangled[n] = (torch._C._demangle(n) if len(n) > 1
                                    else n)
            dev = e.device_type()
            tid = e.start_thread_id()
            sync = not e.is_async() and tid == e.end_thread_id()
            i = len(ev)
            ev.append([d, dev, e.is_user_annotation(), sync, tid,
                       e.start_ns(), e.end_ns()])
            link = e.linked_correlation_id()
            if link > 0:
                linked.append((i, link))
            elif dev == cpu and sync:
                ops.setdefault(e.correlation_id(), []).append(i)
        own = {}         # op -> its own kernels' µs
        for i, link in linked:
            for j in ops.get(link, ()):
                r = ev[i]
                if r[1] == cuda:
                    own[j] = own.get(j, 0.0) + (r[6] - r[5]) / 1e3
                elif r[1] == cpu:
                    r[4] = ev[j][4]
        tree = sorted((i for i, r in enumerate(ev) if r[1] == cpu and r[3]),
                      key=lambda i: (ev[i][4], ev[i][5], -ev[i][6]))
        parent, children, stack = {}, {}, []
        for i in tree:
            r = ev[i]
            if stack and ev[stack[-1]][4] != r[4]:
                stack = []
            while stack:
                p = stack[-1]
                if r[5] >= ev[p][6] or r[6] > ev[p][6]:
                    stack.pop()
                else:
                    children.setdefault(p, []).append(i)
                    parent[i] = p
                    break
            stack.append(i)
        gone = set()
        while True:
            merged = []
            for i in sorted(parent):
                if i in gone:
                    continue
                p = parent[i]
                if ev[p][0] == ev[i][0] and len(children.get(p, ())) == 1:
                    kids = children.get(i, [])
                    children[p] = kids
                    if i in own:
                        own[p] = own[i]
                    else:
                        own.pop(p, None)
                    for c in kids:
                        parent[c] = p
                    merged.append(i)
            if not merged:
                break
            gone.update(merged)
        dev_total = dict(own)
        for i in reversed(tree):
            p = parent.get(i)
            if p is not None and i not in gone and i in dev_total:
                dev_total[p] = dev_total.get(p, 0.0) + dev_total[i]
        rows = {}
        for i, (name, dev, note, sync, _, t0, t1) in enumerate(ev):
            if i in gone:
                continue
            dur = (t1 - t0) / 1e3
            if dev != cpu:
                self_cpu, self_dev, total = 0.0, dur, dur
            elif sync:
                self_cpu = dur - sum((ev[c][6] - ev[c][5]) / 1e3
                                     for c in children.get(i, ()))
                self_dev, total = own.get(i, 0.0), dev_total.get(i, 0.0)
            else:
                self_cpu = self_dev = total = 0.0
            r = rows.get((name, dev, note))
            if r is None:
                r = rows[(name, dev, note)] = [0, 0.0, 0.0, 0.0]
            r[0] += 1
            r[1] += self_cpu
            r[2] += self_dev
            r[3] += total
    finally:
        if gc_was:
            gc.enable()
    return [SimpleNamespace(key=k, device_type=d, is_user_annotation=u,
                            count=r[0], self_cpu_time_total=r[1],
                            self_device_time_total=r[2],
                            device_time_total=r[3])
            for (k, d, u), r in rows.items()]


def _profile(torch, step, label, share=None, ranges=()):
    """``step``'s wall time (median of 5 runs without the profiler), and
    from one profiled run (torch.profiler) the device's busy time (the sum
    over kernels and copies on the card), the idle share, and the device
    time by kernel and by the PyTorch op that launched it; with ``share``
    (a name fragment or a tuple of them), also the device time and
    launches of every kernel whose name holds one (of the op so named, for
    an ``aten::`` name), by fragment and in all; with ``ranges`` (marker
    names such as ``fp[rwkv.wkv]``, ``core/exempt.py``), the device time
    of the kernels launched inside each range on the host (a backward's
    kernels run outside them); and the ops that took the most host time
    of their own (the profiler's self CPU time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    wall, walls = _wall_ms(torch, step)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg = _event_averages(torch, prof)
    aggregate_s = time.perf_counter() - t0
    kernels, ops = [], []
    for e in avg:
        dev_ms = e.self_device_time_total / 1e3
        if dev_ms <= 0 or e.is_user_annotation:
            continue
        on_card = e.device_type == DeviceType.CUDA
        (kernels if on_card else ops).append((dev_ms, e.count, e.key))
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    inside = {}
    for e in avg:
        if e.key in ranges and e.device_type != DeviceType.CUDA:
            inside[e.key] = dict(ms=e.device_time_total / 1e3,
                                 count=e.count)
    busy = sum(r[0] for r in kernels)
    log(f"[profile] {label}: wall {wall:.2f} ms (median of 5, no profiler), "
        f"device busy {busy:.2f} ms, idle share {1 - busy / wall:.3f}, "
        f"{sum(r[1] for r in kernels)} device kernels (aggregated in "
        f"{aggregate_s:.2f}s)")
    for ms, n, name in ops[:12]:
        log(f"[profile]   op     {ms:9.3f} ms {n:6d}x {name[:80]}")
    for ms, n, name in kernels[:10]:
        log(f"[profile]   kernel {ms:9.3f} ms {n:6d}x {name[:80]}")
    for key, r in inside.items():
        log(f"[profile]   inside {key}: {r['ms']:.3f} ms of {busy:.2f} ms "
            f"busy ({r['count']} ranges)")
    res = {"ranges": inside} if ranges else {}
    cpu = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                  for e in avg
                  if e.device_type != DeviceType.CUDA
                  and not e.is_user_annotation), reverse=True)
    for ms, n, name in cpu[:12]:
        log(f"[profile]   host   {ms:9.3f} ms {n:6d}x {name[:80]}")
    if share:
        keys = (share,) if isinstance(share, str) else tuple(share)
        by = {}
        for key in keys:
            mine = ([r for r in ops if r[2] == key] if key.startswith("aten::")
                    else [r for r in kernels if key in r[2]])
            by[key] = dict(ms=sum(r[0] for r in mine),
                           launches=sum(r[1] for r in mine))
            log(f"[profile]   kernels of *{key}*: {by[key]['ms']:.3f} ms "
                f"({by[key]['launches']} launches) of {busy:.2f} ms busy")
        res.update(share_key="|".join(keys), shares=by,
                   share_ms=sum(v["ms"] for v in by.values()),
                   share_launches=sum(v["launches"] for v in by.values()))
    return dict(res, wall_ms=wall, walls_ms=walls, device_busy_ms=busy,
                aggregate_s=aggregate_s,
                device_kernels=sum(r[1] for r in kernels),
                ops=[dict(ms=ms, count=n, name=name) for ms, n, name
                     in ops[:25]],
                kernels=[dict(ms=ms, count=n, name=name) for ms, n, name
                         in kernels[:25]],
                host_ops=[dict(ms=ms, count=n, name=name) for ms, n, name
                          in cpu[:25]])


def serve_granite(torch, seed, report):
    import numpy as np
    from repro_torch.core import QuantPolicy
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    cfg = granite_config()
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
            "kv_dequant_rows_kv": cfg.n_layers * steps}
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
    ``kv_gather_pages_kv``'s plain version (on the card)."""
    from repro_torch.kernels import kv_gather_pages_kv_plain
    return _swapped("kv_gather_pages_kv", kv_gather_pages_kv_plain,
                    "repro_torch.layers.attention")


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
            "kv_gather_pages_kv": cfg.n_layers * fwd}
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
    log(f"[paged] granite full width, {cfg.n_layers} layers, 8 slots, "
        f"page 16: {len(done)} "
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
    log(f"[paged] replay through kv_gather_pages_kv_plain: tokens equal "
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
    from repro_torch.core import QuantPolicy
    from repro_torch.serve import ServeEngine
    cfg = granite_config()
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
            "kv_gather_pages_kv": cfg.n_layers * fwd}
    log(f"[paged features] granite full width, {cfg.n_layers} layers, 4 "
        f"slots, page 16, pool "
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
    log(f"[paged features] replay through kv_gather_pages_kv_plain: tokens "
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
            f"kv_gather_pages_kv {counts['kv_gather_pages_kv']}")
        check(sorted(out[0]) == sorted(out[1]),
              f"paged reduced exact {name}: requests differ")
        check(same or chunks, f"paged reduced exact {name}: tokens differ "
                              f"from the dense engine's: {out[1]} vs "
                              f"{out[0]}")
        partings = _explain_divergence(f"paged reduced exact {name}", out[0],
                                       out[1], *recs, cfg.vocab_size)
        res[name] = dict(same_tokens=same, partings=partings, pool=st)
        check(counts["kv_gather_pages_kv"] == cfg.n_layers
              * st["paged_forwards"] and counts["kv_gather_pages"]
              == counts["kv_dequant_rows"] == counts["kv_dequant_rows_kv"]
              == 0,
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
    return _profile(torch, step, f"one paged decode step ({B} lanes)",
                    KV_SHARE)


def serve_statquant(torch, seed, report) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    cfg = get_config("statquant-tx")
    params = build_model(cfg).init(seed, device="cuda")
    eng = ServeEngine(cfg, params, policy=QuantPolicy.qat(backend="kernel"),
                      slots=4, max_seq=64, kv_quant=True, seed=seed,
                      device="cuda")
    prompts = _statquant_prompts(cfg, seed)
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
            "kv_dequant_rows_kv": cfg.n_layers * steps}
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
# the main path: serving from bit-packed weights
# ---------------------------------------------------------------------------

def _gemm_weight_bytes(params) -> int:
    """Resident bytes of the dense kernels (``"w"`` leaves, packed or not)."""
    from repro_torch.serve import weight_nbytes
    if isinstance(params, dict):
        return sum(weight_nbytes(v) if k == "w" else _gemm_weight_bytes(v)
                   for k, v in params.items())
    return 0


def _swapped(name, fn, module="repro_torch.core.backend"):
    """A context in which ``module`` calls ``fn`` for ``name``."""
    import contextlib
    import importlib
    mod = importlib.import_module(module)

    @contextlib.contextmanager
    def ctx():
        saved = getattr(mod, name)
        setattr(mod, name, fn)
        try:
            yield
        finally:
            setattr(mod, name, saved)
    return ctx()


def _shapes(t):
    """The shapes of the tensors in ``t`` (nested tuples and lists), None
    for anything else."""
    if isinstance(t, (tuple, list)):
        return tuple(_shapes(x) for x in t)
    return tuple(t.shape) if hasattr(t, "shape") else None


def _shape_spy(name, module, seen):
    """A context in which ``module``'s ``name`` adds the shapes of each
    call's arguments to the set ``seen``, then runs as before."""
    import importlib
    fn = getattr(importlib.import_module(module), name)

    def spy(*a, **kw):
        seen.add(_shapes(a))
        return fn(*a, **kw)
    return _swapped(name, spy, module)


def _in_contexts(contexts):
    """One context entering each of ``contexts`` in turn."""
    import contextlib
    stack = contextlib.ExitStack()
    for c in contexts:
        stack.enter_context(c)
    return stack


def _record_forwards(eng):
    """The logits of every forward ``eng`` runs (prefills, decode steps,
    paged forwards), in order, cloned."""
    out = []

    def keep(fn):
        def call(*a, **kw):
            logits, cache = fn(*a, **kw)
            out.append(logits.clone())
            return logits, cache
        return call
    m = eng.model
    eng.model = dataclasses.replace(m, prefill=keep(m.prefill),
                                    decode=keep(m.decode),
                                    paged_decode=keep(m.paged_decode))
    return out


def serve_granite_packed(torch, seed, report, dense_eng, workload):
    """granite-3-2b at full width from weights packed once at load; see
    the module docstring.  Returns the results and the 8- and 4-bit
    engines (profiled at the end)."""
    import numpy as np
    from repro_torch.core import QuantPolicy
    from repro_torch.kernels import (fused_qlhs_packed_matmul_plain,
                                     packed_matmul_plain)
    from repro_torch.serve import ServeEngine
    cfg, params = dense_eng.cfg, dense_eng.params
    per_fwd = _gemms_per_forward(cfg)
    res, engines = {}, {}
    total = {"fused_qlhs_packed_matmul": 0, "packed_matmul": 0}

    def engine(bits, fused=None):
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, params, policy=QuantPolicy.qat(
            backend="kernel", fused=fused), slots=8, max_seq=256,
            kv_quant=True, seed=seed, weight_bits=bits, device="cuda")
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        eng.submit([1] * 16, max_new=2)             # the dense warm-up
        eng.run()
        eng.step_times.clear()
        return eng, pack_s

    def serve(eng, reqs):
        for prompt, kw in reqs:
            eng.submit(prompt, **kw)
        seen = _record_sampling_logits(eng)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return ({r: c.tokens for r, c in done.items()}, seen, _read_counts(),
                wall)

    def run(tag, bits, reqs, kernel, plain, fused=None):
        eng, pack_s = engine(bits, fused)
        tokens, seen, counts, wall = serve(eng, reqs)
        steps = len(eng.step_times)
        want = {kernel: per_fwd * (len(reqs) + steps),
                "kv_dequant_rows_kv": cfg.n_layers * steps}
        n_tok = sum(len(t) for t in tokens.values())
        dts = np.asarray([dt for dt, _ in eng.step_times])
        r = dict(requests=len(tokens), tokens=n_tok, wall_s=wall,
                 tok_per_s=n_tok / wall, decode_steps=steps, pack_s=pack_s,
                 p50_step_ms=float(np.percentile(dts, 50)) * 1e3,
                 p95_step_ms=float(np.percentile(dts, 95)) * 1e3,
                 launches=counts, expected_launches=want,
                 gemm_weight_bytes=_gemm_weight_bytes(eng.params),
                 gemm_weight_bytes_fp32=_gemm_weight_bytes(params))
        log(f"[{tag}] granite full width, {cfg.n_layers} layers, 8 slots: "
            f"packed at load in "
            f"{pack_s:.2f}s, GEMM weights {r['gemm_weight_bytes'] / 1e9:.3f}"
            f" GB resident (fp32 {r['gemm_weight_bytes_fp32'] / 1e9:.3f} "
            f"GB); {len(tokens)} requests, {n_tok} tokens in {wall:.2f}s "
            f"({r['tok_per_s']:.1f} tok/s), {steps} decode steps, p50 "
            f"{r['p50_step_ms']:.2f} ms p95 {r['p95_step_ms']:.2f} ms")
        log(f"[{tag}] launches {counts} expected {want}")
        _check_counts(counts, want, tag)
        max_new = reqs[0][1]["max_new"]
        check(len(tokens) == len(reqs) and all(
            len(t) == max_new and all(0 <= v < cfg.vocab_size for v in t)
            for t in tokens.values()),
            f"{tag}: requests did not complete in the vocabulary")
        total[kernel] += counts[kernel]
        with _swapped(kernel, plain):
            eng_p, _ = engine(bits, fused)
            tokens_p, seen_p, _, _ = serve(eng_p, reqs)
        del eng_p
        same_log = seen.keys() == seen_p.keys() and all(
            torch.equal(seen[k], seen_p[k]) for k in seen)
        log(f"[{tag}] replay through {kernel}'s plain version: tokens equal "
            f"{tokens_p == tokens}, logits of all {len(seen)} decode samples "
            f"bit-identical {same_log}")
        check(tokens_p == tokens and same_log,
              f"{tag}: the plain replay differs")
        r["plain_replay_identical"] = True
        return eng, tokens, r

    eng8, tokens8, res["w8"] = run("packed w8", 8, workload,
                                   "fused_qlhs_packed_matmul",
                                   fused_qlhs_packed_matmul_plain)
    same = tokens8 == report["granite"]["tokens"]
    log(f"[packed w8] tokens equal the dense engine's: {same}")
    check(same, "packed w8: tokens differ from the dense engine's")
    same_logits = all(
        torch.equal(dense_eng._prefill(np.asarray([p]))[0],
                    eng8._prefill(np.asarray([p]))[0]) for p, _ in workload)
    log(f"[packed w8] prefill logits of all {len(workload)} prompts "
        f"bit-identical to the dense engine's: {same_logits}")
    check(same_logits, "packed w8: prefill logits differ from the dense "
                       "engine's")
    res["w8"]["prefill_logits_identical_to_dense"] = True
    engines[8] = eng8

    eng4, tokens4, res["w4"] = run("packed w4", 4, workload,
                                   "fused_qlhs_packed_matmul",
                                   fused_qlhs_packed_matmul_plain)
    dense = report["granite"]["tokens"]
    agree = sum(a == b for r in dense for a, b in zip(dense[r], tokens4[r]))
    n = sum(len(t) for t in dense.values())
    log(f"[packed w4] token agreement with the dense (8-bit) engine: "
        f"{agree}/{n} (measured, not held: 4-bit weights are another model)")
    res["w4"]["dense_token_agreement"] = [agree, n]
    engines[4] = eng4

    short = [(p, dict(kw, max_new=8)) for p, kw in workload[:4]]
    eng4u, _, res["w4_unfused"] = run("packed w4 unfused", 4, short,
                                      "packed_matmul", packed_matmul_plain,
                                      fused=False)
    del eng4u

    # every GEMM of one prefill from the 4-bit weights vs simulate on them
    _, worst = _gemms_vs_simulate(
        torch, lambda: _prefill_logits(torch, eng4.model, eng4.params,
                                       workload[0][0], "kernel",
                                       eng4.policy),
        per_fwd, "packed w4",
        dataclasses.replace(eng4.policy, backend="simulate"))
    log(f"[packed w4] all {per_fwd} GEMMs of one prefill (prompt "
        f"{len(workload[0][0])}) vs simulate on the same packed weights: "
        f"max|d|={worst:.3g} (checked, rtol {RTOL}, atol {ATOL})")
    res["w4"]["gemms_vs_simulate_max_abs_diff"] = worst
    res["launches"] = total
    report["packed"] = res
    return res, engines


# ---------------------------------------------------------------------------
# the main path: training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 5


def _train_policy(quant, bits, backend, fused=None, overrides=()):
    """The launcher's FQT policy (``launch/train.py``: bhq_block=256);
    ``fused=False`` takes every role off the fused kernels."""
    from repro_torch.core import QuantPolicy
    return QuantPolicy.fqt(quant, bits, bhq_block=256, backend=backend,
                           fused=fused, overrides=overrides)


def _train_engine(cfg, quant, bits, backend, seed, fused=None, overrides=(),
                  steps=TRAIN_STEPS, batch=8, seq=64):
    """The engine ``python -m repro_torch.launch.train --full --quant
    QUANT --grad-bits BITS --backend BACKEND [--override ...]`` builds
    (default batch 8, seq 64), with the policy's ``fused`` knob."""
    from repro_torch.engine import Engine
    return Engine(cfg, _train_policy(quant, bits, backend, fused, overrides),
                  steps=steps, batch_size=batch, seq_len=seq, seed=seed,
                  device="cuda", log_every=1, log_fn=log)


def _replay(torch, eng, steps=TRAIN_STEPS, metrics=("loss", "grad_norm")):
    """``steps`` steps of the engine's own step from its initial state:
    a tuple of ``metrics`` (default (loss, grad_norm)) per step."""
    state, out = eng.init_state(), []
    for s in range(steps):
        state, m = eng.step_fn(state, eng.loader.get(s))
        out.append(tuple(float(m[k]) for k in metrics))
    return out


def _replay_plain(torch, eng, steps=TRAIN_STEPS,
                  metrics=("loss", "grad_norm")):
    """``_replay`` with every training kernel's wrapper swapped for its
    plain version (on the card): same device, same ops around them."""
    import repro_torch.core.backend as backend
    from repro_torch import kernels
    names = ("fused_qlhs_matmul", "fused_qboth_tn_matmul", "q8_matmul",
             "quantize_sr_rows", "quantize_sr_tensor",
             "fused_qlhs_packed_matmul", "packed_matmul")
    saved = {n: getattr(backend, n) for n in names}
    for n in names:
        setattr(backend, n, getattr(kernels, n + "_plain"))
    try:
        return _replay(torch, eng, steps, metrics)
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
                          against=("simulate", None),
                          backend="kernel") -> dict:
    """Each backward GEMM of one step re-run from its (x, w, key, g) on
    ``backend`` (with ``fused``) and on the reference ``against``
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
        for bk, fz in ((backend, fused), against):
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            y = fqt_matmul(xr, wr, key, _train_policy(quant, bits, bk, fz),
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
                  f"{tag}: {path} x {tuple(x.shape)}: {backend} vs "
                  f"{ref_name} {name} differ by {float(d.max())} beyond rtol "
                  f"{RTOL}/atol {ATOL}")
            check(margin <= 1.0,
                  f"{tag}: {path} x {tuple(x.shape)}: {backend} vs {ref_name} "
                  f"{name} differ by {float(d.max())} beyond rtol {RTOL} "
                  f"+ {GRAD_ATOL_FRAC} * max|{name}| ({peak:.3g}); share "
                  f"of that tolerance used {margin:.3g}")
    log(f"[{tag}] every backward GEMM of one step ({n}) re-run from its "
        f"(x, w, key, g): {backend} vs {ref_name} max|d| dX {worst['dx']:.3g} "
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


PACKED_TRAIN_STEPS = 3


def train_packed(torch, seed, report) -> dict:
    """statquant-tx at full width and depth trains PACKED_TRAIN_STEPS steps
    under fqt(psq, 8) with the forward weights quantized by ``int4w:4``
    (``launch/train.py --override '.*=fwd_weight:int4w:4'``), fused and
    unfused: exact launch counts, finite loss and gradient norm, and the
    same numbers through the plain versions."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.train import parse_override
    cfg = get_config("statquant-tx")
    n = _gemms_per_forward(cfg)
    S = PACKED_TRAIN_STEPS
    overrides = (parse_override(".*=fwd_weight:int4w:4"),)
    total = {"fused_qlhs_packed_matmul": 0, "packed_matmul": 0}
    res = {}
    for fused, tag in ((None, "train psq8 int4w"),
                       (False, "train psq8 int4w unfused")):
        eng = _train_engine(cfg, "psq", 8, "kernel", seed, fused=fused,
                            overrides=overrides, steps=S)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        if fused is None:
            want = {"fused_qlhs_packed_matmul": n * S,
                    "fused_qlhs_matmul_dx": n * S,
                    "fused_qboth_tn_matmul": n * S}
        else:
            want = {"packed_matmul": n * S, "q8_matmul": 2 * n * S,
                    "quantize_sr_rows": n * S, "quantize_sr_tensor": n * S}
        log(f"[{tag}] {cfg.name} full width: {S} steps of 8 x 64 tokens in "
            f"{wall:.2f}s, launches {counts} expected {want}")
        _check_counts(counts, want, tag)
        for name in total:
            total[name] += counts[name]
        kern = _replay(torch, eng, S)
        check([k[0] for k in kern] == [loss for _, loss in history]
              and all(np.isfinite(v) for k in kern for v in k),
              f"{tag}: the run {history} and its replay {kern} differ or "
              f"are not finite")
        plain = _replay_plain(torch, eng, S)
        log(f"[{tag}] (loss, grad norm) per step {kern}; through the plain "
            f"versions {plain}")
        check(kern == plain, f"{tag}: the steps through the kernels differ "
                             f"from the plain versions")
        res["unfused" if fused is False else "fused"] = dict(
            wall_s=wall, step_s=wall / S, launches=counts,
            expected_launches=want, kernel=kern, plain=plain)
    res["launches"] = total
    report["train_packed"] = res
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
# checkpoints, serving from a checkpoint, the native backend, the theory
# ---------------------------------------------------------------------------

CKPT_STEPS = 6
CKPT_EVERY = 3


def _ckpt_engine(cfg, quant, bits, seed, **kw):
    """``_train_engine``'s engine for CKPT_STEPS steps with the engine's
    checkpoint options ``kw`` (``ckpt_dir``, ``ckpt_every``,
    ``preemption``, ``log_fn``)."""
    from repro_torch.engine import Engine
    kw.setdefault("log_fn", None)
    return Engine(cfg, _train_policy(quant, bits, "kernel"),
                  steps=CKPT_STEPS, batch_size=8, seq_len=64, seed=seed,
                  device="cuda", log_every=1, **kw)


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}/{k}" if prefix
                                     else k)
    else:
        yield prefix, tree


def _state_diff(torch, a, b) -> list:
    """The leaves of two TrainStates that are not bit-identical."""
    out = []
    for name, x, y in (("params", a.params, b.params),
                       ("m", a.opt_state["m"], b.opt_state["m"]),
                       ("v", a.opt_state["v"], b.opt_state["v"])):
        for (path, p), (_, q) in zip(_named_leaves(x), _named_leaves(y)):
            if not torch.equal(p, q):
                out.append(f"{name}/{path} (max|d| "
                           f"{float((p - q).abs().max()):.3g})")
    for name, p, q in (("step", a.step, b.step),
                       ("t", a.opt_state["t"], b.opt_state["t"])):
        if p != q:
            out.append(f"{name} {p} vs {q}")
    if not torch.equal(a.rng, b.rng):
        out.append(f"rng {a.rng.tolist()} vs {b.rng.tolist()}")
    return out


def ckpt_train(torch, seed, report):
    """[ckpt train]: statquant-tx at full width, 8 x 64 tokens, on the
    kernel backend under ``fqt(bhq,5)`` (the launcher's default) and
    ``fqt(psq,8)``: CKPT_STEPS uninterrupted steps against CKPT_EVERY
    steps with an asynchronous checkpoint and a new engine that resumes to
    CKPT_STEPS; and a run stopped by ``PreemptionHandler.request_stop``
    after step 4, checkpointed synchronously and resumed.  Losses must be
    equal and every leaf of params, m and v, step, t and rng
    ``torch.equal``: a leaf that differs is a port fault and fails the
    phase.  Returns the bhq directory (its step-3 checkpoint) and the
    params the checkpointing engine held at step 3."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.runtime import PreemptionHandler
    cfg = get_config("statquant-tx")
    n = _gemms_per_forward(cfg)
    root = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(root, ignore_errors=True)
    res, serve_from = {}, None
    for quant, bits in (("bhq", 5), ("psq", 8)):
        tag = f"ckpt train {quant}{bits}"
        t_phase = time.perf_counter()
        full = _ckpt_engine(cfg, quant, bits, seed)
        _reset_counts()
        h_full = full.run()
        torch.cuda.synchronize()
        counts = _read_counts()
        want = {"fused_qlhs_matmul": n * CKPT_STEPS,
                "fused_qboth_tn_matmul": n * CKPT_STEPS,
                ("fused_qlhs_matmul_dx" if quant == "psq" else "q8_matmul"):
                    n * CKPT_STEPS}
        _check_counts(counts, want, tag)
        d = root / f"{quant}{bits}"
        e1 = _ckpt_engine(cfg, quant, bits, seed, ckpt_dir=str(d),
                          ckpt_every=CKPT_EVERY)
        h1 = e1.run(steps=CKPT_EVERY)
        e2 = _ckpt_engine(cfg, quant, bits, seed, ckpt_dir=str(d),
                          ckpt_every=100)
        h2 = e2.run()
        torch.cuda.synchronize()
        diff = _state_diff(torch, e2.state, full.state)
        log(f"[{tag}] {CKPT_STEPS} steps {[round(v, 6) for _, v in h_full]}"
            f"; {CKPT_EVERY} + checkpoint + resumed {CKPT_STEPS - CKPT_EVERY}"
            f" {[round(v, 6) for _, v in h1 + h2]}; leaves that differ: "
            f"{len(diff)} {diff[:4]}")
        check(h1 + h2 == h_full, f"{tag}: resumed losses {h1 + h2} differ "
                                 f"from the uninterrupted run's {h_full}")
        check(not diff, f"{tag}: port fault, the resumed state differs from "
                        f"the uninterrupted one in {diff[:8]}")
        # preemption: stop after step 4 (index 3), synchronous checkpoint
        d2 = root / f"{quant}{bits}_preempt"
        prm = PreemptionHandler()

        def stop_after_4(msg):
            if msg.startswith("[engine] step     3 "):
                prm.request_stop()
        e3 = _ckpt_engine(cfg, quant, bits, seed, ckpt_dir=str(d2),
                          ckpt_every=CKPT_EVERY, preemption=prm,
                          log_fn=stop_after_4)
        h3 = e3.run()
        e4 = _ckpt_engine(cfg, quant, bits, seed, ckpt_dir=str(d2),
                          ckpt_every=100)
        h4 = e4.run()
        torch.cuda.synchronize()
        diff_p = _state_diff(torch, e4.state, full.state)
        steps = e3.ckpt.all_steps()
        log(f"[{tag}] preempted after step {len(h3)} (checkpoints {steps}), "
            f"resumed to {e4.state.step}: leaves that differ: "
            f"{len(diff_p)} {diff_p[:4]}")
        check([s for s, _ in h3] == [0, 1, 2, 3] and steps == [3, 4],
              f"{tag}: the preempted run ran {[s for s, _ in h3]} and wrote "
              f"{steps}, not steps 0-3 and checkpoints [3, 4]")
        check(h3 + h4 == h_full, f"{tag}: the preempted and resumed losses "
                                 f"{h3 + h4} differ from {h_full}")
        check(not diff_p, f"{tag}: port fault, the state resumed after the "
                          f"preemption differs in {diff_p[:8]}")
        st1, st3 = e1.ckpt.stats, e3.ckpt.stats
        nbytes = e1.ckpt.nbytes(CKPT_EVERY)
        res[quant] = dict(
            losses=[v for _, v in h_full], ckpt_bytes=nbytes,
            async_snapshot_s=st1["snapshot_s"][0],
            async_write_s=st1["write_s"][0],
            restore_s=e2.ckpt.stats["restore_s"][0],
            sync_snapshot_s=st3["snapshot_s"][-1],
            sync_write_s=st3["write_s"][-1],
            restore_after_preempt_s=e4.ckpt.stats["restore_s"][0],
            launches=counts, phase_s=time.perf_counter() - t_phase)
        log(f"[{tag}] checkpoint {nbytes} bytes on disk; in the loop: async "
            f"snapshot {res[quant]['async_snapshot_s']:.4f} s, write on the "
            f"worker {res[quant]['async_write_s']:.4f} s; on preemption: "
            f"snapshot {res[quant]['sync_snapshot_s']:.4f} s + write "
            f"{res[quant]['sync_write_s']:.4f} s; restore "
            f"{res[quant]['restore_s']:.4f} s; phase "
            f"{res[quant]['phase_s']:.2f} s")
        if serve_from is None:
            serve_from = (str(d), e1.state.params)
        del full, e1, e2, e3, e4
        torch.cuda.empty_cache()
    report["ckpt_train"] = res
    return serve_from


def _statquant_prompts(cfg, seed):
    """The smoke run's statquant-tx serving requests (``serve_statquant``):
    4 prompts of 4-32 tokens."""
    import numpy as np
    rng = np.random.RandomState(seed + 1)
    return [rng.randint(0, cfg.vocab_size, size=int(rng.randint(4, 33)))
            .tolist() for _ in range(4)]


def ckpt_serve(torch, seed, report, serve_from) -> None:
    """[ckpt serve]: ``ServeEngine.from_checkpoint`` on [ckpt train]'s bhq
    directory (step 3, full-width statquant-tx) dense, ``paged=True``
    (pages of 16) and ``weight_bits=4``, 4 slots: each serves the smoke
    run's statquant-tx requests with the greedy tokens of the same engine
    built from the checkpointing engine's params in memory (equal pool
    size and submissions), through its kernels."""
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.serve import PagedServeEngine, ServeEngine
    d, params = serve_from
    cfg = get_config("statquant-tx")
    prompts = _statquant_prompts(cfg, seed)
    res = {}
    for form, kw, kernels in (
            ("dense", {}, ("fused_qlhs_matmul", "kv_dequant_rows_kv")),
            ("paged", dict(paged=True, page_size=16),
             ("fused_qlhs_matmul", "kv_gather_pages_kv")),
            ("w4", dict(weight_bits=4),
             ("fused_qlhs_packed_matmul", "kv_dequant_rows_kv"))):
        tag = f"ckpt serve {form}"
        t0 = time.perf_counter()
        base = dict(policy=QuantPolicy.qat(backend="kernel"), slots=4,
                    max_seq=64, kv_quant=True, seed=seed, device="cuda", **kw)
        loaded = ServeEngine.from_checkpoint(cfg, d, **base)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        direct = ServeEngine(cfg, params, **base)
        check(isinstance(loaded, PagedServeEngine) == (form == "paged"),
              f"{tag}: built {type(loaded).__name__}")
        outs = []
        for eng in (loaded, direct):
            for p in prompts:
                eng.submit(p, max_new=8)
            _reset_counts()
            done = eng.run()
            outs.append(({r: c.tokens for r, c in done.items()},
                         _read_counts()))
        (got, counts), (want, _) = outs
        log(f"[{tag}] from the checkpoint in {load_s:.3f} s: {len(got)} "
            f"requests, tokens equal to the in-memory engine's: "
            f"{got == want}; launches {counts}")
        check(len(got) == 4 and all(len(t) == 8 for t in got.values()),
              f"{tag}: requests did not complete")
        check(got == want, f"{tag}: tokens {got} differ from the in-memory "
                           f"engine's {want}")
        for name in kernels:
            check(counts[name] > 0, f"{tag}: {name} never launched")
        res[form] = dict(load_s=load_s, launches=counts, tokens=got)
        del loaded, direct
        torch.cuda.empty_cache()
    report["ckpt_serve"] = res


NATIVE_STEPS = 3


def _clone_state(state):
    """A TrainState whose tensors are copies (the step updates in place)."""
    import dataclasses
    from repro_torch.optim import tree_map
    opt = {k: (v if k == "t" else tree_map(lambda t: t.clone(), v))
           for k, v in state.opt_state.items()}
    return dataclasses.replace(state, params=tree_map(
        lambda t: t.clone(), state.params), opt_state=opt)


def _carried_steps(torch, engines, steps):
    """``steps`` steps of ``engines[0]`` from its initial state; before
    each, every other engine takes the same step from a copy of that
    state on the same batch.  Returns [(loss, grad norm)] per step for
    each engine (a step's own cross-backend difference, not a
    trajectory's)."""
    ref = engines[0]
    state = ref.init_state()
    out = [[] for _ in engines]
    for s in range(steps):
        batch = ref.loader.get(s)
        for i, eng in enumerate(engines[1:], 1):
            _, m = eng.step_fn(_clone_state(state), batch)
            out[i].append((float(m["loss"]), float(m["grad_norm"])))
        state, m = ref.step_fn(state, batch)
        out[0].append((float(m["loss"]), float(m["grad_norm"])))
    return out


def native_train(torch, seed, report) -> None:
    """[native]: statquant-tx training on the ``native`` backend
    (``torch._int_mm`` on the int8 codes) under ``fqt(psq,8)``, each step
    from the state ``simulate``'s run carries (``_carried_steps``).

    At full width (8 x 64 tokens), NATIVE_STEPS steps: finite, none of
    the hand-written kernels launched, each step's loss within the repo's
    cross-backend tolerance (rtol 1e-3, atol 5e-3) of ``simulate``'s; and
    every backward GEMM of one step, re-run from its (x, w, key, dY) on
    ``native`` and ``simulate``, within rtol 1e-3 plus 5e-3 x max|ref|
    (``_backward_vs``).  The full-width gradient norms are printed beside
    ``simulate``'s and ``kernel``'s, not held: per-tensor ``Q_f`` turns
    the backends' float32 round-off (an exact int32 product and epilogue
    against an fp32 product of dequantized values) into whole-code flips,
    which move the gradient norm by a few tenths of a percent at this
    width, ``kernel`` against ``simulate`` too, as in the JAX package
    (ROADMAP queue 3, "Full width").  At the reduced config (4 x 16
    tokens) the losses and gradient norms are held, as the repo holds end
    to end.  Then the median step wall (10 steps after 2) beside the
    ``kernel`` backend's, in this run."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.engine import Engine
    cfg = get_config("statquant-tx")
    engines = [_train_engine(cfg, "psq", 8, b, seed, steps=NATIVE_STEPS)
               for b in ("simulate", "native", "kernel")]
    sim, got, kern = _carried_steps(torch, engines, NATIVE_STEPS)
    log(f"[native] {cfg.name} full width, fqt(psq,8), each step from "
        f"simulate's state: (loss, grad norm) native {got} vs simulate "
        f"{sim} (kernel {kern}; losses checked, rtol {RTOL}, atol {ATOL}; "
        f"grad norms measured, not held)")
    check(all(np.isfinite(v) for s in got for v in s), f"[native] {got}")
    for s, (a, b) in enumerate(zip(got, sim)):
        check(abs(a[0] - b[0]) <= ATOL + RTOL * abs(b[0]),
              f"[native] step {s}: loss {a[0]} vs simulate {b[0]} beyond "
              f"rtol {RTOL}/atol {ATOL}")
    _reset_counts()
    _replay(torch, engines[1], 1)
    counts = _read_counts()
    log(f"[native] hand-written kernel launches in one native step: "
        f"{sum(counts.values())} (checked, none)")
    check(not any(counts.values()), f"[native]: the native backend launched "
                                    f"hand-written kernels {counts}")
    gemms = _backward_vs(torch, engines[1], "psq", 8, "native",
                         backend="native")
    red = get_config("statquant-tx", smoke=True)
    reduced = _carried_steps(torch, [
        Engine(red, _train_policy("psq", 8, b), steps=NATIVE_STEPS,
               batch_size=4, seq_len=16, seed=seed, device="cuda",
               log_fn=None) for b in ("simulate", "native")], NATIVE_STEPS)
    log(f"[native] reduced {red.name}, 4 x 16 tokens, each step from "
        f"simulate's state: (loss, grad norm) native {reduced[1]} vs "
        f"simulate {reduced[0]} (checked, rtol {RTOL}, atol {ATOL})")
    for s, (a, b) in enumerate(zip(reduced[1], reduced[0])):
        for name, x, y in (("loss", a[0], b[0]), ("grad norm", a[1], b[1])):
            check(abs(x - y) <= ATOL + RTOL * abs(y),
                  f"[native] reduced step {s}: {name} {x} vs simulate {y} "
                  f"beyond rtol {RTOL}/atol {ATOL}")
    walls = {}
    for backend in ("native", "kernel"):
        step = _one_step(_train_engine(cfg, "psq", 8, backend, seed,
                                       steps=NATIVE_STEPS))
        ms = []
        for _ in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        walls[backend] = dict(median_ms=float(np.median(ms[2:])), ms=ms[2:])
    log(f"[native] step wall, median of 10: native "
        f"{walls['native']['median_ms']:.2f} ms, kernel "
        f"{walls['kernel']['median_ms']:.2f} ms")
    report["native"] = dict(native=got, simulate=sim, kernel=kern,
                            launches=counts, backward_gemms_vs_simulate=gemms,
                            reduced=dict(native=reduced[1],
                                         simulate=reduced[0]), walls=walls)


THEORY_DRAWS = 64
FQT_DRAWS = 16


def _variance_estimate_sd(torch, x, name, bits, n):
    """The standard deviation of ``empirical_mean_and_variance``'s
    variance (the population variance over ``n`` draws, summed over
    entries) for quantizer ``name`` on ``x``, from the exact per-entry SR
    moments.

    Every quantizer rounds t = the transform of x stochastically: entry e
    gets independent noise with variance s2_e = p(1-p) and fourth
    cumulant k4_e = p(1-p)(1-6p(1-p)), p = frac(t_e) (Bernoulli), and the
    dequantized noise is e -> M eps with M = diag(1/S) for PTQ, diag(1/s_i)
    for PSQ and diag(1/s) Q within each BHQ group.  The estimate is
    (1/n) tr(A W) with A = M^T M and W the scatter of the n draws, so
    Var = 2(n-1)/n^2 sum_d tr((A Sigma_d)^2) + (n-1)^2/n^3 sum_e A_ee^2 k4_e
    (the Wishart term, exact for Gaussian noise, plus the fourth-cumulant
    term), in float64."""
    from repro_torch.core import quantizers as qz
    from repro_torch.core.bhq import _blocked_rows, _bhq_transform
    B = qz.num_bins(bits)
    x = x.to(torch.float32)
    if name == "bhq":
        gb, valid, _ = _blocked_rows(x, 256)
        y, zero, rs, nv, cf, seg, _ = _bhq_transform(gb, valid, bits,
                                                     "refined")
        t = (y - zero).double()
        p = t - torch.floor(t)
        s2 = p * (1 - p)
        k4 = s2 * (1 - 6 * s2)
        t2 = k = 0.0
        for b in range(gb.shape[0]):
            nb = gb.shape[1]
            same = seg[b][:, None] == seg[b][None, :]
            nvb = nv[b, :, 0].double()
            q = (torch.eye(nb, dtype=torch.float64, device=x.device)
                 - cf[b, :, 0].double()[:, None] * nvb[:, None]
                 * nvb[None, :] * same)
            m = q / rs[b].double()                 # row j scaled by 1/s_j
            a = m.T @ m
            t2 = t2 + float(((a * a) * (s2[b] @ s2[b].T)).sum())
            k = k + float((torch.diagonal(a)[:, None] ** 2 * k4[b]).sum())
    else:
        rows = x.reshape(-1, x.shape[-1])
        if name == "ptq":
            zero = torch.amin(rows)
            scale = qz.range_scale(B, qz.dynamic_range(rows))
            c = (1.0 / scale.double() ** 2).expand(rows.shape[0], 1)
        else:
            zero = torch.amin(rows, dim=-1, keepdim=True)
            scale = qz.range_scale(B, qz.row_dynamic_range(rows)[:, None])
            c = 1.0 / scale.double() ** 2
        t = (scale * (rows - zero)).double()
        p = t - torch.floor(t)
        s2 = p * (1 - p)
        k4 = s2 * (1 - 6 * s2)
        t2 = float((c ** 2 * s2 ** 2).sum())
        k = float((c ** 2 * k4).sum())
    var = 2 * (n - 1) / n ** 2 * t2 + (n - 1) ** 2 / n ** 3 * k
    return var ** 0.5


def theory_phase(torch, seed, report) -> None:
    """[theory]: the paper's estimators through the card's kernels.

    1. A gradient of the training step's lm_head shape (512, 10240) in the
       paper's regime (Fig. 4: rows of scale 1e-3 with 4 outlier rows of
       scale 1), made from the seed on the card; at 5 and 8 bits, for
       ``ptq`` and ``psq`` (the ``quantize_sr_tensor``/``_rows`` kernels)
       and ``bhq`` (block_rows 256, the launcher's): ``quantizer_variance``
       (exact) against ``empirical_mean_and_variance`` (THEORY_DRAWS
       draws).  Checked: the empirical variance V_hat against its
       expectation (n-1)/n V within 6 standard deviations
       (``_variance_estimate_sd``, from the exact per-entry moments: a
       quantizer whose noise is not the SR noise of its transform fails
       it); the unbiasedness ratio R = n ||mean - x||^2 / V in [0.5, 2]
       (E[R] = 1 for an unbiased quantizer; over 5.2 million entries its
       spread is far below 0.1, and a bias per entry of a fifth of the
       draws' standard error already gives R = 1 + 64 * 0.04 = 3.6, so a
       biased rounding cannot pass); and Var bhq < psq < ptq (exact and
       empirical), the paper's Sec. 4 ordering in this regime.
    2. ``fqt_gradient_stats`` of statquant-tx at full width (one batch of
       8 x 64, FQT_DRAWS draws) against its QAT gradient (the same fused
       forward, a full-precision backward) under ``fqt(psq,8)`` and
       ``fqt(bhq,5)`` on the kernel backend: Theorem 1 on the card, the
       same ratio R = n ||mean - g_QAT||^2 / V_hat in [0.5, 2] (E[R] =
       n/(n-1) for an unbiased gradient; a gradient whose bias reached the
       draws' standard error would give R >= 1 + n = 17)."""
    from repro_torch import prng
    from repro_torch.core import QuantizerSpec, get_quantizer
    from repro_torch.core.theory import (empirical_mean_and_variance,
                                         fqt_gradient_stats,
                                         quantizer_variance)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    M, N = 512, 10240
    x = torch.randn(M, N, generator=gen, device="cuda") * 1e-3
    x[:4] *= 1e3
    n = THEORY_DRAWS
    res = {"quantizers": {}}
    for bits in (5, 8):
        exact, emp = {}, {}
        for name in ("ptq", "psq", "bhq"):
            params = {"block_rows": 256} if name == "bhq" else {}
            spec = QuantizerSpec(name, bits, tuple(params.items()))
            q = get_quantizer(name)
            mean, v_hat = empirical_mean_and_variance(
                lambda a, k: q.quantize(a, k, spec,
                                        backend="kernel").dequant(),
                x, prng.PRNGKey(seed + bits), n)
            v = float(quantizer_variance(x, name, bits, **params))
            sd = _variance_estimate_sd(torch, x, name, bits, n)
            z = (v_hat - (n - 1) / n * v) / sd
            r = n * float(((mean.double() - x.double()) ** 2).sum()) / v
            tag = f"theory {name}{bits}"
            log(f"[{tag}] ({M}, {N}): exact Var {v:.6g}, empirical "
                f"{v_hat:.6g} ({n} draws; (V_hat - (n-1)/n V) / sd = "
                f"{z:.3f}, checked |.| <= 6), R = n |mean - x|^2 / V = "
                f"{r:.4f} (checked in [0.5, 2])")
            check(abs(z) <= 6, f"[{tag}]: the empirical variance {v_hat} "
                               f"is {z:.2f} sd from {(n - 1) / n * v}")
            check(0.5 <= r <= 2, f"[{tag}]: R = {r} outside [0.5, 2]: "
                                 f"biased")
            exact[name], emp[name] = v, v_hat
            res["quantizers"][f"{name}{bits}"] = dict(
                exact=v, empirical=v_hat, z=z, ratio=r, sd=sd)
        for d, what in ((exact, "exact"), (emp, "empirical")):
            check(d["bhq"] < d["psq"] < d["ptq"],
                  f"[theory] {bits} bits: {what} variances {d} not ordered "
                  f"bhq < psq < ptq")
    res["fqt"] = _theorem1_on_card(torch, seed, fqt_gradient_stats)
    report["theory"] = res


def _theorem1_on_card(torch, seed, fqt_gradient_stats) -> dict:
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.data import make_batch_for
    from repro_torch.models import build_model
    from repro_torch.optim import tree_leaves, tree_map
    cfg = get_config("statquant-tx")
    model = build_model(cfg)
    params = model.init(seed, device="cuda")
    batch = {k: v.to("cuda") for k, v in
             make_batch_for(cfg, 8, 64, seed=seed).items()}

    def grad_fn(policy):
        def fn(key):
            with torch.enable_grad():
                ps = tree_map(lambda t: t.detach().requires_grad_(), params)
                loss, _ = model.loss(ps, batch, key, policy)
                return torch.autograd.grad(loss, tree_leaves(ps))
        return fn

    qat = grad_fn(QuantPolicy.qat(backend="kernel"))(prng.PRNGKey(0))
    out = {}
    for quant, bits in (("psq", 8), ("bhq", 5)):
        stats = fqt_gradient_stats(
            grad_fn(_train_policy(quant, bits, "kernel")),
            prng.PRNGKey(seed + 17), FQT_DRAWS)
        err = sum(float(((m.double() - g.double()) ** 2).sum())
                  for m, g in zip(stats["mean"], qat))
        v_hat = stats["variance"]
        r = FQT_DRAWS * err / v_hat
        qat_sq = sum(float((g.double() ** 2).sum()) for g in qat)
        log(f"[theory fqt {quant}{bits}] statquant-tx full width, one batch "
            f"of 8 x 64: Var[FQT grad | batch] {v_hat:.6g} ({FQT_DRAWS} "
            f"draws; |QAT grad|^2 {qat_sq:.6g}), |mean - QAT|^2 {err:.6g}, "
            f"R = n |mean - QAT|^2 / V_hat = {r:.4f} (checked in [0.5, 2])")
        check(0.5 <= r <= 2, f"[theory fqt {quant}{bits}]: R = {r} outside "
                             f"[0.5, 2]: the FQT gradient is not unbiased")
        out[f"{quant}{bits}"] = dict(variance=v_hat, sq_err=err, ratio=r,
                                     qat_sq_norm=qat_sq)
    return out


# ---------------------------------------------------------------------------
# the MoE family, and the standalone ops
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-1b-a400m"
# tokens a request: 8 give two waves of 7 decode steps an engine at about
# 1 s a step (16 gave 15 each), so that the run fits its limit on a slow
# host; every check of the phase stays
MOE_NEW_TOKENS = 8
# the MoE serving phase's depth (full width; the config has 24 layers):
# cut so that the whole run, the VLM, hybrid and RWKV6 phases included,
# fits its limit
MOE_SERVE_LAYERS = 12
# the MoE training phase's depth cut (full width): a full-depth step runs
# about 7,300 host-dispatched GEMM launches
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS = {"psq": 2, "bhq": 1}
# the profiled decode steps' kernels: the forward GEMMs (fused and packed)
# and the dense KV read
MOE_SHARE = ("qlhs", "kv_dequant")


def moe_workload(cfg, seed):
    """The 16 MoE requests: prompts of 16-128 tokens from the seed,
    ``max_new=MOE_NEW_TOKENS``, greedy but for every fifth (temperature
    0.8, top-k 40)."""
    return [(p, dict(kw, max_new=MOE_NEW_TOKENS))
            for p, kw in granite_workload(cfg, seed)]


def _moe_sites(kw):
    """The kernels an MoE engine built with ``kw`` launches, as (module
    that calls it, name there, plain version): its forward GEMM and its
    KV read."""
    from repro_torch.kernels import (fused_qlhs_matmul_plain,
                                     fused_qlhs_packed_matmul_plain,
                                     kv_dequant_rows_kv_plain,
                                     kv_gather_pages_kv_plain)
    backend = "repro_torch.core.backend"
    gemm = ((backend, "fused_qlhs_packed_matmul",
             fused_qlhs_packed_matmul_plain) if kw.get("weight_bits")
            else (backend, "fused_qlhs_matmul", fused_qlhs_matmul_plain))
    kv = (("repro_torch.layers.attention", "kv_gather_pages_kv",
           kv_gather_pages_kv_plain) if kw.get("paged")
          else ("repro_torch.core.kv_cache", "kv_dequant_rows_kv",
                kv_dequant_rows_kv_plain))
    return [gemm, kv]


def _engine_vs_plain(torch, make, requests, sites, main_shapes, tag):
    """``requests`` through an engine from ``make()``, then through another
    with each kernel of ``sites`` replaced by its plain version, on the
    card: the same tokens, and the logits of every forward bit for bit.
    The run through the kernels must hand each kernel every argument shape
    that ``main_shapes`` saw it given on the main path."""
    def run(plain):
        eng = make()
        logits = _record_forwards(eng)
        seen = {name: set() for _, name, _ in sites}
        with _in_contexts(_swapped(name, fn, module) if plain
                          else _shape_spy(name, module, seen[name])
                          for module, name, fn in sites):
            for prompt, kw in requests:
                eng.submit(prompt, **kw)
            done = eng.run()
        torch.cuda.synchronize()
        return {r: c.tokens for r, c in done.items()}, logits, seen

    tok_k, log_k, seen = run(False)
    tok_p, log_p, _ = run(True)
    same = len(log_k) == len(log_p) and all(
        torch.equal(a, b) for a, b in zip(log_k, log_p))
    names = [name for _, name, _ in sites]
    log(f"[{tag}] {len(requests)} requests through {names} and through "
        f"their plain versions: tokens equal {tok_k == tok_p}, logits of all "
        f"{len(log_k)} forwards bit-identical {same}; argument shapes "
        f"{ {n: len(seen[n]) for n in names} } (main path "
        f"{ {n: len(main_shapes[n]) for n in names} })")
    check(tok_k == tok_p and same, f"{tag}: the kernels differ from their "
                                   f"plain versions")
    for n in names:
        check(main_shapes[n] <= seen[n],
              f"{tag}: the replay misses {n}'s main-path shapes "
              f"{main_shapes[n] - seen[n]}")
    return dict(requests=len(requests), forwards=len(log_k),
                shapes={n: len(seen[n]) for n in names},
                tokens_equal=True, logits_bit_identical=True)


def serve_moe(torch, seed, report):
    """[moe serve]: granite-moe-1b-a400m at full width (d=1024, 32 experts
    top-8, d_ff 512), its depth cut from 24 to MOE_SERVE_LAYERS (12)
    layers (random weights from the seed), through ``ServeEngine`` with 8
    slots, ``max_seq=256`` and int8
    KV: dense lanes, paged (pages of 16) and ``weight_bits=4``, the 16
    requests of ``moe_workload`` each.

    Checked: exact launch counts (every layer's router and all 32 experts'
    three GEMMs run on every forward, static shapes); every request
    completes in the vocabulary; the paged engine's tokens equal the dense
    engine's, or part at a near-tie (``_explain_divergence``); for each
    engine, one request of each prefill bucket through the kernels and
    through their plain versions gives the same tokens and the same logits
    of every forward, bit for bit, and hands each kernel every argument
    shape the main run did (``_engine_vs_plain``); every quantized GEMM of
    one full-width prefill within tolerance of ``simulate`` on the input
    the kernel path gave it (``_full_width_vs_simulate``).  Printed:
    tok/s, p50/p95 decode-step wall, the resident GEMM-weight bytes, one
    profiled decode step of the dense and of the 4-bit engine, the 4-bit
    engine's token agreement with the dense one."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import _bucket
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = build_model(cfg).init(seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(t.shape)) for t in _leaves(params))
    log(f"[moe serve] {cfg.name} full width, depth cut {full.n_layers} -> "
        f"{cfg.n_layers} layers, {cfg.moe_experts} experts "
        f"top-{cfg.moe_topk}, "
        f"{n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f}s")
    policy = QuantPolicy.qat(backend="kernel")
    workload = moe_workload(cfg, seed)
    # the replay's requests: the first prompt of each prefill bucket
    firsts = {}
    for prompt, _ in workload:
        firsts.setdefault(_bucket(len(prompt)), prompt)
    replay = [(firsts[b], dict(max_new=3)) for b in sorted(firsts)]
    per_fwd = _gemms_per_forward(cfg)
    res, tokens, seen = {}, {}, {}

    def make(**kw):
        return ServeEngine(cfg, params, policy=policy, slots=8, max_seq=256,
                           kv_quant=True, seed=seed, device="cuda", **kw)

    def serve(tag, **kw):
        t0 = time.perf_counter()
        eng = make(**kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        for prompt, skw in workload:
            eng.submit(prompt, **skw)
        rec = _record_sampling_logits(eng)
        paged = kw.get("paged", False)
        f0 = eng.paged_forwards if paged else 0
        sites = _moe_sites(kw)
        shapes = {name: set() for _, name, _ in sites}
        with _in_contexts(_shape_spy(name, module, shapes[name])
                          for module, name, _ in sites):
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _read_counts()
        steps = len(eng.step_times)
        fwd = eng.paged_forwards - f0 if paged else steps
        gemm = ("fused_qlhs_packed_matmul" if kw.get("weight_bits")
                else "fused_qlhs_matmul")
        want = {gemm: per_fwd * (len(workload) + fwd),
                ("kv_gather_pages_kv" if paged else "kv_dequant_rows_kv"):
                    cfg.n_layers * fwd}
        toks = {r: c.tokens for r, c in done.items()}
        n_tok = sum(len(t) for t in toks.values())
        dts = np.asarray([dt for dt, _ in eng.step_times])
        r = dict(requests=len(done), tokens=n_tok, wall_s=wall,
                 tok_per_s=n_tok / wall, decode_steps=steps, forwards=fwd,
                 build_s=build_s,
                 p50_step_ms=float(np.percentile(dts, 50)) * 1e3,
                 p95_step_ms=float(np.percentile(dts, 95)) * 1e3,
                 launches=counts, expected_launches=want,
                 gemm_weight_bytes=_gemm_weight_bytes(eng.params),
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"[moe serve] {tag}: {len(done)} requests, {n_tok} tokens in "
            f"{wall:.2f}s ({r['tok_per_s']:.1f} tok/s), {steps} decode "
            f"steps, p50 {r['p50_step_ms']:.2f} ms p95 "
            f"{r['p95_step_ms']:.2f} ms, GEMM weights "
            f"{r['gemm_weight_bytes'] / 1e9:.3f} GB resident (engine built "
            f"in {build_s:.2f}s), peak {r['peak_mem_gb']:.1f} GB")
        log(f"[moe serve] {tag}: launches {counts} expected {want}")
        _check_counts(counts, want, f"moe serve {tag}")
        check(len(done) == len(workload) and all(
            len(t) == MOE_NEW_TOKENS and all(0 <= v < cfg.vocab_size
                                             for v in t)
            for t in toks.values()),
            f"moe serve {tag}: requests did not complete in the vocabulary")
        r["vs_plain"] = _engine_vs_plain(
            torch, lambda: make(**kw), replay, sites, shapes,
            f"moe serve {tag}")
        res[tag], tokens[tag], seen[tag] = r, toks, rec
        return eng

    # no warm-up: the earlier phases launched every kernel, and requests
    # then take the same ids (and sampling keys) in every engine
    dense = serve("dense")
    res["dense"]["profile_decode_step"] = _profile_decode(
        torch, dense, "moe dense", share=MOE_SHARE)
    del dense
    paged = serve("paged", paged=True, page_size=16)
    res["paged"]["pool"] = paged.pool_stats()
    del paged
    same = tokens["paged"] == tokens["dense"]
    log(f"[moe serve] paged tokens equal the dense engine's: {same}")
    partings = _explain_divergence("moe serve paged", tokens["dense"],
                                   tokens["paged"], seen["dense"],
                                   seen["paged"], cfg.vocab_size)
    res["paged"]["partings"] = partings
    w4 = serve("w4", weight_bits=4)
    res["w4"]["profile_decode_step"] = _profile_decode(
        torch, w4, "moe w4 packed", share=MOE_SHARE)
    del w4
    d = tokens["dense"]
    agree = sum(a == b for r in d for a, b in zip(d[r], tokens["w4"][r]))
    n = sum(len(t) for t in d.values())
    log(f"[moe serve] w4 token agreement with the dense (8-bit) engine: "
        f"{agree}/{n} (measured, not held: 4-bit weights are another "
        f"model); GEMM weights fp32 {_gemm_weight_bytes(params) / 1e9:.3f}"
        f" GB")
    res["w4"]["dense_token_agreement"] = [agree, n]
    res["gemm_weight_bytes_fp32"] = _gemm_weight_bytes(params)
    res["vs_simulate"] = _full_width_vs_simulate(
        torch, cfg, params, workload[0][0], "moe serve")
    res["launches"] = {k: sum(r["launches"][k] for r in
                              (res["dense"], res["paged"], res["w4"]))
                       for k in res["dense"]["launches"]}
    res["tokens"] = tokens
    report["moe_serve"] = res
    return res


def _train_cut(torch, cfg, full_layers, tag, seed, steps, batch, seq,
               metrics=("loss", "grad_norm"), ranges=()) -> dict:
    """``steps[quant]`` training steps of ``cfg`` (full width, its depth
    cut from ``full_layers``) through the engine ``launch/train.py`` builds
    (AdamW, batch x seq tokens) under ``fqt(psq,8)`` and ``fqt(bhq,5)``.
    Checked: each GEMM launches its forward, dW and dX kernel once a step
    and no other kernel launches; finite losses; the steps replayed
    through the kernels' plain versions give the same ``metrics``; every
    backward GEMM of the first step against ``simulate`` from its (x, w,
    key, g) (``_backward_vs``).  Printed: the metrics, the step wall, and
    one profiled ``fqt(psq,8)`` step."""
    import numpy as np
    n = _gemms_per_forward(cfg)
    res, total = {}, {}
    for quant, bits in (("psq", 8), ("bhq", 5)):
        k = steps[quant]
        qtag = f"{tag} {quant}{bits}"
        eng = _train_engine(cfg, quant, bits, "kernel", seed, steps=k,
                            batch=batch, seq=seq)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        want = {"fused_qlhs_matmul": n * k, "fused_qboth_tn_matmul": n * k,
                ("fused_qlhs_matmul_dx" if quant == "psq" else "q8_matmul"):
                    n * k}
        log(f"[{qtag}] {cfg.name} full width (d={cfg.d_model}), depth cut "
            f"{full_layers} -> {cfg.n_layers} layers: {k} step(s) of "
            f"{batch} x {seq} tokens in {wall:.2f}s, launches {counts} "
            f"expected {want}")
        _check_counts(counts, want, qtag)
        for name, c in counts.items():
            total[name] = total.get(name, 0) + c
        losses = [loss for _, loss in history]
        check(len(losses) == k and all(np.isfinite(v) for v in losses),
              f"{qtag}: losses {losses}")
        kern = _replay(torch, eng, k, metrics)
        check([r[0] for r in kern] == losses,
              f"{qtag}: the engine's run and its replay differ: {losses} "
              f"vs {[r[0] for r in kern]}")
        plain = _replay_plain(torch, eng, k, metrics)
        log(f"[{qtag}] {metrics} a step through the kernels {kern}, "
            f"through their plain versions {plain}")
        check(kern == plain, f"{qtag}: the steps through the kernels differ "
                             f"from the plain versions")
        gemms = _backward_vs(torch, eng, quant, bits, qtag)
        res[quant] = dict(wall_s=wall, step_s=wall / k, launches=counts,
                          expected_launches=want, kernel=kern, plain=plain,
                          backward_gemms_vs_simulate=gemms,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        if quant == "psq":
            res[quant]["profile_step"] = _profile(
                torch, _one_step(eng), f"one training step, {qtag}",
                ranges=ranges)
        del eng
    res["launches"] = total
    res["layers"] = [full_layers, cfg.n_layers]
    return res


def train_moe(torch, seed, report):
    """[moe train]: granite-moe-1b-a400m at full width, depth cut to
    MOE_TRAIN_LAYERS layers, batch 8 x seq 64, AdamW, through the engine
    ``launch/train.py`` builds: MOE_TRAIN_STEPS steps under ``fqt(psq,8)``
    and ``fqt(bhq,5)`` (``_train_cut``: exact launch counts for attention,
    router, every expert's gate/up/down and lm_head; finite losses; loss,
    ``aux`` and gradient norm identical through the plain versions; every
    backward GEMM of the first step against ``simulate``; the step wall
    and one profiled ``fqt(psq,8)`` step)."""
    from repro_torch.configs import get_config
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    res = _train_cut(torch, cfg, full.n_layers, "moe train", seed,
                     MOE_TRAIN_STEPS, 8, 64, ("loss", "aux", "grad_norm"))
    report["moe_train"] = res
    return res


# ---------------------------------------------------------------------------
# the VLM, Mamba2-hybrid and RWKV6 families
# ---------------------------------------------------------------------------

FAMILY_NEW_TOKENS = 8
FAMILY_TRAIN_STEPS = {"psq": 2, "bhq": 1}
# prompts (batch, length) served at full width and depth; the training
# phase's depth cut (full width) and (batch, seq).  The hybrid's prompts
# are two 128-token SSD chunks, so the inter-chunk recurrence runs; its
# training keeps two outer blocks, so the shared block's gradient sums
# two uses.
FAMILIES = {
    "vlm": dict(arch="qwen2-vl-2b", prompt=(4, 128), train_layers=4,
                train=(4, 64), ranges=("fp[attn.sdpa]",)),
    "hybrid": dict(arch="zamba2-2.7b", prompt=(4, 256), train_layers=12,
                   train=(2, 128),
                   ranges=("fp[mamba.ssd]", "fp[attn.sdpa]")),
    "rwkv": dict(arch="rwkv6-1.6b", prompt=(4, 64), train_layers=4,
                 train=(2, 64),
                 ranges=("fp[rwkv.wkv]", "fp[rwkv.ddlerp]",
                         "fp[rwkv.decay]")),
    # 1,500 stub frames a row, and every GEMM of one prefill held to
    # ``simulate``; training cuts the encoder and the decoder to 2 layers
    # each (at 4 + 4 the whole run took 1,156 s of its 1,200 on an NVIDIA
    # H100 80GB HBM3 at 700 W)
    "audio": dict(arch="whisper-medium", prompt=(4, 32), train_layers=2,
                  train=(2, 64), ranges=("fp[attn.sdpa]",),
                  vs_simulate=True),
}
# the vlm phase's decode steps on the int8 cache (each slot from its own
# position) and its paged chunk (16 tokens, 16-row pages)
VLM_INT8_STEPS = 8
VLM_INT8_START = (0, 5, 17, 40)
VLM_PAGE, VLM_CHUNK = 16, 16
# the profiled decode steps' forward GEMMs
FAMILY_SHARE = "qlhs"


# the phases ``--phases`` can run alone
ONLY_PHASES = {"vlm": "vlm_phase", "hybrid": "hybrid_phase",
               "rwkv": "rwkv_phase", "audio": "audio_phase",
               "moe_serve": "serve_moe",
               "moe_train": "train_moe", "dist": "dist_phase",
               "dryrun": "dryrun_phase", "autotune": "autotune_phase",
               "audit": "audit_phase"}


def family_config(arch, layers=None):
    """``arch`` at full width, its depth cut to ``layers`` if given (an
    encoder-decoder's encoder too)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is None:
        return cfg
    cut = dataclasses.replace(cfg, n_layers=layers)
    if cfg.enc_layers:
        cut = dataclasses.replace(cut, enc_layers=layers)
    return cut


def _vlm_prompt(torch, cfg, B, T, seed):
    """Stub vision-frontend prompts: ``embeds`` (B, T, d) random from the
    seed, and M-RoPE ``positions`` (3, B, T) with distinct axes: four
    frames of a 4 x 4 patch grid (t, h, w), then text, whose three axes
    advance together from the grid's largest position + 1."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    embeds = torch.randn((B, T, cfg.d_model), generator=gen,
                         device="cuda") * 0.02
    n_img = min(64, T)
    i = torch.arange(n_img)
    pos = torch.empty((3, T), dtype=torch.int64)
    pos[0, :n_img], pos[1, :n_img], pos[2, :n_img] = (i // 16,
                                                     (i % 16) // 4, i % 4)
    pos[:, n_img:] = 4 + torch.arange(T - n_img)
    return {"embeds": embeds,
            "positions": pos[:, None].expand(3, B, T).contiguous().to(
                "cuda")}


def _token_prompt(torch, cfg, B, T, seed):
    """Random prompt tokens (B, T) from the seed; for an encoder-decoder
    also the stub audio frontend's ``frames`` (B, enc_seq, d)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (B, T),
                                      generator=gen, device="cuda")}
    if cfg.family == "audio":
        prompt["frames"] = torch.randn((B, cfg.enc_seq, cfg.d_model),
                                       generator=gen, device="cuda") * 0.02
    return prompt


def _family_sites(vlm):
    """The serving path's kernels as (module that calls it, name there,
    plain version): the forward GEMM, and a VLM's KV reads (dense int8
    cache and page pool)."""
    from repro_torch.kernels import (fused_qlhs_matmul_plain,
                                     kv_dequant_rows_kv_plain,
                                     kv_gather_pages_kv_plain)
    sites = [("repro_torch.core.backend", "fused_qlhs_matmul",
              fused_qlhs_matmul_plain)]
    if vlm:
        sites += [("repro_torch.core.kv_cache", "kv_dequant_rows_kv",
                   kv_dequant_rows_kv_plain),
                  ("repro_torch.layers.attention", "kv_gather_pages_kv",
                   kv_gather_pages_kv_plain)]
    return sites


def _decode_batch(cfg, params, tok):
    """One decode step's input for the greedy tokens ``tok`` (B,): a VLM's
    token embeddings (the stub frontend), else the tokens."""
    if cfg.family == "vlm":
        return {"embeds": params["embed"]["table"][tok][:, None]}
    return {"tokens": tok[:, None]}


def _family_serve(torch, cfg, params, prompt, tag, ranges=()) -> dict:
    """Serve ``prompt`` at full width and depth under ``qat`` on the
    ``kernel`` backend: prefill, ``generate`` FAMILY_NEW_TOKENS tokens
    and, for a VLM, VLM_INT8_STEPS decode steps on the int8 cache and one
    paged chunk.  Checked: exact launch counts; finite logits, tokens in
    the vocabulary; the same sequence with every kernel of the path
    swapped for its plain version (on the card) gives bit-identical
    logits and equal tokens, and hands each kernel every argument shape
    the kernel run did.  Printed: prefill wall, ``generate``'s tok/s, one
    profiled decode step."""
    import numpy as np
    from repro_torch.core import QuantPolicy
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    model = build_model(cfg)
    policy = QuantPolicy.qat(backend="kernel")
    vlm = cfg.family == "vlm"
    B, T = (prompt["tokens"] if "tokens" in prompt
            else prompt["embeds"]).shape[:2]
    max_seq = T + FAMILY_NEW_TOKENS + 8
    sites = _family_sites(vlm)

    def run(plain):
        seen = {name: set() for _, name, _ in sites}

        def contexts():
            for module, name, fn in sites:
                if plain:
                    yield _swapped(name, fn, module)
                yield _shape_spy(name, module, seen[name])
        out = {}
        with _in_contexts(contexts()), torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = model.prefill(params, prompt, policy, max_seq)
            torch.cuda.synchronize()
            out["prefill_s"] = time.perf_counter() - t0
            out["logits"] = [logits.clone()]
            t0 = time.perf_counter()
            toks = generate(model, params, prompt, policy,
                            max_new=FAMILY_NEW_TOKENS, max_seq=max_seq)
            torch.cuda.synchronize()
            out["generate_s"] = time.perf_counter() - t0
            out["tokens"] = toks.tolist()
            if vlm:
                cache = model.init_cache_quant(cfg, B, max_seq,
                                               device="cuda")
                start = torch.tensor(VLM_INT8_START[:B], device="cuda")
                embeds = prompt["embeds"]
                for i in range(VLM_INT8_STEPS):
                    logits, cache = model.decode(
                        params, cache, {"embeds": embeds[:, i:i + 1]},
                        policy, positions=start + i, kv_quant=True)
                    out["logits"].append(logits.clone())
                nb = max_seq // VLM_PAGE
                pool = model.init_paged_pool(cfg, B * nb + 1, VLM_PAGE,
                                             device="cuda")
                table = torch.arange(1, B * nb + 1, dtype=torch.int32,
                                     device="cuda").reshape(B, nb)
                logits, _ = model.paged_decode(
                    params, pool, {"embeds": embeds[:, :VLM_CHUNK]},
                    policy, table, torch.zeros((B,), dtype=torch.int32,
                                               device="cuda"))
                out["logits"].append(logits.clone())
        torch.cuda.synchronize()
        return out, seen

    _reset_counts()
    main, shapes = run(False)
    counts = _read_counts()
    fwds = 2 + (VLM_INT8_STEPS + 1 if vlm else 0)
    want = {"fused_qlhs_matmul": _gemms_per_forward(cfg) * fwds
            + _decode_gemms(cfg) * FAMILY_NEW_TOKENS}
    if vlm:
        want.update(kv_dequant_rows_kv=cfg.n_layers * VLM_INT8_STEPS,
                    kv_gather_pages_kv=cfg.n_layers)
    enc = (f"{cfg.enc_layers} encoder layers over {cfg.enc_seq} frames, "
           if cfg.family == "audio" else "")
    log(f"[{tag}] {cfg.name} full width and depth ({enc}{cfg.n_layers} "
        f"layers, d={cfg.d_model}): prefill {B} x {T} in "
        f"{main['prefill_s']:.3f}s, "
        f"generate {FAMILY_NEW_TOKENS} tokens in {main['generate_s']:.3f}s "
        f"({B * FAMILY_NEW_TOKENS / main['generate_s']:.1f} tok/s); "
        f"launches {counts} expected {want}")
    _check_counts(counts, want, tag)
    check(all(bool(torch.isfinite(x).all()) for x in main["logits"]),
          f"{tag}: non-finite logits")
    check(all(0 <= v < cfg.vocab_size for row in main["tokens"]
              for v in row), f"{tag}: tokens outside the vocabulary")
    plain, pshapes = run(True)
    same = all(torch.equal(a, b) for a, b in zip(main["logits"],
                                                 plain["logits"]))
    names = [name for _, name, _ in sites]
    log(f"[{tag}] through {names} and through their plain versions: tokens "
        f"equal {main['tokens'] == plain['tokens']}, logits of all "
        f"{len(main['logits'])} checked forwards bit-identical {same}; "
        f"argument shapes { {n: len(shapes[n]) for n in names} } (replay "
        f"{ {n: len(pshapes[n]) for n in names} })")
    check(same and main["tokens"] == plain["tokens"],
          f"{tag}: the kernels differ from their plain versions")
    for n in names:
        check(shapes[n] <= pshapes[n], f"{tag}: the replay misses {n}'s "
                                       f"shapes {shapes[n] - pshapes[n]}")
    # one decode step from a prefilled cache, profiled
    with torch.no_grad():
        logits, cache = model.prefill(params, prompt, policy, max_seq)
        dbatch = _decode_batch(cfg, params, logits[:, -1].argmax(-1))
        prof = _profile(torch, lambda: model.decode(params, cache, dbatch,
                                                    policy),
                        f"one decode step ({B} rows, {tag})", FAMILY_SHARE,
                        ranges)
    return dict(prompt=[B, T], prefill_s=main["prefill_s"],
                generate_s=main["generate_s"],
                tok_per_s=B * FAMILY_NEW_TOKENS / main["generate_s"],
                launches=counts, expected_launches=want,
                shapes={n: len(shapes[n]) for n in names},
                tokens=main["tokens"], profile_decode_step=prof,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def _family_phase(torch, seed, report, name) -> dict:
    """[``name``]: FAMILIES[name]'s model at full width and depth, random
    weights from the seed, served (``_family_serve``), then trained at
    full width with its depth cut (``_train_cut``); with ``vs_simulate``
    in its FAMILIES entry, every GEMM of one prefill is also held to
    ``simulate`` (``_gemms_vs_simulate``).  Returns the launches of
    both."""
    import numpy as np
    spec = FAMILIES[name]
    cfg = family_config(spec["arch"])
    t0 = time.perf_counter()
    from repro_torch.core import QuantPolicy
    from repro_torch.models import build_model
    params = build_model(cfg).init(seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(t.shape)) for t in _leaves(params))
    log(f"[{name}] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f}s")
    B, T = spec["prompt"]
    prompt = (_vlm_prompt if cfg.family == "vlm" else _token_prompt)(
        torch, cfg, B, T, seed)
    serve = _family_serve(torch, cfg, params, prompt, name, spec["ranges"])
    if spec.get("vs_simulate"):
        n = _gemms_per_forward(cfg)
        _, worst = _gemms_vs_simulate(
            torch, lambda: build_model(cfg).prefill(
                params, prompt, QuantPolicy.qat(backend="kernel")), n, name)
        log(f"[{name}] kernel vs simulate, full width and depth: all {n} "
            f"GEMMs of one prefill on shared inputs max|d|={worst:.3g} "
            f"(checked, rtol {RTOL}, atol {ATOL})")
        serve["vs_simulate"] = dict(gemms=n, gemms_max_abs_diff=worst)
    del params, prompt
    torch.cuda.empty_cache()
    train = _train_cut(torch, family_config(spec["arch"],
                                            spec["train_layers"]),
                       cfg.n_layers, f"{name} train", seed,
                       FAMILY_TRAIN_STEPS, *spec["train"],
                       ranges=spec["ranges"])
    torch.cuda.empty_cache()
    launches = {k: serve["launches"][k] + train["launches"][k]
                for k in serve["launches"]}
    report[name] = dict(serve=serve, train=train, launches=launches,
                        params=n_params)
    return launches


def vlm_phase(torch, seed, report):
    """[vlm]: qwen2-vl-2b (M-RoPE, stub vision embeddings) at full width
    and depth: prefill 4 prompts of 128 stub embeddings whose positions
    span a patch grid, ``generate``, decode steps on the int8 cache and a
    paged chunk (the KV kernels read M-RoPE-rotated rows); training at
    full width, 4 layers, 4 x 64 tokens."""
    return _family_phase(torch, seed, report, "vlm")


def hybrid_phase(torch, seed, report):
    """[hybrid]: zamba2-2.7b (Mamba2 with the shared attention block) at
    full width and depth (9 outer blocks of 6 Mamba2 layers): prefill 4
    prompts of 256 tokens (two SSD chunks), ``generate``; training at full
    width, 12 layers (2 outer blocks), 2 x 128 tokens."""
    return _family_phase(torch, seed, report, "hybrid")


def rwkv_phase(torch, seed, report):
    """[rwkv]: rwkv6-1.6b at full width and depth: prefill 4 prompts of
    64 tokens, ``generate``; training at full width, 4 layers, 2 x 64
    tokens."""
    return _family_phase(torch, seed, report, "rwkv")


def audio_phase(torch, seed, report):
    """[audio]: whisper-medium (encoder-decoder, cross-attention, stub
    frames) at full width and depth (24 + 24 layers): prefill 4 rows of
    1,500 frames and 32-token prompts, ``generate`` (decode steps feed
    tokens and read the cross-attention's K/V from the cache), every GEMM
    of one prefill against ``simulate``; training at full width, 2 + 2
    layers, 2 x 1,500 frames and 64 tokens."""
    return _family_phase(torch, seed, report, "audio")


OPS_QLINEAR_MKN = (512, 512, 10240)     # statquant-tx's lm_head forward
OPS_BWD_MKN = (512, 512, 512)


def ops_phase(torch, seed, report) -> dict:
    """[ops]: the standalone ops of ``kernels/ops.py`` through the kernels
    against the same ops through the plain versions, on the card, bit for
    bit: ``fused_qlinear`` at statquant-tx's lm_head shape (one
    ``quantize_sr_rows`` and one ``q8_matmul`` launch a call; codes,
    scales and ``y``), ``fused_qlinear_bwd`` under ``ptq``, ``psq`` and
    ``bhq`` (bhq_block 256) at a 512-wide shape (dW and dX)."""
    from repro_torch import prng
    from repro_torch.kernels import (ops, q8_matmul_plain,
                                     quantize_sr_rows_plain,
                                     quantize_sr_tensor_plain)
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    M, K, N = OPS_QLINEAR_MKN
    x = torch.randn((M, K), generator=gen, device="cuda")
    w = torch.randn((K, N), generator=gen, device="cuda") * 0.05
    key = prng.PRNGKey(seed + 21)
    _reset_counts()
    y, aux = ops.fused_qlinear(x, w, key)
    counts = _read_counts()
    check(counts["quantize_sr_rows"] == 1 and counts["q8_matmul"] == 1
          and sum(counts.values()) == 2,
          f"ops: fused_qlinear launched {counts}, not one quantize_sr_rows "
          f"and one q8_matmul")
    y_p, aux_p = ops.fused_qlinear(x, w, key, use_kernels=False)
    same = torch.equal(y, y_p) and all(torch.equal(aux[k], aux_p[k])
                                       for k in aux)
    err = {"fused_qlinear": float((y - y_p).abs().max())}
    log(f"[ops] fused_qlinear {OPS_QLINEAR_MKN} kernels vs plain: codes, "
        f"scales and y bit-identical {same} (max|d| "
        f"{err['fused_qlinear']:.3g}); vs x @ w max rel |d| "
        f"{float((y - x @ w).abs().max() / (x @ w).abs().max()):.3g}")
    check(same, "ops: fused_qlinear through the kernels differs from the "
                "plain versions")
    M, K, N = OPS_BWD_MKN
    x = torch.randn((M, K), generator=gen, device="cuda")
    w = torch.randn((K, N), generator=gen, device="cuda") * 0.05
    g = torch.randn((M, N), generator=gen, device="cuda") * 1e-3
    for quant in ("ptq", "psq", "bhq"):
        kb = prng.fold_in(key, 3)
        _reset_counts()
        dw, dx = ops.fused_qlinear_bwd(x, w, g, kb, grad_quantizer=quant,
                                       bhq_block=256)
        counts = _read_counts()
        with _swapped("q8_matmul", q8_matmul_plain), \
                _swapped("quantize_sr_rows", quantize_sr_rows_plain), \
                _swapped("quantize_sr_tensor", quantize_sr_tensor_plain):
            dw_p, dx_p = ops.fused_qlinear_bwd(x, w, g, kb,
                                               grad_quantizer=quant,
                                               bhq_block=256)
        same = torch.equal(dw, dw_p) and torch.equal(dx, dx_p)
        err[f"bwd_{quant}"] = max(float((dw - dw_p).abs().max()),
                                  float((dx - dx_p).abs().max()))
        want_sr = {"ptq": 2, "psq": 2, "bhq": 1}[quant]
        log(f"[ops] fused_qlinear_bwd {quant} {OPS_BWD_MKN}: launches "
            f"{ {k: v for k, v in counts.items() if v} }; dW and dX through "
            f"the kernels vs plain bit-identical {same}")
        check(counts["q8_matmul"] == 2 and counts["quantize_sr_tensor"]
              + counts["quantize_sr_rows"] == want_sr,
              f"ops: fused_qlinear_bwd {quant} launched {counts}")
        check(same, f"ops: fused_qlinear_bwd {quant} through the kernels "
                    f"differs from the plain versions")
    report["ops"] = dict(max_abs_err=err)
    return err


# ---------------------------------------------------------------------------
# distribution: a one-rank NCCL mesh against the flat step
# ---------------------------------------------------------------------------

DIST_STEPS = 3
DIST_UNFUSED_STEPS = 2
DIST_WALL_PAIRS = 6
DIST_COMPRESS_STEPS = 2
DIST_CHUNKS = 4
DIST_CHUNK_STEPS = 2
# the compressed exchange's quantize shapes: at one rank each leaf is one
# row (lm_head's 512 x 10,240 and a 512 x 512 projection); at 4 ranks
# lm_head's phase-1 matrix is (4, size / 4)
DIST_SR_SHAPES = [(1, 512 * 10240), (4, 512 * 10240 // 4), (1, 512 * 512)]


def _alternating_walls_ms(torch, steps, n: int) -> list:
    """Each of ``steps``' wall times in ms, ``n`` rounds of one call of
    each in turn after one warm-up round."""
    walls = [[] for _ in steps]
    for r in range(n + 1):
        for w, step in zip(walls, steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            if r:
                w.append((time.perf_counter() - t0) * 1e3)
    return walls


def _recording(eng):
    """Wrap ``eng``'s step so it keeps each step's (loss, grad norm);
    returns the list it fills."""
    rec, inner = [], eng.step_fn

    def step(state, batch):
        state, m = inner(state, batch)
        rec.append((m["loss"].clone(), m["grad_norm"].clone()))
        return state, m
    eng.step_fn = step
    return rec


def _full_params(state) -> dict:
    """``{path: full tensor}`` of a state's parameters and AdamW moments
    (``DTensor`` shards gathered)."""
    out = {}
    for name, tree in (("params", state.params),
                       ("m", state.opt_state["m"]),
                       ("v", state.opt_state["v"])):
        for path, p in _named_leaves(tree):
            full = p.full_tensor() if hasattr(p, "full_tensor") else p
            out[f"{name}/{path}"] = full.clone()
    return out


def _stepwise(eng, steps: int):
    """``eng.run`` one step at a time: each step's (loss, grad norm) and
    the parameters and moments after it."""
    rec, snaps = _recording(eng), []
    for s in range(1, steps + 1):
        eng.run(steps=s)
        snaps.append(_full_params(eng.state))
    return rec, snaps


def _dist_engine(cfg, quant, bits, seed, steps, mesh=None, **kw):
    """``_train_engine``'s engine (statquant-tx, 8 x 64 tokens, AdamW) on
    ``mesh`` (None: flat)."""
    from repro_torch.engine import Engine
    fused = kw.pop("fused", None)
    return Engine(cfg, _train_policy(quant, bits, "kernel", fused),
                  steps=steps, batch_size=8, seq_len=64, seed=seed,
                  device="cuda", log_every=100, log_fn=None, mesh=mesh,
                  **kw)


def _mesh_vs_flat(torch, cfg, quant, bits, seed, steps, mesh, want, tag,
                  fused=None, **kw):
    """``steps`` steps of the mesh engine (launches counted) and of the
    flat engine (both with the engine options ``kw``): losses, grad
    norms, parameters and moments after each step bit-identical."""
    t_all = time.perf_counter()
    meshed = _dist_engine(cfg, quant, bits, seed, steps, mesh, fused=fused,
                          **kw)
    flat = _dist_engine(cfg, quant, bits, seed, steps, fused=fused, **kw)
    built = time.perf_counter() - t_all
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec_m, snaps_m = _stepwise(meshed, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    _check_counts(counts, want, tag)
    t0 = time.perf_counter()
    rec_f, snaps_f = _stepwise(flat, steps)
    torch.cuda.synchronize()
    wall_flat = time.perf_counter() - t0
    metrics_same = all(torch.equal(a, b) for ra, rb in zip(rec_m, rec_f)
                       for a, b in zip(ra, rb))
    differ = [f"step {s}: {k}" for s, (a, b) in enumerate(zip(snaps_m,
                                                             snaps_f))
              for k in a if not torch.equal(a[k], b[k])]
    log(f"[{tag}] mesh (1, 1) on NCCL vs flat, {steps} steps: (loss, grad "
        f"norm) {[(float(l), float(g)) for l, g in rec_m]} vs "
        f"{[(float(l), float(g)) for l, g in rec_f]}; bit-identical "
        f"{metrics_same}, parameters and moments after each step "
        f"{len(snaps_m[0]) * steps - len(differ)} of "
        f"{len(snaps_m[0]) * steps} leaves bit-identical; launches {counts} "
        f"(engines built in {built:.2f}s, mesh {wall:.2f}s, flat "
        f"{wall_flat:.2f}s, in all {time.perf_counter() - t_all:.2f}s)")
    check(len(rec_m) == len(rec_f) == steps and metrics_same,
          f"{tag}: mesh and flat losses or grad norms differ")
    check(not differ, f"{tag}: mesh and flat states differ: {differ[:5]}")
    return meshed, flat, dict(wall_s=wall, flat_wall_s=wall_flat,
                              build_s=built, launches=counts,
                              expected_launches=want,
                              loss_grad_norm=[(float(l), float(g))
                                              for l, g in rec_m])


def dist_phase(torch, seed, report) -> dict:
    """[dist]: a world-size-1 NCCL process group (a ``file://`` store in a
    temporary directory) and a (1, 1) ``("data", "model")`` mesh on
    cuda:0; statquant-tx at full width and depth, 8 x 64 tokens, AdamW, the
    ``kernel`` backend.  Under ``fqt(psq,8)`` and ``fqt(bhq,5)``: 3
    mesh-engine steps (every range all-reduced, the parameters and moments
    ``DTensor`` shards) against 3 flat steps from the same seed, losses,
    grad norms, parameters and moments after each step bit-identical;
    the same for 2 unfused ``fqt(ptq,8)`` steps (``quantize_sr_tensor``
    handed the group's range).  Under ``compress_axis="data"`` (psq8): 2
    steps with exactly 2 ``quantize_sr_rows`` launches a gradient leaf,
    the exchange bit-identical to the same exchange (through NCCL's int8
    all-to-all and all-gather) with the plain quantize.
    ``quantize_sr_tensor`` given the tensor's range bit-identical to its
    in-kernel range at the step's shapes, and given a wider one to its
    plain version.  Times ``quantize_sr_rows`` at the compressed
    exchange's shapes, profiles one mesh step and times it against the
    flat step, the two alternating."""
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import quantize_sr as q
    from repro_torch.launch.mesh import init_distributed, make_test_mesh
    from repro_torch.optim import tree_leaves
    cfg = get_config("statquant-tx")
    n = _gemms_per_forward(cfg)
    res, total = {}, {}
    tmp = tempfile.mkdtemp(prefix="dist_store_")
    t0 = time.perf_counter()
    device = init_distributed("cuda", f"file://{tmp}/store", 0, 1)
    try:
        mesh = make_test_mesh(1, 1, device=device)
        log(f"[dist] process group and mesh {time.perf_counter() - t0:.2f}s")
        for quant, bits in (("psq", 8), ("bhq", 5)):
            tag = f"dist {quant}{bits}"
            want = {"fused_qlhs_matmul": n * DIST_STEPS,
                    "fused_qboth_tn_matmul": n * DIST_STEPS,
                    ("fused_qlhs_matmul_dx" if quant == "psq"
                     else "q8_matmul"): n * DIST_STEPS}
            meshed, flat, res[quant] = _mesh_vs_flat(
                torch, cfg, quant, bits, seed, DIST_STEPS, mesh, want, tag)
            for k, v in res[quant]["launches"].items():
                total[k] = total.get(k, 0) + v
            if quant == "psq":
                # the flat step's profile is [train psq8]'s (the same
                # engine); here its wall beside the mesh step's, the two
                # alternating so that both meet the same host
                t0 = time.perf_counter()
                res["profile_mesh"] = _profile(
                    torch, _one_step(meshed), "one (1, 1) mesh step, psq8")
                walls = _alternating_walls_ms(
                    torch, (_one_step(meshed), _one_step(flat)),
                    DIST_WALL_PAIRS)
                med = [float(np.median(w)) for w in walls]
                res["mesh_vs_flat_wall_ms"] = dict(
                    mesh=med[0], flat=med[1], mesh_walls=walls[0],
                    flat_walls=walls[1])
                log(f"[dist] one step, psq8, mesh and flat alternating "
                    f"{DIST_WALL_PAIRS} times: wall {med[0]:.2f} ms against "
                    f"{med[1]:.2f} (medians; mesh {min(walls[0]):.2f}-"
                    f"{max(walls[0]):.2f}, flat {min(walls[1]):.2f}-"
                    f"{max(walls[1]):.2f}); the profile and walls took "
                    f"{time.perf_counter() - t0:.2f}s")
            del meshed, flat
        want = {"q8_matmul": 3 * n * DIST_UNFUSED_STEPS,
                "quantize_sr_tensor": 2 * n * DIST_UNFUSED_STEPS}
        _, _, res["ptq_unfused"] = _mesh_vs_flat(
            torch, cfg, "ptq", 8, seed, DIST_UNFUSED_STEPS, mesh, want,
            "dist ptq8 unfused", fused=False)
        for k, v in res["ptq_unfused"]["launches"].items():
            total[k] = total.get(k, 0) + v
        # the head loss in DIST_CHUNKS chunks of the global rows: at one
        # rank each chunk is its own, its head GEMM a GEMM of its own
        h = n + DIST_CHUNKS - 1
        want = {"fused_qlhs_matmul": h * DIST_CHUNK_STEPS,
                "fused_qboth_tn_matmul": h * DIST_CHUNK_STEPS,
                "fused_qlhs_matmul_dx": h * DIST_CHUNK_STEPS}
        _, _, res["psq8_chunks"] = _mesh_vs_flat(
            torch, cfg, "psq", 8, seed, DIST_CHUNK_STEPS, mesh, want,
            f"dist psq8 loss_chunks={DIST_CHUNKS}",
            loss_kwargs={"loss_chunks": DIST_CHUNKS})
        for k, v in res["psq8_chunks"]["launches"].items():
            total[k] = total.get(k, 0) + v

        # the compressed exchange: every call recorded, then replayed with
        # the plain quantize
        import repro_torch.core.compression as comp
        calls, wire = [], []
        inner = comp.compressed_grad_allreduce

        def spy(grads, *a, **kw):
            out = inner(grads, *a, **kw)
            calls.append((grads, a, kw, out))
            return out
        send = (dist.all_to_all_single,
                getattr(dist, "all_gather_single", None)
                or dist.all_gather_into_tensor)

        def wired(fn):
            def call(out, x, *a, **kw):
                wire.append(str(x.dtype))
                return fn(out, x, *a, **kw)
            return call
        t_c = time.perf_counter()
        eng = _dist_engine(cfg, "psq", 8, seed, DIST_COMPRESS_STEPS, mesh,
                           compress_axis="data")
        leaves = len(tree_leaves(eng.init_state().params))
        _reset_counts()
        with _swapped("compressed_grad_allreduce", spy,
                      "repro_torch.engine.step"), \
                _swapped("all_to_all_single", wired(send[0]),
                         "torch.distributed"), \
                _swapped(send[1].__name__, wired(send[1]),
                         "torch.distributed"):
            t0 = time.perf_counter()
            history = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = _read_counts()
        want = {"fused_qlhs_matmul": n * DIST_COMPRESS_STEPS,
                "fused_qboth_tn_matmul": n * DIST_COMPRESS_STEPS,
                "fused_qlhs_matmul_dx": n * DIST_COMPRESS_STEPS,
                "quantize_sr_rows": 2 * leaves * DIST_COMPRESS_STEPS}
        _check_counts(counts, want, "dist compressed")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        err = 0.0
        with _swapped("quantize_sr_rows", q.quantize_sr_rows_plain,
                      "repro_torch.core.compression"):
            for grads, a, kw, out in calls:
                plain = inner(grads, *a, **kw)
                for x, y in zip(tree_leaves(out), tree_leaves(plain)):
                    check(torch.equal(x, y), "dist compressed: the exchange "
                          "through quantize_sr_rows differs from the plain "
                          "quantize")
                    err = max(err, float((x - y).abs().max()))
        int8 = sum(d == "torch.int8" for d in wire)
        log(f"[dist compressed] {DIST_COMPRESS_STEPS} steps with "
            f"compress_axis='data': losses {[l for _, l in history]}, "
            f"{leaves} gradient leaves, launches {counts}; the exchange "
            f"through the kernel vs the plain quantize bit-identical on "
            f"{len(calls)} steps; {int8} of {len(wire)} wire tensors int8 "
            f"({wall:.2f}s; in all {time.perf_counter() - t_c:.2f}s)")
        check(len(calls) == DIST_COMPRESS_STEPS and all(
            np.isfinite(l) for _, l in history), "dist compressed: steps")
        check(int8 == 2 * leaves * DIST_COMPRESS_STEPS,
              f"dist compressed: {int8} int8 wire tensors, not 2 a leaf")
        res["compressed"] = dict(wall_s=wall, launches=counts,
                                 expected_launches=want, leaves=leaves,
                                 losses=[l for _, l in history],
                                 wire_dtypes=sorted(set(wire)))
        res["max_abs_err"] = err
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    # quantize_sr_tensor with a given range; the exchange's quantize times
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 24)
    for (M, N) in ((512, 512), (512, 1024), (512, 10240)):
        x, rb = sr_operands(torch, gen, M, N)
        own = torch.stack(list(torch.aminmax(x)))
        wide = own + torch.tensor([-0.5, 0.25], device="cuda")
        a, b = q.quantize_sr_tensor(x, rb, 8), q.quantize_sr_tensor(
            x, rb, 8, own)
        c = q.quantize_sr_tensor(x, rb, 8, wide)
        d = q.quantize_sr_tensor_plain(x, rb, 8, wide)
        same = (all(torch.equal(u, v) for u, v in zip(a, b))
                and all(torch.equal(u, v) for u, v in zip(c, d)))
        log(f"[dist] quantize_sr_tensor {(M, N)}: given its own range vs "
            f"the in-kernel range, and given a wider one vs the plain "
            f"version, bit-identical {same}")
        check(same, f"dist: quantize_sr_tensor's given range at {(M, N)}")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    for (M, N) in DIST_SR_SHAPES:
        x, rb = sr_operands(torch, gen, M, N)
        ms = _time_ms(torch, lambda: q.quantize_sr_rows(x, rb, 8), flush, 20)
        plain = _time_ms(torch, lambda: q.quantize_sr_rows_plain(x, rb, 8),
                         flush, 5)
        bound, by = _bound(13 * M * N + 8 * M, 6 * M * N, FP32_OPS_PER_S)
        plan = q.rows_plan(M, N, q.on_card())
        rows.append(dict(kernel="quantize_sr_rows", shape=[M, N], ms=ms,
                         plain_ms=plain, bound_ms=bound, bound_by=by,
                         plan=str(plan)))
        log(f"[time] quantize_sr_rows {(M, N)} (the compressed exchange): "
            f"kernel {ms:.4f} ms ({plan}), plain {plain:.4f} ms, bound "
            f"{bound:.5f} ms ({by}), {bound / ms:.2f} of it")
    x, rb = sr_operands(torch, gen, 512, 10240)
    own = torch.stack(list(torch.aminmax(x)))
    for label, extra in (("own range", ()), ("given range", (own,))):
        ms = _time_ms(torch, lambda: q.quantize_sr_tensor(x, rb, 8, *extra),
                      flush, 20)
        rows.append(dict(kernel=f"quantize_sr_tensor ({label})",
                         shape=[512, 10240], ms=ms))
        log(f"[time] quantize_sr_tensor (512, 10240), {label}: {ms:.4f} ms")
    del flush
    torch.cuda.empty_cache()
    log(f"[dist] the quantize checks and times {time.perf_counter() - t0:.2f}s")
    res.update(timings=rows, launches=total)
    report["dist"] = res
    return res


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

DRYRUN_BATCH, DRYRUN_SEQ = 8, 64       # the smoke's training shape
DRYRUN_GRANITE_LAYERS = 4
DRYRUN_PROMPT = (4, 64)                # granite's bf16 prefill (B, T)
DRYRUN_DECODE_STEPS = 4


def _gemm_flops_spied(flops: list):
    """A context in which ``core/backend.py``'s GEMM kernels add each
    launch's ``2 M N K`` to ``flops[0]``: the forward and dX
    (``fused_qlhs_matmul``), dW (``fused_qboth_tn_matmul``, contracting
    over its storage rows) and ``q8_matmul``."""
    import repro_torch.core.backend as backend
    qlhs, qboth, q8 = (backend.fused_qlhs_matmul,
                       backend.fused_qboth_tn_matmul, backend.q8_matmul)

    def fwd(xf, *a, **kw):
        y8 = a[3]
        n = y8.shape[0] if kw.get("trans_b") else y8.shape[1]
        flops[0] += 2 * xf.shape[0] * xf.shape[1] * n
        return qlhs(xf, *a, **kw)

    def tn(af, *a, **kw):
        flops[0] += 2 * af.shape[0] * af.shape[1] * a[2].shape[1]
        return qboth(af, *a, **kw)

    def mm(x8, y8, *a, **kw):
        flops[0] += 2 * x8.shape[0] * x8.shape[1] * y8.shape[1]
        return q8(x8, y8, *a, **kw)
    return _in_contexts([_swapped("fused_qlhs_matmul", fwd),
                         _swapped("fused_qboth_tn_matmul", tn),
                         _swapped("q8_matmul", mm)])


def _busy_ms(torch, fn):
    """``fn()`` and the device's busy time in it: the sum of its kernels'
    time in one ``torch.profiler`` run, read from the raw events (the sum
    of ``_event_averages``' device rows, without building its tree)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum((e.end_ns() - e.start_ns()) / 1e6
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA
                    and not e.is_user_annotation()
                    and not e.is_hidden_event()
                    and e.name() not in _UNLISTED_EVENTS)


def _dryrun_train(torch, seed, quant, bits, remat):
    """One statquant-tx step (full width and depth, the smoke's 8 x 64
    tokens, AdamW, float32 activations) under ``fqt(quant, bits)`` on the
    ``kernel`` backend: its dry run on the meta device, and the step on
    the card from the engine's initial state, its launches counted, its
    GEMM FLOPs (the kernels' launches and the attention's ``bmm``), peak
    memory and busy time (one profile) measured.  Returns (record, measured, the parameters and
    moments after it and its loss and grad norm, on the host)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.engine import Engine
    from repro_torch.launch import dryrun
    from repro_torch.optim import tree_leaves
    cfg = family_config("statquant-tx")
    pol = _train_policy(quant, bits, "kernel")
    eng = Engine(cfg, pol, steps=1, batch_size=DRYRUN_BATCH,
                 seq_len=DRYRUN_SEQ, seed=seed, device="cuda", remat=remat,
                 log_every=100, log_fn=None)
    shape = ShapeSpec("smoke_train", DRYRUN_SEQ, DRYRUN_BATCH, "train")
    rec = dryrun.run_cell("statquant-tx", shape.name, shape=shape, mesh=None,
                          policy=pol, remat=remat, loss_chunks=1,
                          opt=eng.opt, dtype=torch.float32, verbose=False)
    state, batch = eng.init_state(), eng.loader.get(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    flops, counter = [0], dryrun.Counter(gemms_only=True)

    def step():
        with _gemm_flops_spied(flops), counter:
            return eng.step_fn(state, batch)
    _reset_counts()
    (state, mets), busy = _busy_ms(torch, step)
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    measured = dict(gemm_flops=flops[0] + counter.gemm_flops,
                    kernel_gemm_flops=flops[0],
                    aten_gemm_flops=counter.gemm_flops,
                    peak_bytes=peak, resident_bytes=base, busy_ms=busy,
                    launches=counts)
    # the state and metrics to the host, so the next run meets the card
    # as empty as this one did
    after = [t.cpu() for t in tree_leaves(state.params)
             + tree_leaves(state.opt_state) if isinstance(t, torch.Tensor)]
    mets = {k: mets[k].cpu() for k in ("loss", "grad_norm")}
    del eng, state, batch, counter
    torch.cuda.empty_cache()
    return rec, measured, after, mets


def dryrun_phase(torch, seed, report) -> dict:
    """[dryrun]: the port's dry run (``launch/dryrun.py``) beside the card.

    statquant-tx at the smoke's training shape under ``fqt(psq,8)`` and
    ``fqt(bhq,5)``, ``remat`` off and on: the dry run's GEMM FLOPs equal
    to the step's on the card (its GEMM kernels' launches, recorded, and
    the attention's ``bmm``s), exactly; its peak of live bytes above the
    resident state beside ``torch.cuda.max_memory_allocated`` of the step
    above what was allocated when it began (the ratio printed);
    its roofline bound (``launch/roofline.py``: the H100's int8 peak, and
    its HBM rate over the least bytes a step moves) beside the step's
    busy time on the card (the share printed).  The remat step against the stored one: loss, grad norm and
    every parameter and moment bit-identical, its launches exact (each
    layer's forward GEMMs but its last run again) and its peak lower.
    granite-3-2b at full width and 4 layers: a bfloat16 prefill and 4
    decode steps on a bfloat16 cache through the int8 forward, logits and
    cache bit-identical to the plain replay.  One production cell through
    the CLI (granite-3-2b ``decode_32k``, the 16x16 mesh on a fake
    process group of 256 ranks), its record read back."""
    cfg = family_config("statquant-tx")
    n, L = _gemms_per_forward(cfg), cfg.n_layers
    mlp = 3 if cfg.act == "swiglu" else 2
    res, total = {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    for quant, bits in (("psq", 8), ("bhq", 5)):
        runs = {}
        for remat in (False, True):
            tag = f"dryrun {quant}{bits} remat {'on' if remat else 'off'}"
            t0 = time.perf_counter()
            rec, got, state, mets = _dryrun_train(torch, seed, quant, bits,
                                                  remat)
            pd = rec["per_device"]
            # the backward reads each layer's last GEMM's input, not its
            # output: the recomputation stops before it
            fwd = n + (L * (4 + mlp - 1) if remat else 0)
            want = {"fused_qlhs_matmul": fwd, "fused_qboth_tn_matmul": n,
                    ("fused_qlhs_matmul_dx" if quant == "psq"
                     else "q8_matmul"): n}
            _check_counts(got["launches"], want, tag)
            add(got["launches"])
            bound_ms = rec["roofline"]["step_time_lb_s"] * 1e3
            # what the step adds above what was resident when it began
            # (on the card, also the engines earlier phases keep)
            dry_step = pd["peak_bytes"] - pd["resident_bytes"]
            got["step_bytes"] = got["peak_bytes"] - got["resident_bytes"]
            log(f"[{tag}] GEMM FLOPs: dry run {pd['flops']}, the step on "
                f"the card {got['gemm_flops']} (kernels "
                f"{got['kernel_gemm_flops']}, aten {got['aten_gemm_flops']}"
                f"); peak bytes above the resident ones: dry run {dry_step} "
                f"(peak {pd['peak_bytes']}, resident "
                f"{pd['resident_bytes']}), the card {got['step_bytes']} "
                f"(max_memory_allocated {got['peak_bytes']}, allocated "
                f"before the step {got['resident_bytes']}), ratio "
                f"{dry_step / got['step_bytes']:.3f}; roofline bound "
                f"{bound_ms:.4f} ms ({rec['roofline']['bottleneck']}; "
                f"compute {rec['roofline']['compute_s'] * 1e3:.4f} ms, "
                f"least bytes {pd['bytes_min']} "
                f"{rec['roofline']['memory_s'] * 1e3:.4f} ms; outside the "
                f"bound, the unfused bytes {pd['bytes_accessed']} "
                f"{rec['roofline']['memory_s_unfused'] * 1e3:.4f} ms) "
                f"beside the "
                f"step's busy time {got['busy_ms']:.3f} ms: "
                f"{bound_ms / got['busy_ms']:.4f} of it; launches "
                f"{got['launches']}; dry run {rec['wall_s']:.2f}s "
                f"(in all {time.perf_counter() - t0:.2f}s)")
            check(pd["flops"] == got["gemm_flops"],
                  f"{tag}: the dry run counts {pd['flops']} GEMM FLOPs, the "
                  f"card ran {got['gemm_flops']}")
            runs[remat] = (got, state, mets)
            res[f"{quant}{bits}_remat_{'on' if remat else 'off'}"] = dict(
                record=rec, card=got, bound_ms=bound_ms,
                bound_share=bound_ms / got["busy_ms"],
                step_bytes_ratio=dry_step / got["step_bytes"])
        (g0, s0, m0), (g1, s1, m1) = runs[False], runs[True]
        same = (torch.equal(m0["loss"], m1["loss"])
                and torch.equal(m0["grad_norm"], m1["grad_norm"]))
        leaves = list(zip(s0, s1))
        differ = sum(not torch.equal(a, b) for a, b in leaves)
        log(f"[dryrun {quant}{bits}] remat vs stored: loss and grad norm "
            f"bit-identical {same}, {len(leaves) - differ} of {len(leaves)} "
            f"parameter and moment leaves bit-identical; peak above the "
            f"resident bytes {g1['step_bytes']} against {g0['step_bytes']}")
        check(same and not differ, f"dryrun {quant}{bits}: the remat step "
                                   f"differs from the stored step")
        check(g1["step_bytes"] < g0["step_bytes"],
              f"dryrun {quant}{bits}: the remat step's peak above the "
              f"resident bytes, {g1['step_bytes']}, is not below the stored "
              f"step's {g0['step_bytes']}")
        del runs
    res["granite_bf16"] = _dryrun_granite_bf16(torch, seed, add)
    res["cli"] = _dryrun_cli(torch)
    torch.cuda.empty_cache()
    res["launches"] = total
    report["dryrun"] = res
    return res


def _dryrun_granite_bf16(torch, seed, add) -> dict:
    """granite-3-2b, full width, DRYRUN_GRANITE_LAYERS layers: a bfloat16
    prefill (max_seq = T + DRYRUN_DECODE_STEPS) and DRYRUN_DECODE_STEPS
    decode steps on its bfloat16 cache under ``qat`` on the ``kernel``
    backend (launches counted), then the same with the int8 forward
    swapped for its plain version: logits and the cache bit-identical."""
    from repro_torch.core import QuantPolicy
    from repro_torch.kernels import fused_qlhs_matmul_plain
    from repro_torch.models import build_model
    cfg = family_config("granite-3-2b", DRYRUN_GRANITE_LAYERS)
    model = build_model(cfg)
    params = model.init(seed, device="cuda")
    pol = QuantPolicy.qat(backend="kernel")
    B, T = DRYRUN_PROMPT
    gen = torch.Generator(device="cuda").manual_seed(seed + 25)
    toks = torch.randint(0, cfg.vocab_size, (B, T + DRYRUN_DECODE_STEPS),
                         generator=gen, device="cuda")

    def run():
        logits, cache = model.prefill(params, {"tokens": toks[:, :T]}, pol,
                                      max_seq=T + DRYRUN_DECODE_STEPS,
                                      dtype=torch.bfloat16)
        out = [logits]
        for s in range(DRYRUN_DECODE_STEPS):
            logits, cache = model.decode(
                params, cache, {"tokens": toks[:, T + s:T + s + 1]}, pol)
            out.append(logits)
        return out, cache
    t0 = time.perf_counter()
    _reset_counts()
    logits, cache = run()
    torch.cuda.synchronize()
    counts = _read_counts()
    n = _gemms_per_forward(cfg)
    _check_counts(counts, {"fused_qlhs_matmul":
                           n * (1 + DRYRUN_DECODE_STEPS)}, "dryrun granite")
    add(counts)
    with _swapped("fused_qlhs_matmul", fused_qlhs_matmul_plain):
        plain, plain_cache = run()
    same = all(torch.equal(a, b) for a, b in zip(logits, plain))
    same_cache = all(torch.equal(cache["kv"][s], plain_cache["kv"][s])
                     for s in ("k", "v"))
    dtypes = sorted({str(x.dtype) for x in logits}
                    | {str(cache["kv"][s].dtype) for s in ("k", "v")})
    log(f"[dryrun granite bf16] {DRYRUN_GRANITE_LAYERS} layers, prompts "
        f"{DRYRUN_PROMPT}, {DRYRUN_DECODE_STEPS} decode steps on a bfloat16 "
        f"cache: logits and cache dtypes {dtypes}; launches {counts}; "
        f"logits and cache bit-identical to the plain replay {same} / "
        f"{same_cache} ({time.perf_counter() - t0:.2f}s)")
    check(dtypes == ["torch.bfloat16"], f"dryrun granite: dtypes {dtypes}")
    check(same and same_cache, "dryrun granite: the bf16 prefill and decode "
                               "differ from their plain replay")
    check(all(bool(torch.isfinite(x.float()).all()) for x in logits),
          "dryrun granite: non-finite logits")
    return dict(launches=counts, dtypes=dtypes)


def _dryrun_cli(torch) -> dict:
    """``python -m repro_torch.launch.dryrun --arch granite-3-2b --shape
    decode_32k --mesh single`` (in this process), its record read back;
    the fake process group it starts is ended after."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    out = ROOT / "build" / "dryrun"
    t0 = time.perf_counter()
    try:
        dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                     "--mesh", "single", "--out", str(out)])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    wall = time.perf_counter() - t0
    rec = json.loads((out / "granite-3-2b__decode_32k__single.json")
                     .read_text())
    pd = rec["per_device"]
    log(f"[dryrun cli] granite-3-2b decode_32k on {rec['mesh']} "
        f"({rec['n_chips']} ranks): n_params {rec['n_params']}, per rank "
        f"GEMM FLOPs {pd['flops']}, bytes {pd['bytes_accessed']}, "
        f"collectives {pd['collective_counts']} {pd['collective_bytes']} "
        f"bytes, params {pd['param_bytes']} and cache {pd['state_bytes']} "
        f"bytes resident, peak {pd['peak_bytes']} (fits 80 GB "
        f"{pd['fits_80gb']}); roofline {rec['roofline']}; {wall:.2f}s")
    check(rec["n_chips"] == 256 and pd["flops"] > 0
          and pd["collective_bytes"] > 0, "dryrun cli: the record")
    return dict(record=rec, wall_s=wall)


# ---------------------------------------------------------------------------
# timings
# ---------------------------------------------------------------------------

def _time_ms(torch, fn, flush, iters: int, read_flush=False) -> float:
    """Mean device time of one call of ``fn``: CUDA events around each of
    ``iters`` calls, each after an L2 flush (the serving path meets every
    weight cold: 280 other projections stream through between two uses):
    ``flush.zero_()``, which leaves the L2 full of dirty lines, or with
    ``read_flush`` a read of ``flush``, which leaves it clean.
    All calls are queued behind a spin kernel, so the events time the
    device's work and not the host's dispatch of the call; the spin is
    sized from the host's time to queue a call (measured after warm-up),
    and the check below holds the host to having queued them all before
    the spin ended."""
    flush_once = (lambda: flush.max()) if read_flush else flush.zero_
    flush_once()                       # its first call may load a module
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
        flush_once()
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
                                     fused_qlhs_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(99)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    floor = time_floor(torch, gen, flush)
    report["timing_floor"] = floor
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
    # the fused training step's forward at lm_head (512 tokens)
    M, K, N = 512, 512, 10240
    ops = qlhs_operands(torch, gen, M, K, N)
    ms = _time_ms(torch, lambda: fused_qlhs_matmul(*ops, bits=8), flush, 20)
    plain = _time_ms(torch, lambda: fused_qlhs_matmul_plain(*ops, bits=8),
                     flush, 5)
    a8 = torch.zeros((M, K), dtype=torch.int8, device="cuda")
    lib = _time_ms(torch, lambda: torch._int_mm(a8, ops[4]), flush, 20)
    nbytes = M * K * 4 + K * N + M * N * 4 + M * 8 + N * 4 + 8
    bound, by = _bound(nbytes, 2.0 * M * N * K, INT8_OPS_PER_S)
    rows.append(dict(kernel="fused_qlhs_matmul", shape=[M, K, N], ms=ms,
                     plain_ms=plain, library_ms=lib, bound_ms=bound,
                     bound_by=by))
    log(f"[time] fused_qlhs_matmul {(M, K, N)}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, _int_mm {lib:.4f} ms, bound {bound:.4f} ms ({by})")
    rows += time_kv(torch, gen, flush, floor)
    rows += time_sr(torch, gen, flush, floor,
                    report["sr_device_kernels_per_call"])
    rows += time_train_kernels(torch, gen, flush)
    rows += time_packed_kernels(torch, gen, flush)
    report["timings"] = rows

    def pick(kernel, shape, wbits=None):
        r = next(r for r in rows
                 if r["kernel"] == kernel and r["shape"] == shape
                 and r.get("wbits") == wbits)
        return {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}
    # the line's numbers: the decode-step shapes for the serving kernels
    # (MLP up-projection, at 4 bits for the packed ones, and one layer's K
    # and V read in one launch at 8 slots x 256 positions, pages of 16 for
    # the gather), the lm_head GEMMs and gradient (the largest) for the
    # training kernels
    return {"fused_qlhs_matmul": pick("fused_qlhs_matmul", [8, 2048, 8192]),
            "kv_dequant_rows": pick("kv_dequant_rows_kv", [2048, 512]),
            "fused_qlhs_matmul_dx": pick("fused_qlhs_matmul_dx",
                                         [512, 10240, 512]),
            "q8_matmul": pick("q8_matmul", [512, 10240, 512]),
            "fused_qboth_tn_matmul": pick("fused_qboth_tn_matmul",
                                          [512, 512, 10240]),
            "kv_gather_pages": pick("kv_gather_pages_kv", [8, 256, 512]),
            "quantize_sr_rows": pick("quantize_sr_rows", [512, 10240]),
            "quantize_sr_tensor": pick("quantize_sr_tensor", [512, 10240]),
            "fused_qlhs_packed_matmul": pick("fused_qlhs_packed_matmul",
                                             [8, 2048, 8192], 4),
            "packed_matmul": pick("packed_matmul", [8, 2048, 8192], 4)}


SR_TIMED = [(512, 512), (512, 1024), (512, 10240), (2048, 8192),
            (2048, 49408)]


def time_sr(torch, gen, flush, floor, per_call) -> list:
    """The backward quantizes of the statquant-tx step (512 tokens: d_model,
    d_ff and lm_head wide) and two of granite's (2048 tokens x d_ff and x
    the vocabulary), each wrapper with its plan beside its plain version,
    the harness's floor and the bound (f32 x and int64 bits in, int8 codes
    and the (scale, zero) pairs out, once each), and the device kernels a
    call (``per_call``, profiled in ``sr_kernels_vs_plain``); at N >= 8192
    also the sweep of its neighbouring plans (``sr_sweep``)."""
    from repro_torch.kernels import quantize_sr as q
    card = q.on_card()
    rows = []
    for (M, N) in SR_TIMED:
        x, rb = sr_operands(torch, gen, M, N)
        for name, kern, plain_fn, plan in (
                ("quantize_sr_rows", q.quantize_sr_rows,
                 q.quantize_sr_rows_plain, q.rows_plan(M, N, card)),
                ("quantize_sr_tensor", q.quantize_sr_tensor,
                 q.quantize_sr_tensor_plain, q.tensor_plan(M * N, card))):
            ms = _time_ms(torch, lambda: kern(x, rb, 8), flush, 20)
            plain = _time_ms(torch, lambda: plain_fn(x, rb, 8), flush, 5)
            launched = per_call[f"{name} {(M, N)}"]
            bound, by = _bound(13 * M * N + 8 * M, 6 * M * N,
                               FP32_OPS_PER_S)
            rows.append(dict(kernel=name, shape=[M, N], ms=ms,
                             plain_ms=plain, library_ms=None,
                             bound_ms=bound, bound_by=by,
                             floor_ms=floor["ms"], plan=str(plan),
                             device_kernels_per_call=launched))
            log(f"[time] {name} {(M, N)}: kernel {ms:.4f} ms ({launched} "
                f"device kernel a call; {plan}), plain {plain:.4f} ms, "
                f"floor {floor['ms']:.4f} ms, bound {bound:.5f} ms ({by}), "
                f"{bound / ms:.2f} of it")
        rows += sr_sweep(torch, flush, x, rb, card)
        del x, rb
        torch.cuda.empty_cache()
    return rows


def sr_sweep(torch, flush, x, rb, card) -> list:
    """The plans the wrappers chose against their neighbours, forced through
    the C entries: rows held in registers (up to ``REG_ROW`` columns) and
    with 1, 2, 4 and 8 blocks a row (each block's share staged whole where
    it fits a block; up to 2 below 8,192 columns), the tensor with 1 to 4
    blocks an SM (each chunk staged as far as its share of the SM
    holds)."""
    from repro_torch.kernels import quantize_sr as q
    M, N = x.shape
    out = []
    plans = ([q.RowsPlan(M, N, 1, q._span(N, 1), 0, 0, regs=True)]
             if N <= q.REG_ROW else [])
    for c in (1, 2, 4, 8) if N >= 8192 else (1, 2):
        span = q._span(N, c)
        stage = min(span + 4, card.stage_for(q.rows_mode(c, True), 1))
        plans.append(q.RowsPlan(M, N, c, span, stage, q.stage_bytes(stage)))
    for plan in plans:
        out.append(dict(kernel="quantize_sr_rows sweep", shape=[M, N],
                        plan=str(plan), ms=_time_ms(
                            torch, lambda: q._rows_launch(x, rb, 8, plan),
                            flush, 20)))
    for per in (1, 2, 3, 4):
        grid = per * card.sms
        chunk = q._span(M * N, grid)
        stage = min(chunk + 4, card.stage_for(q.TENSOR + 1, per))
        plan = q.TensorPlan(M * N, grid, chunk, stage, q.stage_bytes(stage))
        if card.blocks_per_sm(plan.mode, plan.smem) < per:
            continue
        out.append(dict(kernel="quantize_sr_tensor sweep", shape=[M, N],
                        plan=str(plan), ms=_time_ms(
                            torch, lambda: q._tensor_launch(x, rb, 8, plan),
                            flush, 20)))
    for r in out:
        log(f"[sweep] {r['kernel']} {(M, N)}: {r['ms']:.4f} ms, {r['plan']}")
    return out


# the profiler sessions ``_kernels_per_call`` repeated, as (calls, device
# kernels counted): kept in the report, so that a repeat can be told
# apart from a kernel that skipped a launch
PROFILER_REPEATS = []


def _kernels_per_call(torch, fn) -> float:
    """Device kernels a call of ``fn`` runs: torch.profiler over a window of
    calls after a warm-up.  A session of a few short kernels has come back
    with no device kernel at all on the card (after a process's first few
    sessions), and one with a kernel missing (63 of 64 calls); every call
    runs the same kernels, so a session whose count is not a whole number
    a call is repeated over a longer window (8, 64, then 256 calls), and
    noted in PROFILER_REPEATS.  Returns the last window's count a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    per_call = 0.0
    for calls in (8, 64, 256):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in _event_averages(torch, prof)
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0)
        per_call = n / calls
        if n and n % calls == 0:
            return per_call
        PROFILER_REPEATS.append(dict(calls=calls, kernels=n))
        log(f"[profile] {n} device kernels in {calls} calls: the session "
            f"lost or split events; repeated over a longer window")
    return per_call


def time_floor(torch, gen, flush) -> dict:
    """The timing harness's per-call floor, before any kernel is timed:
    ``_time_ms`` of a launch that moves almost nothing (the KV read at (1,
    16), one side and the pair), with the ``zero_()`` flush every timed row
    uses and with a read flush (the dirty-L2 share), and of no launch at
    all (the events alone)."""
    from repro_torch.kernels import kv_dequant_rows, kv_dequant_rows_kv
    c, s, z = kv_operands(torch, gen, 1, 16)
    calls = {"events only": lambda: None,
             "kv_dequant_rows (1, 16)": lambda: kv_dequant_rows(c, s, z),
             "kv_dequant_rows_kv (1, 16)":
                 lambda: kv_dequant_rows_kv((c, s, z), (c, s, z))}
    res = {}
    for name, fn in calls.items():
        res[name] = {flush_kind: _time_ms(torch, fn, flush, 50,
                                          read_flush=read)
                     for flush_kind, read in (("zero_", False),
                                              ("read", True))}
        log(f"[time] floor {name}: {res[name]['zero_']:.4f} ms after the "
            f"zero_() flush (every timed row's), {res[name]['read']:.4f} "
            f"ms after a read flush")
    res["ms"] = res["kv_dequant_rows (1, 16)"]["zero_"]
    return res


def time_kv(torch, gen, flush, floor) -> list:
    """The KV reads: one side as before at (2048, 512), (33, 130) and the
    paged (8, 256, 512) with pages of 16 and 8; and K and V of one layer
    at 8 slots or lanes x 256 positions (dense and pages of 16 and 8) and
    x 4,096 positions (dense and pages of 16, from 1 + 2,048 pages), each
    as the pair in one launch, as two single calls in a row, the plain
    pair, every body of its kernel (forced through the C entry), beside
    the floor and the bound: both sides' bytes (codes, scale and zero of
    every row read once, the table once, f32 out) over 3.35 TB/s."""
    from repro_torch.kernels import (kv_dequant, kv_dequant_rows,
                                     kv_dequant_rows_kv,
                                     kv_dequant_rows_kv_plain,
                                     kv_dequant_rows_plain, kv_gather,
                                     kv_gather_pages, kv_gather_pages_kv,
                                     kv_gather_pages_kv_plain,
                                     kv_gather_pages_plain)
    rows = []
    floor_ms = floor["ms"]
    for (M, N) in [(2048, 512), (33, 130)]:
        c, s, z = kv_operands(torch, gen, M, N)
        ms = _time_ms(torch, lambda: kv_dequant_rows(c, s, z), flush, 50)
        plain = _time_ms(torch, lambda: kv_dequant_rows_plain(c, s, z),
                         flush, 50)
        bound, by = _bound(M * N + 8 * M + 4 * M * N, M * N, FP32_OPS_PER_S)
        rows.append(dict(kernel="kv_dequant_rows", shape=[M, N], ms=ms,
                         plain_ms=plain, library_ms=None, bound_ms=bound,
                         bound_by=by, floor_ms=floor_ms))
        log(f"[time] kv_dequant_rows {(M, N)}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, floor {floor_ms:.4f} ms, bound {bound:.5f} "
            f"ms ({by})")
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
                         bound_ms=bound, bound_by=by, floor_ms=floor_ms))
        log(f"[time] kv_gather_pages (B, nb*P, D) = {(B, S, D)} P={P}: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, floor "
            f"{floor_ms:.4f} ms, bound {bound:.5f} ms ({by})")

    def pair_row(kernel, shape, pair, singles, plain, bodies, nbytes, ops,
                 extra):
        iters = 50 if nbytes < 1e8 else 20
        ms = _time_ms(torch, pair, flush, iters)
        two = _time_ms(torch, singles, flush, iters)
        plain_ms = _time_ms(torch, plain, flush, 5)
        body_ms = {name: _time_ms(torch, fn, flush, iters)
                   for name, fn in bodies.items()}
        bound, by = _bound(nbytes, ops, FP32_OPS_PER_S)
        rows.append(dict(kernel=kernel, shape=list(shape), ms=ms,
                         two_single_ms=two, plain_ms=plain_ms,
                         library_ms=None, bound_ms=bound, bound_by=by,
                         floor_ms=floor_ms, bodies_ms=body_ms, **extra))
        log(f"[time] {kernel} {tuple(shape)}"
            + "".join(f" {k}={v}" for k, v in extra.items())
            + f": pair {ms:.4f} ms, two single calls {two:.4f} ms, plain "
            f"pair {plain_ms:.4f} ms, floor {floor_ms:.4f} ms, bound "
            f"{bound:.5f} ms ({by}, {bound / ms:.2f} of it); bodies "
            + ", ".join(f"{k} {v:.4f}" for k, v in body_ms.items()) + " ms")

    for M, N in [(2048, 512), (32768, 512)]:
        k, v = kv_pair_operands(torch, gen, M, N)
        ks = (k[0], torch.clamp_min(k[1], 1e-12), k[2])
        vs = (v[0], torch.clamp_min(v[1], 1e-12), v[2])
        bodies = {name: (lambda b=b: kv_dequant._launch(
            "kv_dequant_rows_kv", [k, v], M, N, 8, 1, b))
            for name, b in KV_BODIES.items()}
        pair_row("kv_dequant_rows_kv", (M, N),
                 lambda: kv_dequant_rows_kv(k, v),
                 lambda: (kv_dequant_rows(*ks), kv_dequant_rows(*vs)),
                 lambda: kv_dequant_rows_kv_plain(k, v), bodies,
                 2 * (M * N + 8 * M + 4 * M * N), 2 * M * N, {})
        del k, v, ks, vs, bodies
    for P, S in [(16, 256), (8, 256), (16, 4096)]:
        k, v, table = pool_pair_operands(torch, gen, 8, P, 512, S=S)
        B, nb = table.shape
        D = 512
        bodies = {name: (lambda b=b: kv_gather._launch(
            "kv_gather_pages_kv", [k, v], table, 8, b))
            for name, b in KV_BODIES.items()}
        pair_row("kv_gather_pages_kv", (B, S, D),
                 lambda: kv_gather_pages_kv(k, v, table),
                 lambda: (kv_gather_pages(*k, table),
                          kv_gather_pages(*v, table)),
                 lambda: kv_gather_pages_kv_plain(k, v, table), bodies,
                 2 * (B * S * (D + 8) + 4 * B * S * D) + 4 * B * nb,
                 2 * B * S * D, dict(page_size=P))
        del k, v, table, bodies
    torch.cuda.empty_cache()
    return rows


def time_train_kernels(torch, gen, flush) -> list:
    """Each training kernel at its statquant-tx path shapes (512 tokens),
    beside its plain version, its bound, and ``torch._int_mm`` as the
    yardstick: the bare int8 product of codes of the same shapes, laid
    out as the path stores them (the dX GEMMs' B is the transpose of the
    (d_in, d_out) weight codes, the dW GEMM's A the transpose of the
    (tokens, d_in) activations), without the kernels' quantize, SR bits
    and epilogue.  ``q8_matmul`` also with an N-major B at the unfused
    step's lm_head forward and dW, both (512, 512, 10240)."""
    from repro_torch.kernels import (fused_qboth_tn_matmul,
                                     fused_qboth_tn_matmul_plain,
                                     fused_qlhs_matmul,
                                     fused_qlhs_matmul_plain, q8_matmul,
                                     q8_matmul_plain)
    dx, dw = train_shapes()
    rows = []

    def codes(*shape):
        return torch.zeros(shape, dtype=torch.int8, device="cuda")

    def one(name, shape, fn, plain, lib_args, mnk, nbytes, role=None):
        M, N, K = mnk
        ms = _time_ms(torch, fn, flush, 20)
        plain_ms = _time_ms(torch, plain, flush, 5)
        lib = _time_ms(torch, lambda: torch._int_mm(*lib_args), flush, 20)
        bound, by = _bound(nbytes, 2.0 * M * N * K, INT8_OPS_PER_S)
        rows.append(dict(kernel=name, shape=list(shape), ms=ms,
                         plain_ms=plain_ms, library_ms=lib, bound_ms=bound,
                         bound_by=by, **({"role": role} if role else {})))
        log(f"[time] {name} {tuple(shape)}{' ' + role if role else ''}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, _int_mm "
            f"{lib:.4f} ms, bound {bound:.4f} ms ({by})")

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
    # the unfused lm_head forward (tokens, d_in) x (d_in, d_out) and dW
    # (d_in, tokens) x (tokens, d_out): B row-major (N-major)
    M, K, N = 512, 512, 10240
    for role in ("N-major forward", "N-major dW"):
        ops = q8_unfused_operands(torch, gen, M, K, N)
        one("q8_matmul", (M, K, N), lambda: q8_matmul(*ops),
            lambda: q8_matmul_plain(*ops), (codes(M, K), codes(K, N)),
            (M, N, K), M * K + K * N + 12 * (M + N) + 4 * M * N, role)
    return rows


# whisper-medium's depth in [audit] (full width; at 24 + 24 layers its
# walk takes about 16 s of CPU on the meta device)
AUDIT_WHISPER_LAYERS = 6


def audit_phase(torch, seed, report) -> list:
    """``[audit]``: the quantization-contract audit (``analysis/audit.py``)
    on the meta device, CPU time only: the full engine step of
    statquant-tx at full width under ``fqt(psq,8)`` and ``fqt(bhq,5)``,
    and the loss and gradient of granite-3-2b at full width and its 40
    layers and of whisper-medium at full width (``AUDIT_WHISPER_LAYERS``
    a stack), every GEMM walked, on the ``kernel`` backend: coverage 1.0,
    no violation, no range finding that fails."""
    from repro_torch.analysis import audit_model, audit_step
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy

    def pol(q, bits):
        return QuantPolicy.fqt(q, bits, backend="kernel")
    runs = [("statquant-tx engine step, fqt(psq,8)", audit_step,
             get_config("statquant-tx"), pol("psq", 8)),
            ("statquant-tx engine step, fqt(bhq,5)", audit_step,
             get_config("statquant-tx"), pol("bhq", 5)),
            ("granite-3-2b, 40 layers, fqt(psq,8)", audit_model,
             get_config("granite-3-2b"), pol("psq", 8)),
            (f"whisper-medium, {AUDIT_WHISPER_LAYERS} + "
             f"{AUDIT_WHISPER_LAYERS} layers, fqt(psq,8)", audit_model,
             family_config("whisper-medium", AUDIT_WHISPER_LAYERS),
             pol("psq", 8))]
    rows = []
    for title, fn, cfg, policy in runs:
        t0 = time.perf_counter()
        r = fn(cfg, policy)
        s = time.perf_counter() - t0
        ranges = [str(f) for f in r.range_findings]
        log(f"[audit] {title}: {len(r.sites)} GEMMs, coverage "
            f"{100 * r.coverage:.1f}%, {len(r.violations)} violations, "
            f"exempt {sorted(r.exemptions)}, ranges {ranges}, {s:.1f}s")
        check(r.ok and r.coverage == 1.0, f"[audit] {title}:\n{r.format()}")
        rows.append(dict(title=title, gemms=len(r.sites),
                         coverage=r.coverage, violations=len(r.violations),
                         role_flops=r.role_flops(), ranges=ranges, seconds=s))
    report["audit"] = rows
    return rows


def autotune_phase(torch, seed, report) -> list:
    """``[autotune]``: the autotuner (``kernels/autotune.py``) on the card
    at each case of ``autotune.SWEEP_CASES`` (the int8 tensor-core kernels at
    every tile they were built with, decode and wide where there are both,
    and every split of K; both KV reads at each body), into a temporary
    cache.  Each candidate runs through its wrapper (``autotune.forced``)
    and is held bit for bit to the planned call, which is held to the
    plain version; ``[split]`` lines give each one's time and blocks, an
    ``[autotune]`` line the split model's pick beside the card's winner.
    Then ``analysis.check_kernels`` clean on the shipped defaults and on
    the tuned cache (``int8_mma_build`` holds ``tile_smem_bytes`` to each
    library's ``_tile`` report for every tile)."""
    import tempfile
    from repro_torch.analysis import check_kernels
    from repro_torch.kernels import autotune as at
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    saved = os.environ.get(at.ENV_CACHE)
    with tempfile.TemporaryDirectory() as tmp:
        cache_file = os.path.join(tmp, "tuning.json")
        os.environ[at.ENV_CACHE] = cache_file
        at.reset_cache()
        try:
            for kernel, shape, dtype in at.SWEEP_CASES:
                rows.append(_autotune_case(torch, at, kernel, shape, dtype,
                                           gen, flush))
            tuned = check_kernels(cache_file)
            shipped = check_kernels(os.path.join(tmp, "absent.json"))
        finally:
            if saved is None:
                os.environ.pop(at.ENV_CACHE, None)
            else:
                os.environ[at.ENV_CACHE] = saved
            at.reset_cache()
    for name, rep in (("shipped defaults", shipped), ("tuned cache", tuned)):
        log(f"[autotune] check_kernels on the {name}: "
            f"{'OK' if rep.ok else 'ERRORS'}, {rep.n_shipped} shipped, "
            f"{rep.n_cache} cached entries, {len(rep.findings)} findings")
        check(rep.ok, f"check_kernels on the {name}:\n{rep.format()}")
    tiles = report["int8_mma_build"]
    log(f"[autotune] tile_smem_bytes equals every library's _tile report "
        f"({len(tiles)} tiles, [build]; largest "
        f"{max(max(r['dynamic_smem']) for r in tiles.values())} B of "
        f"{at.SMEM_BUDGET_BYTES})")
    report["autotune"] = dict(cases=rows)
    return rows


def _autotune_case(torch, at, kernel, shape, dtype, gen, flush):
    """One ``[autotune]`` case (``autotune.tune_case`` on the operands of
    ``autotune.case_call``, with the smoke's timer); returns its row."""
    r = at.tune_case(kernel, shape, dtype, gen,
                     timer=lambda fn: _time_ms(torch, fn, flush, 20) * 1e3)
    check(not r["skipped"], f"{kernel} {shape} {dtype}: candidates "
                            f"{r['skipped']} failed to launch")

    def label(entry):
        return (f"body {entry['body']}" if "body" in entry
                else f"{entry['tile']} {entry['splits']} slices")
    times = {}
    for key, us in r["us"].items():
        entry = json.loads(key)
        times[label(entry)] = us / 1e3
        blocks = ("" if "body" in entry else
                  f", {at.resolve(kernel, shape, entry, dtype).blocks} blocks")
        tags = [t for t in ("model", "planned") if r[t] == entry]
        log(f"[split] {kernel} {shape} {dtype} {label(entry)}{blocks}: "
            f"{us / 1e3:.4f} ms{' (' + ', '.join(tags) + ')' if tags else ''}"
            f", bit-identical to the planned call and the plain version")
    best, model, planned = r["best"], r["model"], r["planned"]
    best_ms, model_ms = times[label(best)], times[label(model)]
    log(f"[autotune] {kernel} {shape} {dtype}: model {label(model)} "
        f"{model_ms:.4f} ms, planned {label(planned)} "
        f"{times[label(planned)]:.4f} ms, card's best {label(best)} "
        f"{best_ms:.4f} ms (model/best {model_ms / best_ms:.3f})")
    return dict(kernel=kernel, shape=list(shape), dtype=dtype, model=model,
                planned=planned, best=best, model_ms=model_ms,
                best_ms=best_ms, times_ms=times)


def _host_us(torch, fn, calls: int = 200) -> float:
    """Host time of one call of ``fn`` in microseconds: ``calls`` calls
    queued behind a spin kernel, so the host never waits on the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * 10)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def step_wall(torch, seed, host_only=False) -> dict:
    """For the ``repro_torch`` on ``sys.path``: each FQT GEMM wrapper's
    host time a call (the median of ``HOST_REPEATS`` passes of
    ``_host_us`` over the wrappers in turn) at the statquant-tx step's
    (512, 512, 512) and the forward at the decode (8, 2048, 8192), and
    with ``host_only`` nothing more; else also both packed GEMMs'
    device time at 4 bits (``_time_ms``) at the decode (8, 2048, 8192),
    (128, 2048, 8192) and (512, 512, 10240), the KV reads' device time
    (``kv_times``), the SR quantizers' device time and device kernels a
    call (``sr_times``), granite's decode step profiled dense, paged and
    from packed weights with the KV reads' and the packed forward's shares
    (``decode_profiles``), the training step's wall (statquant-tx full
    width, 8 x 64 tokens, median of 10 steps after 2, no profiler) under
    the four policies the smoke run profiles and of granite-moe-1b-a400m
    (full width, ``MOE_TRAIN_LAYERS`` layers) under ``fqt(psq,8)``, and
    one unfused step under
    ``fqt(psq,8)`` and ``fqt(ptq,8)`` profiled (busy, device kernels, the
    SR quantizers' share).  It uses only wrapper signatures and engine
    options that older checkouts of the package share, so two compare in
    one call."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import (build, fused_qboth_tn_matmul,
                                     fused_qlhs_matmul,
                                     fused_qlhs_packed_matmul, packed_matmul,
                                     q8_matmul)
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fwd = qlhs_operands(torch, gen, 512, 512, 512)
    dec = qlhs_operands(torch, gen, 8, 2048, 8192)
    dx = dx_operands(torch, gen, 512, 512, 512, 8)
    dw = dw_operands(torch, gen, 512, 512, 512, 8)
    q8 = q8_operands(torch, gen, 512, 512, 512)
    calls = {
        "fused_qlhs_matmul (512, 512, 512)":
            lambda: fused_qlhs_matmul(*fwd, bits=8),
        "fused_qlhs_matmul (8, 2048, 8192)":
            lambda: fused_qlhs_matmul(*dec, bits=8),
        "fused_qlhs_matmul dX (512, 512, 512)":
            lambda: fused_qlhs_matmul(*dx, bits=8, trans_b=True),
        "fused_qboth_tn_matmul (512, 512, 512)":
            lambda: fused_qboth_tn_matmul(*dw, bits_a=8, bits_b=8),
        "q8_matmul (512, 512, 512)": lambda: q8_matmul(*q8),
    }
    passes = [{name: _host_us(torch, fn) for name, fn in calls.items()}
              for _ in range(HOST_REPEATS)]
    host = {name: float(np.median([p[name] for p in passes]))
            for name in calls}
    if host_only:
        return dict(host_us_per_call=host)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    packed_us = {}
    for (M, K, N) in ((8, 2048, 8192), (128, 2048, 8192), (512, 512, 10240)):
        fused, unfused, _ = packed_operands(torch, gen, M, K, N, 4)
        packed_us[f"fused_qlhs_packed_matmul {(M, K, N)} w4"] = 1e3 * _time_ms(
            torch, lambda: fused_qlhs_packed_matmul(*fused, bits=8, wbits=4),
            flush, 20)
        packed_us[f"packed_matmul {(M, K, N)} w4"] = 1e3 * _time_ms(
            torch, lambda: packed_matmul(*unfused, wbits=4, kdim=K), flush,
            20)
    kv_us = kv_times(torch, gen, flush)
    sr_us, sr_kernels = sr_times(torch, gen, flush)
    decode = decode_profiles(torch, seed)
    cfg = get_config("statquant-tx")
    moe = family_config(MOE_ARCH, MOE_TRAIN_LAYERS)
    walls = {}
    for tag, quant, bits, fused, c in (
            ("psq8", "psq", 8, None, cfg), ("bhq5", "bhq", 5, None, cfg),
            ("psq8 unfused", "psq", 8, False, cfg),
            ("ptq8 unfused", "ptq", 8, False, cfg),
            ("MoE psq8", "psq", 8, None, moe)):
        step = _one_step(_train_engine(c, quant, bits, "kernel", seed,
                                       fused=fused))
        ms = []
        for i in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        walls[tag] = dict(median_ms=float(np.median(ms[2:])), ms=ms[2:])
    train = {}
    for quant in ("psq", "ptq"):
        prof = _profile(torch, _one_step(_train_engine(
            cfg, quant, 8, "kernel", seed, fused=False)),
            f"one training step, {quant}8 unfused", share="quantize_sr")
        train[f"{quant}8 unfused"] = dict(
            busy_ms=prof["device_busy_ms"], wall_ms=prof["wall_ms"],
            device_kernels=prof["device_kernels"], shares=prof["shares"])
    return dict(host_us_per_call=host, packed_us=packed_us, step_wall=walls,
                kv_us=kv_us, sr_us=sr_us, sr_kernels_per_call=sr_kernels,
                decode=decode, train=train)


def sr_times(torch, gen, flush):
    """Device time (``_time_ms``, us) of ``quantize_sr_rows`` and
    ``quantize_sr_tensor`` as the package on ``sys.path`` runs them, at the
    timed shapes (``SR_TIMED``), and the device kernels one call of each
    runs at (512, 512)."""
    from repro_torch.kernels import quantize_sr_rows, quantize_sr_tensor
    us, kernels = {}, {}
    for M, N in SR_TIMED:
        x, rb = sr_operands(torch, gen, M, N)
        for name, fn in (("quantize_sr_rows", quantize_sr_rows),
                         ("quantize_sr_tensor", quantize_sr_tensor)):
            us[f"{name} {(M, N)}"] = 1e3 * _time_ms(
                torch, lambda: fn(x, rb, 8), flush, 20)
            if (M, N) == SR_TIMED[0]:
                kernels[name] = _kernels_per_call(torch, lambda: fn(x, rb, 8))
        del x, rb
    torch.cuda.empty_cache()
    return us, kernels


def kv_times(torch, gen, flush) -> dict:
    """Device time (``_time_ms``, us) of a layer's KV read as the package
    on ``sys.path`` does it: dense (2048, 512) and (32768, 512) a side, and
    paged (8, 256, 512) and (8, 4096, 512) with pages of 16, as two single
    calls (dense also with the clamp each side launched before its call
    until the pair existed) and, where the package has it, as the pair."""
    from repro_torch import kernels
    pair = hasattr(kernels, "kv_dequant_rows_kv")
    res = {}
    for M, N in [(2048, 512), (32768, 512)]:
        k, v = kv_pair_operands(torch, gen, M, N)
        ks = (k[0], torch.clamp_min(k[1], 1e-12), k[2])
        vs = (v[0], torch.clamp_min(v[1], 1e-12), v[2])
        calls = {
            "two single calls": lambda: (kernels.kv_dequant_rows(*ks),
                                         kernels.kv_dequant_rows(*vs)),
            "two clamps and single calls": lambda: tuple(
                kernels.kv_dequant_rows(c, torch.clamp_min(s, 1e-12), z)
                for c, s, z in (k, v))}
        if pair:
            calls["pair"] = lambda: kernels.kv_dequant_rows_kv(k, v)
        for name, fn in calls.items():
            res[f"kv_dequant_rows {(M, N)} {name}"] = 1e3 * _time_ms(
                torch, fn, flush, 20)
        del k, v, ks, vs
    for S in (256, 4096):
        k, v, table = pool_pair_operands(torch, gen, 8, 16, 512, S=S)
        calls = {"two single calls": lambda: (
            kernels.kv_gather_pages(*k, table),
            kernels.kv_gather_pages(*v, table))}
        if pair:
            calls["pair"] = lambda: kernels.kv_gather_pages_kv(k, v, table)
        for name, fn in calls.items():
            res[f"kv_gather_pages (8, {S}, 512) P=16 {name}"] = 1e3 * _time_ms(
                torch, fn, flush, 20)
        del k, v, table
    torch.cuda.empty_cache()
    return res


def decode_profiles(torch, seed) -> dict:
    """One full-batch granite-3-2b decode step (8 slots, full width and
    depth), profiled (``_profile``): dense lanes, paged (pages of 16), and
    from weights packed at 8 and at 4 bits.  Each: device busy time, wall,
    device kernels, and the device time and launches of the KV reads and
    the clamps (``KV_SHARE``) and, packed, of the packed forward's kernels
    (names holding "qlhs": a packed engine runs no other fused-quantize
    kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    cfg = get_config("granite-3-2b")
    params = build_model(cfg).init(seed, device="cuda")
    res = {}
    for tag, kw in (("dense", {}), ("paged", dict(paged=True, page_size=16)),
                    ("w8", dict(weight_bits=8)), ("w4", dict(weight_bits=4))):
        eng = ServeEngine(cfg, params, policy=QuantPolicy.qat(
            backend="kernel"), slots=8, max_seq=256, kv_quant=True,
            seed=seed, device="cuda", **kw)
        share = KV_SHARE + (("qlhs",) if tag.startswith("w") else ())
        prof = (_profile_paged_decode(torch, eng) if tag == "paged" else
                _profile_decode(torch, eng, tag, share=share))
        res[tag] = dict(busy_ms=prof["device_busy_ms"],
                        wall_ms=prof["wall_ms"],
                        device_kernels=prof["device_kernels"],
                        shares=prof["shares"])
        del eng
        torch.cuda.empty_cache()
    return res


def step_wall_trees(trees, seed, host_only=False, rounds=1) -> int:
    """``step_wall`` for each checkout in ``trees``, in order, one process
    each (a tree's package builds into its own ``build/``), ``rounds``
    passes over them; prints each result and a table, and writes them to
    chiprun_out/step_wall.json."""
    import numpy as np
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    res = []
    for tree in list(trees) * rounds:
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--seed", str(seed), "--step-wall-of",
                            str(tree.resolve())]
                           + ["--host-only"] * host_only,
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        out = json.loads(r.stdout.strip().splitlines()[-1])
        res.append(dict(tree=str(tree), **out))
        log(f"[step wall] {tree}: " + json.dumps(out))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "step_wall.json").write_text(json.dumps(res, indent=1))
    for name in res[0]["host_us_per_call"]:
        spread = {}
        for r in res:
            spread.setdefault(r["tree"], []).append(
                r["host_us_per_call"][name])
        log(f"[step wall] {name}, host us a call, min-median-max over "
            f"its processes: " + " | ".join(
                f"{t} ({len(v)}) {min(v):.2f}-{float(np.median(v)):.2f}-"
                f"{max(v):.2f}" for t, v in spread.items()))
    if host_only:
        return 0
    for name in res[0]["decode"]:
        log(f"[step wall] decode step {name}: " + " | ".join(
            f"{r['tree']} busy {r['decode'][name]['busy_ms']:.2f} ms, "
            f"{r['decode'][name]['device_kernels']} kernels; "
            + ", ".join(f"{k} {v['ms']:.3f} ms ({v['launches']}x)"
                        for k, v in r["decode"][name]["shares"].items())
            for r in res))
    for name in res[0]["train"]:
        log(f"[step wall] training step {name}: " + " | ".join(
            f"{r['tree']} busy {r['train'][name]['busy_ms']:.2f} ms, "
            f"{r['train'][name]['device_kernels']} kernels; "
            + ", ".join(f"{k} {v['ms']:.3f} ms ({v['launches']}x)"
                        for k, v in r["train"][name]["shares"].items())
            for r in res))
    log("[step wall] device kernels a call at (512, 512): " + " | ".join(
        f"{r['tree']} {r['sr_kernels_per_call']}" for r in res))
    for key, unit in (("host_us_per_call", " us a call (host)"),
                      ("packed_us", " us a call (device)"),
                      ("kv_us", " us a call (device)"),
                      ("sr_us", " us a call (device)"),
                      ("step_wall", " ms a step")):
        names = dict.fromkeys(n for r in res for n in r[key])
        for name in names:
            vals = [r[key].get(name) for r in res]
            vals = ["n/a" if v is None else
                    f"{v['median_ms'] if isinstance(v, dict) else v:.2f}"
                    for v in vals]
            log(f"[step wall] {name}: "
                + " | ".join(f"{r['tree']} {v}"
                             for r, v in zip(res, vals)) + unit)
    return 0


def time_packed_kernels(torch, gen, flush) -> list:
    """Both packed kernels at 8 bits at every decode GEMM of granite (M =
    8, ``GRANITE_KN``: beside the int8 forward's times at the same shapes),
    at the decode MLP up-projection (8, 2048, 8192) at 4, 2 and 1 bits,
    and at lm_head (8, 2048, 49408), at prefill's
    (128, 2048, 8192) and at the int4w training step's lm_head forward
    (512, 512, 10240), these three at 4 bits, beside the plain version,
    ``torch._int_mm`` on the unpacked int8 codes (M padded to 32; the bare
    product) and the bound: bytes over 3.35 TB/s or int8 operations over
    1,979 TOP/s, each input read once (the f32 LHS or its int8 codes, the
    packed bytes, the vectors) and the f32 output written once."""
    from repro_torch.kernels import (fused_qlhs_packed_matmul,
                                     fused_qlhs_packed_matmul_plain,
                                     packed_matmul, packed_matmul_plain)
    rows = []
    for (M, K, N, wbits) in (
            [(8, K, N, 8) for (K, N) in GRANITE_KN]
            + [(8, 2048, 8192, w) for w in (4, 2, 1)]
            + [(8, 2048, 49408, 4), (128, 2048, 8192, 4),
               (512, 512, 10240, 4)]):
        fused, unfused, pt = packed_operands(torch, gen, M, K, N, wbits)
        kp = fused[3].shape[0]
        a8 = torch.zeros((max(M, 32), K), dtype=torch.int8, device="cuda")
        w8 = pt.int8_codes
        lib = _time_ms(torch, lambda: torch._int_mm(a8, w8), flush, 20)
        for name, kern, plain, args, kw, nbytes in (
                ("fused_qlhs_packed_matmul", fused_qlhs_packed_matmul,
                 fused_qlhs_packed_matmul_plain, fused,
                 dict(bits=8, wbits=wbits),
                 M * K * 4 + kp * N + M * N * 4 + M * 8 + N * 4 + 8),
                ("packed_matmul", packed_matmul, packed_matmul_plain,
                 unfused, dict(wbits=wbits, kdim=K),
                 M * K + kp * N + 12 * (M + N) + 4 * M * N)):
            ms = _time_ms(torch, lambda: kern(*args, **kw), flush, 20)
            plain_ms = _time_ms(torch, lambda: plain(*args, **kw), flush, 5)
            bound, by = _bound(nbytes, 2.0 * M * N * K, INT8_OPS_PER_S)
            rows.append(dict(kernel=name, shape=[M, K, N], wbits=wbits,
                             ms=ms, plain_ms=plain_ms, library_ms=lib,
                             bound_ms=bound, bound_by=by))
            log(f"[time] {name} {(M, K, N)} w{wbits}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, _int_mm(M={max(M, 32)}, int8 "
                f"codes) {lib:.4f} ms, bound {bound:.5f} ms ({by})")
    return rows


def _packed_calls(torch, gen, M, K, N, wbits, stream):
    """For each packed GEMM at (M, K, N) and ``wbits``: its name, library,
    planned result through the wrapper (checked bit for bit against the
    plain version), and ``call(fn, out, mode, splits, k_span)``, which
    runs C entry ``fn`` on the same operands with the split forced (what
    ``packed_kernel_vs_plain`` forces)."""
    from repro_torch.kernels import (fused_qlhs_packed_matmul,
                                     fused_qlhs_packed_matmul_plain,
                                     packed_matmul, packed_matmul_plain)
    fused, unfused, _ = packed_operands(torch, gen, M, K, N, wbits)

    def caller(ops, extra):
        # the closure holds the tensors, so their memory stays theirs
        return lambda fn, out, mode, s, span: fn(
            *[t.data_ptr() for t in ops], out.data_ptr(), M, N, K, *extra,
            mode, s, span, stream)
    rows = []
    for name, lib, kern, plain, ops, kw, extra in (
            ("fused_qlhs_packed_matmul", "fused_qlhs_packed",
             fused_qlhs_packed_matmul, fused_qlhs_packed_matmul_plain, fused,
             dict(bits=8, wbits=wbits), (8,)),
            ("packed_matmul", "packed_matmul", packed_matmul,
             packed_matmul_plain, unfused, dict(wbits=wbits, kdim=K), ())):
        ref = kern(*ops, **kw)
        torch.cuda.synchronize()
        check(torch.equal(ref, plain(*ops, **kw)),
              f"{name} {(M, K, N)} w{wbits}: differs from plain")
        rows.append((name, lib, ref, caller(ops, extra)))
    return rows


def _packed_argtypes(lib):
    from repro_torch.kernels.fused_fqt import _QLHS_PACKED_ARGTYPES
    from repro_torch.kernels.q4_matmul import _ARGTYPES
    return _QLHS_PACKED_ARGTYPES if lib == "fused_qlhs_packed" else _ARGTYPES


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        sys.exit(1)

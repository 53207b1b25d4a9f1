"""Continuous-batching serving engine over the quantized decode path.

Port of the dense-lane ``repro.serve.engine.ServeEngine``: one object owns
a fixed pool of decode slots and runs the one-token decode step at full
static batch while requests stream through —

  * **scheduler** — a FIFO queue drained into free slots; each slot carries
    its own position, sampling parameters and PRNG stream; a slot is
    evicted when its request emits EOS, reaches ``max_new``, or fills its
    cache lane.  Inactive slots run on dummy tokens (token 0 at position
    0) and their samples are discarded.
  * **prefill** — per request (batch 1), right-padded with token 0 into a
    power-of-two length bucket; the whole bucket slab is inserted into the
    slot's cache lane (rows past the prompt are hidden by the position mask
    until decode overwrites them).
  * **int8 KV cache** — ``kv_quant=True`` stores keys/values as per-row
    affine int8 codes; on the ``kernel`` backend every decode step reads
    each layer's K and V through one launch of the ``kv_dequant_rows_kv``
    CUDA kernel.

Determinism: sampling keys are ``fold_in(fold_in(PRNGKey(seed), rid),
count)``, the JAX package's draw.  Under per-tensor forward quantizers the
logits couple co-resident slots (``Q_f`` takes its range over the whole
decode batch), so two engines agree token for token only at equal pool
size and submission order.

``paged=True`` builds the paged-pool engine (serve/paged.py) instead: the
same scheduler surface over a shared int8 page pool with block tables,
prefix reuse, chunked prefill, preemption and optional speculative decode.

``weight_bits=8|4|2`` quantizes every dense kernel once at load
(deterministic per-tensor PTQ, per layer for a stacked leaf) and bit-packs
it (:func:`pack_dense_weights`): the resident GEMM weights drop to
bits/32 of fp32, and every forward streams the stored codes through the
packed kernels instead of quantizing the fp32 weights per call.

``ServeEngine.from_checkpoint`` starts from the ``params`` subtree of a
training checkpoint (a whole ``TrainState``, or a legacy ``{params,
opt}`` one), written by either package.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import prng
from ..core import (QuantPolicy, RoleOverride, quantize_kv_rows,
                    quantize_ptq_det, resolve_kv_cache_spec)
from ..core.quantizers import range_scale
from ..device import resolve_device
from ..kernels.pack import PackedTensor, pack_codes, pack_qtensor
from ..models import build_model
from .sampling import sample_tokens, slot_keys

__all__ = ["Request", "Completion", "ServeEngine", "pack_dense_weights",
           "weight_nbytes"]

# bits -> the forward-weight role spec the packed policy advertises (8-bit
# packs to identity bytes but still holds a quarter of fp32 and skips the
# per-call weight quantize)
_PACKED_WEIGHT_SPECS = {8: "ptq_det:8", 4: "int4w:4", 2: "int4w:2"}


def _pack_leaf(w: torch.Tensor, bits: int) -> PackedTensor:
    """Quantize one dense kernel to ``bits`` (deterministic per-tensor PTQ,
    the paper's Q_theta) and bit-pack it.  A stacked ``(L, K, N)`` leaf is
    quantized per layer: one affine pair per layer, shaped ``(L, 1, 1)``,
    the scales through ``range_scale`` (IEEE division, as the reference)."""
    w = w.to(torch.float32)
    if w.dim() == 2:
        return pack_qtensor(quantize_ptq_det(w, bits))
    nbins = (1 << bits) - 1
    zero = torch.amin(w, dim=(-2, -1), keepdim=True)
    hi = torch.amax(w, dim=(-2, -1), keepdim=True)
    scale = range_scale(nbins, hi - zero)
    codes = torch.clamp(torch.round(scale * (w - zero)), 0, nbins)
    return PackedTensor(packed=pack_codes(codes.to(torch.uint8), bits),
                        scale=scale, zero=zero, bits=bits, kdim=w.shape[-2])


def pack_dense_weights(params, bits: int):
    """Every dense kernel leaf (dict key ``"w"``, ndim >= 2) replaced by a
    :class:`PackedTensor` quantized once at ``bits``; embeddings, biases and
    norm scales stay fp (they are not GEMM operands)."""
    if bits not in _PACKED_WEIGHT_SPECS:
        raise ValueError(f"weight_bits={bits!r}: packable widths are "
                         f"{sorted(_PACKED_WEIGHT_SPECS)}")

    def walk(node):
        if isinstance(node, dict):
            return {k: (_pack_leaf(v, bits)
                        if k == "w" and getattr(v, "ndim", 0) >= 2
                        else walk(v))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def weight_nbytes(params) -> int:
    """Resident bytes of a params tree (packed leaves count packed)."""
    if isinstance(params, dict):
        return sum(weight_nbytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(weight_nbytes(v) for v in params)
    if isinstance(params, PackedTensor):
        return params.nbytes
    return params.numel() * params.element_size()


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.  ``eos_id=None`` inherits the engine's."""

    rid: int
    prompt: tuple                      # token ids, 1 <= len < max_seq
    max_new: int = 32
    temperature: float = 0.0           # <= 0 => greedy
    top_k: int = 0                     # <= 0 => disabled
    top_p: float = 0.0                 # outside (0, 1) => disabled
    eos_id: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Completion:
    rid: int
    prompt_len: int
    tokens: List[int]                  # includes the terminating EOS, if any
    reason: str                        # "eos" | "length"


class _Slot:
    """Host-side state of one decode slot."""

    __slots__ = ("req", "pos", "tokens")

    def __init__(self):
        self.req: Optional[Request] = None
        self.pos = 0                   # next cache write position
        self.tokens: List[int] = []    # sampled so far (incl. EOS)

    @property
    def active(self) -> bool:
        return self.req is not None


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class ServeEngine:
    """See module docstring.  Typical lifecycle::

        eng = ServeEngine(cfg, params, slots=8, kv_quant=True)
        for prompt in prompts:
            eng.submit(prompt, max_new=64, temperature=0.8, top_k=40)
        completions = eng.run()          # drains queue + pool

    ``params`` must live on ``device`` (CUDA unless the caller asks for
    another; with no card visible and no ``device=`` the constructor
    raises).  ``paged=True`` returns a
    :class:`~repro_torch.serve.paged.PagedServeEngine`, which also takes
    the paged-only knobs (``page_size``, ``pages``, ``prefill_chunk``,
    ``spec_decode``, ``spec_k``, ``draft_policy``).
    """

    def __new__(cls, *args, paged: bool = False, **kw):
        if paged and cls is ServeEngine:
            from .paged import PagedServeEngine  # late: paged imports us
            return super().__new__(PagedServeEngine)
        return super().__new__(cls)

    def __init__(self, cfg, params, *, policy: Optional[QuantPolicy] = None,
                 slots: int = 4, max_seq: int = 64, kv_quant=False,
                 eos_id: Optional[int] = None, seed: int = 0,
                 weight_bits: Optional[int] = None, paged: bool = False,
                 device=None):
        del paged                       # consumed by __new__
        if cfg.family in ("vlm", "audio"):
            raise ValueError(
                f"{cfg.name}: the serving engine drives token-input decoder "
                f"LMs; family {cfg.family!r} needs a frontend the stub "
                f"pipeline does not provide")
        if cfg.family == "hybrid" or cfg.ssm_kind:
            raise ValueError(
                f"{cfg.name}: continuous batching needs per-slot KV-cache "
                f"lanes; recurrent-state families (ssm/hybrid) are not "
                f"supported yet")
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.model = build_model(cfg)
        self.policy = policy or QuantPolicy.qat(backend="kernel")
        self.params = params
        self.weight_bits = weight_bits
        if weight_bits is not None:
            # pack once at load; the catch-all override, applied last, gives
            # every path the fwd_weight spec of the packed leaves
            self.params = pack_dense_weights(params, weight_bits)
            self.policy = dataclasses.replace(
                self.policy,
                overrides=tuple(self.policy.overrides) + (
                    ("", RoleOverride.of(
                        {"fwd_weight": _PACKED_WEIGHT_SPECS[weight_bits]})),))
        self.slots = slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.kv_spec = resolve_kv_cache_spec(kv_quant)
        self._base_key = prng.PRNGKey(seed, device=self.device)
        self._queue: deque = deque()
        self._slots = [_Slot() for _ in range(slots)]
        self._next_rid = 0
        self._completions: Dict[int, Completion] = {}
        self.step_times: List[tuple] = []       # (seconds, tokens_emitted)
        self._cache = self._init_cache()

    @classmethod
    def from_checkpoint(cls, cfg, ckpt_dir: str, step: Optional[int] = None,
                        **kw) -> "ServeEngine":
        """Restore ``params`` from a training checkpoint (an engine
        ``TrainState``, or the legacy ``{params, opt}`` layout: the same
        subtree) onto ``device`` and build the engine with ``kw``
        (``paged=True`` gives the paged engine, ``weight_bits`` packs at
        load).  Raises ``FileNotFoundError`` when ``ckpt_dir`` holds no
        checkpoint."""
        from ..checkpoint import CheckpointManager
        if not os.path.isdir(ckpt_dir):
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
        ckpt = CheckpointManager(ckpt_dir)
        step = step if step is not None else ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
        device = resolve_device(kw.get("device"))
        abstract = build_model(cfg).init(0, device="meta")
        params = ckpt.restore(step, {"params": abstract},
                              device=device)["params"]
        return cls(cfg, params, **kw)

    def _init_cache(self):
        if self.kv_spec is not None:
            return self.model.init_cache_quant(self.cfg, self.slots,
                                               self.max_seq,
                                               device=self.device)
        cache = self.model.init_cache(self.cfg, self.slots, self.max_seq,
                                      device=self.device)
        cache["index"] = torch.zeros((self.slots,), dtype=torch.int32,
                                     device=self.device)
        return cache

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- the full-batch decode step ----------------------------------------
    def _decode(self, tok, pos, rids, counts, temp, topk, topp):
        keys = slot_keys(self._base_key, rids, counts)
        logits, self._cache = self.model.decode(
            self.params, self._cache, {"tokens": tok[:, None]}, self.policy,
            positions=pos, kv_quant=self.kv_spec)
        return sample_tokens(logits[:, -1], keys, temp, topk,
                             self.cfg.vocab_size, topp)

    # -- prefill + slot insertion ------------------------------------------
    def _prefill(self, tokens: np.ndarray):
        """(1, Lp) prompt -> (last-real-position logits (1, 1, Vp), kv
        ``{"k", "v"}`` of shape (L, 1, Lb, flat)), Lb the bucket."""
        lp = tokens.shape[1]
        lb = min(_bucket(lp), self.max_seq)   # slab must fit the cache lane
        padded = np.zeros((1, lb), np.int64)
        padded[0, :lp] = tokens[0]
        logits, cache = self.model.prefill(
            self.params, {"tokens": self._tensor(padded)}, self.policy,
            max_seq=lb, last_pos=self._tensor(np.asarray([lp - 1])))
        return logits, cache["kv"]

    def _insert(self, kv, slot: int, lp: int):
        """Write the prefill bucket's rows of ``kv`` into ``slot``'s cache
        lane (quantized when the cache is int8) and set its position to
        the real prompt length ``lp``."""
        lb = kv["k"].shape[2]
        for side in ("k", "v"):
            rows = kv[side]                            # (L, 1, lb, flat)
            dst = self._cache["kv"][side]
            if self.kv_spec is not None:
                codes, scale, zero = quantize_kv_rows(
                    rows, self.kv_spec.bits or 8)
                dst["codes"][:, slot:slot + 1, :lb] = codes
                dst["scale"][:, slot:slot + 1, :lb] = scale
                dst["zero"][:, slot:slot + 1, :lb] = zero
            else:
                dst[:, slot:slot + 1, :lb] = rows.to(dst.dtype)
        self._cache["index"][slot] = lp

    def _sample1(self, logits_row, rid: int, req: Request,
                 count: int = 0) -> int:
        """Token ``count`` of request ``rid`` from one row of logits."""
        key = slot_keys(self._base_key,
                        torch.tensor([rid], device=self.device),
                        torch.tensor([count], device=self.device))
        f32 = torch.float32
        tok = sample_tokens(
            logits_row[None], key,
            torch.tensor([req.temperature], dtype=f32, device=self.device),
            torch.tensor([req.top_k], device=self.device),
            self.cfg.vocab_size,
            torch.tensor([req.top_p], dtype=f32, device=self.device))
        return int(tok[0])

    # -- scheduler ---------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new: int = 32,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
               eos_id: Optional[int] = None) -> int:
        """Queue one request; returns its request id."""
        prompt = tuple(int(t) for t in prompt)
        if not 1 <= len(prompt) <= self.max_seq - 1:
            raise ValueError(
                f"prompt length {len(prompt)} out of range [1, "
                f"{self.max_seq - 1}] (max_seq={self.max_seq} needs room "
                f"for at least one generated token)")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(
            rid=rid, prompt=prompt, max_new=max_new,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_id=self.eos_id if eos_id is None else eos_id))
        return rid

    def _finish(self, slot: _Slot, reason: str):
        req = slot.req
        self._completions[req.rid] = Completion(
            rid=req.rid, prompt_len=len(req.prompt),
            tokens=list(slot.tokens), reason=reason)
        slot.req = None
        slot.tokens = []
        slot.pos = 0

    def _evict(self):
        for slot in self._slots:
            if not slot.active:
                continue
            req = slot.req
            if req.eos_id is not None and slot.tokens \
                    and slot.tokens[-1] == req.eos_id:
                self._finish(slot, "eos")
            elif len(slot.tokens) >= req.max_new:
                self._finish(slot, "length")
            elif slot.pos >= self.max_seq:
                self._finish(slot, "length")     # cache lane full

    def _admit(self):
        for i, slot in enumerate(self._slots):
            if slot.active or not self._queue:
                continue
            req = self._queue.popleft()
            toks = np.asarray(req.prompt, np.int64)[None]
            logits, kv = self._prefill(toks)
            first = self._sample1(logits[0, -1], req.rid, req)
            self._insert(kv, i, len(req.prompt))
            slot.req = req
            slot.pos = len(req.prompt)
            slot.tokens = [first]
        # a request can terminate straight out of prefill
        self._evict()

    # -- the loop ----------------------------------------------------------
    def step(self) -> int:
        """Admit waiting requests, run one full-batch decode step, record
        the new tokens.  Returns the number of tokens emitted."""
        self._evict()
        self._admit()
        live = [s for s in self._slots if s.active]
        if not live:
            return 0
        B = self.slots
        tok = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int64)
        rids = np.full((B,), -1, np.int64)
        counts = np.zeros((B,), np.int64)
        temp = np.zeros((B,), np.float32)
        topk = np.zeros((B,), np.int64)
        topp = np.zeros((B,), np.float32)
        for i, slot in enumerate(self._slots):
            if not slot.active:
                continue
            tok[i] = slot.tokens[-1]
            pos[i] = slot.pos
            rids[i] = slot.req.rid
            counts[i] = len(slot.tokens)
            temp[i] = slot.req.temperature
            topk[i] = slot.req.top_k
            topp[i] = slot.req.top_p
        t0 = time.perf_counter()
        nxt = self._decode(*(self._tensor(a) for a in
                             (tok, pos, rids, counts, temp, topk, topp)))
        nxt = nxt.cpu().numpy()               # waits for the device
        dt = time.perf_counter() - t0
        emitted = 0
        for i, slot in enumerate(self._slots):
            if not slot.active:
                continue
            slot.tokens.append(int(nxt[i]))
            slot.pos += 1
            emitted += 1
        self.step_times.append((dt, emitted))
        return emitted

    def run(self, max_steps: Optional[int] = None) -> Dict[int, Completion]:
        """Drive until the queue and pool drain; returns the completions
        collected by THIS call ({rid: Completion}) and clears them."""
        steps = 0
        while self._queue or any(s.active for s in self._slots):
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        self._evict()
        done = self._completions
        self._completions = {}
        return done

    @property
    def active_slots(self) -> int:
        return sum(s.active for s in self._slots)

    @property
    def queued(self) -> int:
        return len(self._queue)

    def completions(self) -> Dict[int, Completion]:
        """Completions finished but not yet collected by a ``run`` call."""
        return dict(self._completions)

"""Paged int8 KV serving: shared page pool, block tables, prefix reuse,
chunked prefill, preemption, self-speculative low-bit decode.

Port of ``repro.serve.paged``.  The dense-lane engine (serve/engine.py)
pins ``max_seq`` cache rows per resident request; this engine stores the
same int8 codec as fixed-size **pages** in one pool shared by all lanes:

  * **pages + block tables** — a request owns a host-side list of page ids
    (its block table), allocated on first write and freed on eviction.
    Page 0 is the garbage page: idle lanes and unallocated blocks point at
    it, and the position mask hides every read of it.
  * **gather decode** — each step runs the paged multi-token forward
    (models/lm.py ``lm_paged_decode``): quantize-on-write into the owning
    page, then gather the whole table back, K and V in one launch of the
    ``kv_gather_pages_kv`` CUDA kernel (the ``kernel`` backend on the card;
    its plain version otherwise).  A one-token step is arithmetically the dense lane step,
    so with whole-prompt prefill and spec decode off the engine emits the
    dense engine's tokens at equal seeds, slots and submission order.
  * **prefix reuse** — at prefill completion every full-page prompt
    boundary (and the partial tail) registers ``prompt[:m] -> pages``
    with a refcount per page; a later prompt adopts the longest registered
    prefix, shares its full pages, copies a partial boundary page on write
    and restarts prefill at ``m``.
  * **chunked prefill** — a prompt longer than ``prefill_chunk`` (or one
    resumed from a prefix) streams in one ``C = prefill_chunk`` paged
    forward per engine step, interleaved with decode.
  * **speculative decode** — ``spec_decode=True`` runs serve/spec.py's
    propose/verify loop with the same parameters under a 4-bit draft
    policy.
  * **preemption** — when the pool runs dry the youngest request younger
    than the one asking is preempted: its pages are freed and it re-queues
    with its tokens carried.  Sampling keys depend only on ``(seed, rid,
    token index)``, so a resumed request emits the tokens it would have.

The host-side tables are numpy; the pool is updated in place on the
device.
"""

from __future__ import annotations

import time
from collections import Counter, OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import quantize_kv_rows
from ..layers.attention import last_write
from .engine import ServeEngine, _Slot
from .sampling import sample_tokens, slot_keys
from .spec import SpecStats, default_draft_policy, greedy_accept

__all__ = ["PagePool", "PrefixCache", "PagedServeEngine", "GARBAGE_PAGE"]

GARBAGE_PAGE = 0


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class PagePool:
    """Host-side allocator for the device page pool: a free list and
    per-page refcounts.  Page 0 (``GARBAGE_PAGE``) is never allocated or
    freed.  ``alloc`` returns a page at refcount 1; each further owner (a
    second block table, a prefix-cache entry) takes ``incref`` and releases
    with ``decref``; a page returns to the free list at refcount 0."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(f"n_pages={n_pages}: need at least the garbage "
                             f"page plus one allocatable page")
        self.n_pages = n_pages
        self.page_size = page_size
        self.refs = np.zeros((n_pages,), np.int32)
        self._free: deque = deque(range(1, n_pages))
        self.peak_in_use = 0

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        pid = self._free.popleft()
        self.refs[pid] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pid

    def incref(self, pid: int) -> None:
        if pid == GARBAGE_PAGE:
            return
        assert self.refs[pid] > 0, f"incref on free page {pid}"
        self.refs[pid] += 1

    def decref(self, pid: int) -> None:
        if pid == GARBAGE_PAGE:
            return
        assert self.refs[pid] > 0, f"decref on free page {pid}"
        self.refs[pid] -= 1
        if self.refs[pid] == 0:
            self._free.append(pid)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_pages - 1 - len(self._free)

    @property
    def utilization(self) -> float:
        return self.in_use / max(self.n_pages - 1, 1)

    def check(self, tables: List[List[int]],
              registry_pages: List[Tuple[int, ...]]) -> None:
        """Recompute every page's refcount from the live block tables and
        registry entries and compare; free pages must hold no refs."""
        expect = np.zeros_like(self.refs)
        for table in tables:
            for pid in table:
                if pid != GARBAGE_PAGE:
                    expect[pid] += 1
        for pages in registry_pages:
            for pid in pages:
                expect[pid] += 1
        if not np.array_equal(expect, self.refs):
            bad = np.nonzero(expect != self.refs)[0]
            raise AssertionError(
                f"refcount drift on pages {bad.tolist()}: expected "
                f"{expect[bad].tolist()}, have {self.refs[bad].tolist()}")
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        for pid in free:
            assert self.refs[pid] == 0, f"free page {pid} has refs"


class PrefixCache:
    """Hash-consed prompt prefixes ``tokens -> (n_tokens, pages)``, in LRU
    order, holding one refcount on every page of every entry.  ``lookup``
    returns the longest registered prefix strictly shorter than the
    context, so an adopter always recomputes at least its last position."""

    def __init__(self, max_entries: int = 128):
        self.max_entries = max_entries
        self.entries: "OrderedDict[tuple, Tuple[int, Tuple[int, ...]]]" = \
            OrderedDict()
        self._lengths: Counter = Counter()
        self.hits = 0
        self.evictions = 0

    def register(self, tokens: tuple, pages: Tuple[int, ...],
                 pool: PagePool) -> None:
        key = tuple(tokens)
        if key in self.entries:
            self.entries.move_to_end(key)
            return
        for pid in pages:
            pool.incref(pid)
        self.entries[key] = (len(key), pages)
        self._lengths[len(key)] += 1
        while len(self.entries) > self.max_entries:
            self.evict_lru(pool)

    def lookup(self, ctx: tuple) -> Tuple[int, Tuple[int, ...]]:
        """Longest registered prefix of ``ctx`` with ``m <= len(ctx) - 1``;
        (0, ()) on a miss."""
        for m in sorted((ln for ln in self._lengths if ln <= len(ctx) - 1),
                        reverse=True):
            entry = self.entries.get(tuple(ctx[:m]))
            if entry is not None:
                self.entries.move_to_end(tuple(ctx[:m]))
                self.hits += 1
                return m, entry[1]
        return 0, ()

    def evict_lru(self, pool: PagePool) -> bool:
        if not self.entries:
            return False
        _, (n, pages) = self.entries.popitem(last=False)
        self._lengths[n] -= 1
        if not self._lengths[n]:
            del self._lengths[n]
        for pid in pages:
            pool.decref(pid)
        self.evictions += 1
        return True

    def clear(self, pool: PagePool) -> None:
        while self.evict_lru(pool):
            pass

    def registered_pages(self) -> List[Tuple[int, ...]]:
        return [pages for _n, pages in self.entries.values()]


class _PagedSlot(_Slot):
    """One decode lane plus its paged state."""

    __slots__ = ("table", "ctx", "done", "phase", "needs_first", "admit_seq")

    def __init__(self):
        super().__init__()
        self.table: List[int] = []     # physical page ids, logical order
        self.ctx: tuple = ()           # tokens to prefill (prompt [+carry])
        self.done = 0                  # prefilled positions so far
        self.phase = "decode"          # "prefill" | "decode"
        self.needs_first = True        # sample token 0 from prefill logits?
        self.admit_seq = -1            # admission order (preemption picks max)


class PagedServeEngine(ServeEngine):
    """See module docstring.  Built by ``ServeEngine(..., paged=True)``; the
    scheduler surface (``submit`` / ``step`` / ``run`` / ``completions``)
    is the dense engine's.  ``paged_forwards`` counts the paged forwards
    run (decode, chunk, draft and verify steps), each of which reads K and
    V of every layer through one ``kv_gather_pages_kv`` launch."""

    def __init__(self, cfg, params, *, page_size: int = 8,
                 pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_sharing: bool = True, prefix_entries: int = 128,
                 spec_decode: bool = False, spec_k: int = 3,
                 draft_policy=None, kv_quant=True, paged: bool = True,
                 **kw):
        del paged                      # consumed by ServeEngine.__new__
        if page_size < 1:
            raise ValueError(f"page_size={page_size} must be >= 1")
        if spec_k < 1:
            raise ValueError(f"spec_k={spec_k} must be >= 1")
        if not kv_quant:
            raise ValueError("the paged engine stores pages in the int8 KV "
                             "codec; kv_quant must name a kv_cache spec "
                             "(True/'kv_int8:8'), not False")
        self.page_size = page_size
        self._pages_arg = pages
        self.prefill_chunk = prefill_chunk
        self.prefix_sharing = prefix_sharing
        self._prefix_entries = prefix_entries
        self.spec_decode = spec_decode
        self.spec_k = spec_k
        super().__init__(cfg, params, kv_quant=kv_quant, **kw)
        self._draft_policy = (draft_policy if draft_policy is not None
                              else default_draft_policy(
                                  self.policy, self.weight_bits is not None))
        self.spec_stats = SpecStats()
        self.page_usage: List[int] = []      # pages in use, per step
        self.page_events: Dict[str, int] = {
            "prefix_hits": 0, "cow_copies": 0, "preemptions": 0,
            "registered": 0}
        self.paged_forwards = 0
        self._resume: deque = deque()        # (Request, carried, admit_seq)
        self._admit_counter = 0

    # -- construction ------------------------------------------------------
    def _init_cache(self):
        if self.kv_spec is None:
            raise ValueError(f"{self.cfg.name}: paged serving requires the "
                             f"int8 KV cache")
        if self.max_seq % self.page_size:
            raise ValueError(f"max_seq={self.max_seq} must be a multiple of "
                             f"page_size={self.page_size} (block tables "
                             f"cover whole pages)")
        self.nb = self.max_seq // self.page_size
        self.n_pages = (self._pages_arg if self._pages_arg is not None
                        else 1 + self.slots * self.nb)
        if self.prefill_chunk is None:
            self.prefill_chunk = self.max_seq
        self.pool_host = PagePool(self.n_pages, self.page_size)
        self._prefix = PrefixCache(self._prefix_entries)
        self._slots = [_PagedSlot() for _ in range(self.slots)]
        return self.model.init_paged_pool(self.cfg, self.n_pages,
                                          self.page_size, device=self.device)

    # -- device steps ------------------------------------------------------
    def _forward(self, tokens: np.ndarray, table: np.ndarray,
                 start: np.ndarray, policy):
        """One paged forward of ``tokens`` (B, C) at positions ``start``
        (B,) through the block tables ``table`` (B, nb); the pool is
        written in place.  Returns logits (B, C, Vp)."""
        self.paged_forwards += 1
        logits, self._cache = self.model.paged_decode(
            self.params, self._cache, {"tokens": self._tensor(tokens)},
            policy, self._tensor(table), self._tensor(start),
            kv_quant=self.kv_spec)
        return logits

    def _insert_pages(self, kv, table_row: np.ndarray) -> None:
        """Scatter a prefill bucket (L, 1, lb, flat) into the slot's pages,
        quantizing rows as the dense engine's lane insert does.  Rows past
        the real context land in the tail page or the garbage page and
        stay masked until overwritten; rows that share a garbage-page row
        all carry the last one's value (``last_write``), as the
        reference's in-order scatter leaves it."""
        lb = kv["k"].shape[2]
        P = self.page_size
        offs = np.arange(lb)
        pids = self._tensor(table_row[offs // P].astype(np.int64))
        rows = self._tensor(offs % P)
        src = last_write(pids * P + rows, self.n_pages * P)
        bits = self.kv_spec.bits or 8
        for side in ("k", "v"):
            codes, scale, zero = quantize_kv_rows(kv[side], bits)
            dst = self._cache[side]
            dst["codes"][:, pids, rows] = codes[:, 0, src]
            dst["scale"][:, pids, rows] = scale[:, 0, src]
            dst["zero"][:, pids, rows] = zero[:, 0, src]

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one page across all layers and both sides: the
        copy-on-write at a shared partial-page divergence."""
        for side in self._cache.values():
            for leaf in side.values():
                leaf[:, dst] = leaf[:, src]

    # -- page pressure -----------------------------------------------------
    def _alloc_page(self, requester: _PagedSlot) -> Optional[int]:
        """One page: the free list, else evict prefix-cache LRU entries,
        else preempt the youngest request younger than the requester (the
        oldest resident request is never preempted, so it always
        completes)."""
        while True:
            pid = self.pool_host.alloc()
            if pid is not None:
                return pid
            if self._prefix.evict_lru(self.pool_host):
                continue
            victim = None
            for slot in self._slots:
                if slot.active and slot is not requester \
                        and slot.admit_seq > requester.admit_seq:
                    if victim is None or slot.admit_seq > victim.admit_seq:
                        victim = slot
            if victim is None:
                return None
            self._preempt(victim)

    def _ensure_blocks(self, slot: _PagedSlot, n_blocks: int) -> bool:
        while len(slot.table) < n_blocks:
            pid = self._alloc_page(slot)
            if pid is None:
                return False
            slot.table.append(pid)
        return True

    def _preempt(self, slot: _PagedSlot) -> None:
        """Free the slot's pages and re-queue its request (front) with the
        generated tokens carried."""
        self.page_events["preemptions"] += 1
        for pid in slot.table:
            self.pool_host.decref(pid)
        self._resume.appendleft((slot.req, list(slot.tokens), slot.admit_seq))
        self._reset_slot(slot)

    def _reset_slot(self, slot: _PagedSlot) -> None:
        slot.req = None
        slot.tokens = []
        slot.pos = 0
        slot.table = []
        slot.ctx = ()
        slot.done = 0
        slot.phase = "decode"
        slot.needs_first = True

    def _finish(self, slot: _PagedSlot, reason: str) -> None:
        for pid in slot.table:
            self.pool_host.decref(pid)
        slot.table = []
        super()._finish(slot, reason)
        self._reset_slot(slot)

    # -- admission / prefill -----------------------------------------------
    def _table_row(self, slot: _PagedSlot) -> np.ndarray:
        row = np.zeros((self.nb,), np.int32)
        row[:len(slot.table)] = slot.table
        return row

    def _register_prefix(self, slot: _PagedSlot) -> None:
        if not self.prefix_sharing:
            return
        prompt = slot.req.prompt
        lp, P = len(prompt), self.page_size
        for b in range(P, lp + 1, P):
            self._prefix.register(prompt[:b], tuple(slot.table[:b // P]),
                                  self.pool_host)
            self.page_events["registered"] += 1
        if lp % P:
            self._prefix.register(prompt,
                                  tuple(slot.table[:_ceil_div(lp, P)]),
                                  self.pool_host)
            self.page_events["registered"] += 1

    def _adopt_prefix(self, slot: _PagedSlot, ctx: tuple) -> int:
        """Adopt the longest registered prefix of ``ctx``: share its full
        pages, copy a partial tail page on write.  Returns the positions
        already in the pool (0 on a miss)."""
        if not self.prefix_sharing:
            return 0
        m, pages = self._prefix.lookup(ctx)
        if not m:
            return 0
        P = self.page_size
        full, partial = m // P, m % P
        for pid in pages[:full]:
            self.pool_host.incref(pid)
            slot.table.append(pid)
        if partial:
            # pin the divergence page: the alloc below may evict the very
            # registry entry it came from and recycle it as our dst
            src = pages[full]
            self.pool_host.incref(src)
            dst = self._alloc_page(slot)
            if dst is None:
                m = full * P           # recompute the partial rows instead
            else:
                self._copy_page(src, dst)
                slot.table.append(dst)
                self.page_events["cow_copies"] += 1
            self.pool_host.decref(src)
        if m:
            self.page_events["prefix_hits"] += 1
        return m

    def _bucket_prefill(self, slot: _PagedSlot) -> bool:
        """Whole-context prefill through the dense engine's bucket path,
        scattered into pages: the dense engine's admission inputs, bit for
        bit."""
        ctx = slot.ctx
        if not self._ensure_blocks(slot, _ceil_div(len(ctx), self.page_size)):
            return False
        logits, kv = self._prefill(np.asarray(ctx, np.int64)[None])
        self._insert_pages(kv, self._table_row(slot))
        self._finish_prefill(slot, logits, last_row=None)
        return True

    def _chunk_prefill_step(self, slot: _PagedSlot) -> bool:
        """Advance one ``prefill_chunk`` slab of a long (or prefix-resumed)
        context through the paged multi-token forward."""
        C = self.prefill_chunk
        ctx, n = slot.ctx, len(slot.ctx)
        start = slot.done
        take = min(C, n - start)
        if not self._ensure_blocks(slot,
                                   _ceil_div(start + take, self.page_size)):
            return False
        buf = np.zeros((1, C), np.int64)
        buf[0, :take] = ctx[start:start + take]
        logits = self._forward(buf, self._table_row(slot)[None],
                               np.asarray([start], np.int64), self.policy)
        slot.done = start + take
        if slot.done >= n:
            self._finish_prefill(slot, logits, last_row=take - 1)
        return True

    def _finish_prefill(self, slot: _PagedSlot, logits, last_row) -> None:
        req = slot.req
        if slot.needs_first:
            lg = logits[0, -1] if last_row is None else logits[0, last_row]
            slot.tokens = [self._sample1(lg, req.rid, req)]
        slot.pos = len(slot.ctx)
        slot.done = len(slot.ctx)
        slot.phase = "decode"
        if slot.needs_first:
            self._register_prefix(slot)

    def _admit(self):
        for slot in self._slots:
            if slot.active:
                continue
            if self._resume:
                # a preempted request keeps its admission age, so it may
                # reclaim pages from anything that arrived after it
                req, carried, seq = self._resume.popleft()
            elif self._queue:
                req, carried, seq = (self._queue.popleft(), [],
                                     self._admit_counter)
                self._admit_counter += 1
            else:
                continue
            slot.req = req
            slot.tokens = list(carried)
            slot.needs_first = not carried
            slot.admit_seq = seq
            ctx = req.prompt + tuple(carried[:-1])
            slot.ctx = ctx
            m = self._adopt_prefix(slot, ctx)
            slot.done = m
            slot.pos = m
            if m == 0 and len(ctx) <= self.prefill_chunk:
                ok = self._bucket_prefill(slot)
            else:
                slot.phase = "prefill"
                ok = self._chunk_prefill_step(slot)
            if not ok:
                # not even with preemption: push back, stop admitting
                carried = list(slot.tokens)
                for pid in slot.table:
                    self.pool_host.decref(pid)
                self._resume.appendleft((slot.req, carried, slot.admit_seq))
                self._reset_slot(slot)
                break
        self._evict()

    # -- the loop ----------------------------------------------------------
    def step(self) -> int:
        self._evict()
        self._admit()
        for slot in self._slots:
            if slot.active and slot.phase == "prefill":
                if not self._chunk_prefill_step(slot):
                    self._preempt(slot)
        self._evict()
        decode = [s for s in self._slots if s.active and s.phase == "decode"]
        self.page_usage.append(self.pool_host.in_use)
        if not decode:
            if not any(s.active for s in self._slots) \
                    and (self._queue or self._resume):
                raise RuntimeError(
                    f"page pool ({self.n_pages} pages x {self.page_size} "
                    f"rows) cannot hold a single queued request; grow "
                    f"`pages` or shrink prompts")
            return 0
        if self.spec_decode:
            fits = all(s.pos + self.spec_k <= self.max_seq - 1
                       for s in decode)
            if fits and all(
                    self._ensure_blocks(
                        s, (s.pos + self.spec_k) // self.page_size + 1)
                    for s in decode if s.active):
                decode = [s for s in self._slots
                          if s.active and s.phase == "decode"]
                if decode:
                    return self._spec_step(decode)
                return 0
            self.spec_stats.fallback_steps += 1
        return self._plain_step()

    def _plain_step(self) -> int:
        B = self.slots
        for slot in self._slots:
            if slot.active and slot.phase == "decode":
                if not self._ensure_blocks(slot,
                                           slot.pos // self.page_size + 1):
                    self._preempt(slot)
        tok = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int64)
        rids = np.full((B,), -1, np.int64)
        counts = np.zeros((B,), np.int64)
        temp = np.zeros((B,), np.float32)
        topk = np.zeros((B,), np.int64)
        topp = np.zeros((B,), np.float32)
        table = np.zeros((B, self.nb), np.int32)
        live = []
        for i, slot in enumerate(self._slots):
            if not slot.active or slot.phase != "decode":
                continue
            live.append(i)
            tok[i] = slot.tokens[-1]
            pos[i] = slot.pos
            rids[i] = slot.req.rid
            counts[i] = len(slot.tokens)
            temp[i] = slot.req.temperature
            topk[i] = slot.req.top_k
            topp[i] = slot.req.top_p
            table[i] = self._table_row(slot)
        if not live:
            return 0
        t0 = time.perf_counter()
        logits = self._forward(tok[:, None], table, pos, self.policy)
        keys = slot_keys(self._base_key, self._tensor(rids),
                         self._tensor(counts))
        nxt = sample_tokens(logits[:, -1], keys, self._tensor(temp),
                            self._tensor(topk), self.cfg.vocab_size,
                            self._tensor(topp))
        nxt = nxt.cpu().numpy()               # waits for the device
        dt = time.perf_counter() - t0
        for i in live:
            slot = self._slots[i]
            slot.tokens.append(int(nxt[i]))
            slot.pos += 1
        self.step_times.append((dt, len(live)))
        return len(live)

    def run(self, max_steps=None):
        """The dense drain loop, counting preempted requests waiting to
        resume as pending work."""
        steps = 0
        while self._queue or self._resume \
                or any(s.active for s in self._slots):
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        self._evict()
        done = self._completions
        self._completions = {}
        return done

    # -- speculative decode ------------------------------------------------
    def _spec_step(self, decode: List[_PagedSlot]) -> int:
        """One propose/verify round: k greedy draft steps (provisional KV),
        one (B, k+1) verify forward that overwrites those rows with target
        KV, then exact greedy acceptance per slot.  A temperature slot
        takes one token sampled from the verify's first-position logits."""
        B, k = self.slots, self.spec_k
        vocab = self.cfg.vocab_size
        tok = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int64)
        table = np.zeros((B, self.nb), np.int32)
        lanes = []
        for i, slot in enumerate(self._slots):
            if slot in decode:
                lanes.append(i)
                tok[i] = slot.tokens[-1]
                pos[i] = slot.pos
                table[i] = self._table_row(slot)
        prop = np.zeros((B, k + 1), np.int64)
        prop[:, 0] = tok
        t0 = time.perf_counter()
        cur = tok
        for j in range(k):
            logits = self._forward(cur[:, None], table, pos + j,
                                   self._draft_policy)
            cur = torch.argmax(logits[:, -1, :vocab], dim=-1).cpu().numpy()
            prop[:, j + 1] = cur
        logits = self._forward(prop, table, pos, self.policy)
        gv = torch.argmax(logits[:, :, :vocab], dim=-1).cpu().numpy()
        dt = time.perf_counter() - t0
        emitted_total = 0
        for i in lanes:
            slot = self._slots[i]
            req = slot.req
            if req.temperature > 0.0:
                out = [self._sample1(logits[i, 0], req.rid, req,
                                     count=len(slot.tokens))]
            else:
                out = greedy_accept(prop[i, 1:], gv[i])
                self.spec_stats.proposed += k
                self.spec_stats.accepted += len(out) - 1
            if req.eos_id is not None and req.eos_id in out:
                out = out[:out.index(req.eos_id) + 1]
            out = out[:req.max_new - len(slot.tokens)]
            slot.tokens.extend(out)
            slot.pos += len(out)
            emitted_total += len(out)
        self.spec_stats.spec_steps += 1
        self.spec_stats.emitted += emitted_total
        self.step_times.append((dt, emitted_total))
        return emitted_total

    # -- introspection -----------------------------------------------------
    @property
    def queued(self) -> int:
        return len(self._queue) + len(self._resume)

    def pool_stats(self) -> dict:
        usage = self.page_usage or [0]
        return {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "pages_in_use": self.pool_host.in_use,
            "peak_pages_in_use": self.pool_host.peak_in_use,
            "mean_utilization": float(np.mean(usage)) /
                                max(self.n_pages - 1, 1),
            "peak_utilization": self.pool_host.peak_in_use /
                                max(self.n_pages - 1, 1),
            "prefix_entries": len(self._prefix.entries),
            "paged_forwards": self.paged_forwards,
            **self.page_events,
        }

    def check_invariants(self) -> None:
        """Refcount and table cross-check."""
        self.pool_host.check(
            [s.table for s in self._slots if s.active],
            self._prefix.registered_pages())

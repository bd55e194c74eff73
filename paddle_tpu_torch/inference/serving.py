"""Continuous-batching LLM serving — the port of
``paddle_tpu/inference/serving.py``.

ONE engine whose batch dimension is a pool of slots with independent
positions, so requests of different prompt lengths and generation budgets
share every decode step (iteration-level scheduling): a queued request
takes a free slot, prefills, and joins the next burst of ``burst``
single-token steps over all active slots; a slot retires on EOS or its
length budget and emits padding until the host swaps a new request in
between bursts. Three KV layouts share that scheduler, as in the JAX
package:

  * ``kv_layout="paged"`` (the default) — a shared ``[num_pages,
    page_size, KV, hd]`` pool per layer with per-slot block tables
    (``models/llama_paged.py``). Pages are allocated on admit and per
    burst, freed on retire; when the pool runs dry mid-flight the
    youngest slot is preempted back to the queue front (at temperature 0
    its tokens regenerate exactly). A prompt is padded to its bucket and
    prefilled alone (``llama_paged_prefill_slot``: kernel K1 in every
    layer); decode gathers each slot's pages through the block table,
    ``page_bucket × page_size`` rows (``llama_paged_decode_burst``). The
    step is OVERLAPPED as in JAX: dispatch the burst, then do the host
    work (admissions, their prefills, page allocation and frees) while
    the device runs, then block once on one readback of the burst and
    the prefills' first tokens. Every pool write goes on the pool's
    stream, so pages freed right after a prefill's dispatch are rewritten
    by a later owner only behind it.
  * ``kv_layout="ragged"`` — the same pool read through the ragged kernel
    (kernels K3/K4): admissions prefill inside the burst as (token row,
    length) pairs (``llama_ragged_burst``), the block table rides full
    width, and there is neither a page bucket nor a per-prompt prefill.
    Unlike the JAX engine it never falls back to the gather path.
  * ``kv_layout="dense"`` — per-slot ``[max_batch, max_len]`` rows
    (``llama_decode``'s slot primitives), the equivalence baseline: no
    pages, no quantized pages, no prefix sharing, no speculation.

Quantized pages (paged pools): ``kv_dtype="int8"`` or ``"fp8"`` stores the
pool through the port's block codecs (``quant/codec.py``: payload plus one
f32 scale per (row, kv head)); the ragged path dequantizes in kernel K4,
the gather path right after its gather. ``pool_hbm_bytes`` sizes the pool
by a byte budget instead of a page count: the same budget buys ~1.94× the
pages in int8 or fp8 at head_dim 128, scales included.

Serving precision: ``precision="int8"`` (or ``"weight_only_int8"``)
quantizes the weights once here (``quantization.weight_only_quantize``)
and every step dequantizes one layer's weights at a time just before use
(``dequant=``); ``"bfloat16"`` casts the weights and serves a bf16 config.
``"float16"`` raises: kernels K1 and K3 take f32 and bf16 only.

Prefix sharing (``prefix_cache_pages=N``, paged pools): a page-granular
prefix index (``prefix_cache.py``) over the pool. An admission whose
prompt shares full pages with an earlier one maps them copy-on-write and
prefills only the unshared suffix (the ragged row's ``prefill_start``, or
``llama_paged_prefill_suffix``); a full-prefix hit runs no prefill and
resumes decode at the last prompt token. A prompt's pages enter the index
only once its prefill has been read back. Before every launch the growth
sweep copies any shared page in a slot's write window into a private one
(``_cow_for_burst``); idle indexed pages are reclaimed before anyone is
preempted.

Speculative decoding (``spec_decode=True, spec_k=k,
spec_draft_layers=n``, paged pools): when no admission could run instead,
a step lets the draft (``speculative.py``) propose up to k tokens per slot
and ONE target launch per layer verifies every slot's segment
(``llama_paged_verify`` on the engine's read path); the accept-prefix walk
emits 1..k+1 tokens per slot, token-identical to plain greedy decode, and
the rejected tail's pages are freed.

The host scheduler is plain Python between device calls and keeps slot
state in numpy; each step blocks on one device-to-host readback of its
results (the dense layout: one for its admissions' first tokens, one for
the burst, as in JAX).

Not ported yet: admission policies (``admission=`` raises), the
environment knobs (``PADDLE_SERVE_KV_DTYPE``, ``PADDLE_PREFIX_CACHE_PAGES``,
``PADDLE_SPEC_*``, which the JAX engine reads when the argument is None;
here None means off until ``utils/env_flags.py`` is ported), page
export/import for disaggregated serving, and the metrics, chaos, SLO and
admin hooks (ROADMAP Queue 1 items 5 and 7).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..quant.codec import normalize_kv_dtype
from ..quantization import weight_only_dequantize, weight_only_quantize
from .paging import (PageAllocator, SCRATCH_PAGE, default_page_buckets,
                     pages_for, pages_for_budget)
from .prefix_cache import PrefixCache
from .speculative import accept_prefix, spec_from_env

__all__ = ["ContinuousBatcher", "ServedRequest"]


def _read_back(*tensors) -> list:
    """ONE device-to-host copy of int or bool device tensors, each widened
    to int32: numpy arrays of their shapes, in order."""
    flat = torch.cat([t.to(torch.int32).reshape(-1)
                      for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(tuple(t.shape)))
        off += t.numel()
    return out


@dataclasses.dataclass
class ServedRequest:
    rid: int
    prompt: list
    max_new_tokens: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    reason: str = "complete"   # how it retired


class ContinuousBatcher:
    """Slot-pool serving engine over a paged (gather or ragged read) or
    dense KV cache.

    engine = ContinuousBatcher(cfg, params, max_batch=8, max_len=1024)
    rid = engine.add_request([1, 2, 3], max_new_tokens=64)
    results = engine.run()          # {rid: [generated token ids]}
    """

    def __init__(self, model_config, params, max_batch: int = 4,
                 max_len: int = 512,
                 prompt_buckets: Sequence[int] = (32, 64, 128, 256),
                 burst: int = 8, eos_id: int | None = None, pad_id: int = 0,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 precision: str | None = None, kv_layout: str = "paged",
                 page_size: int = 16, num_pages: int | None = None,
                 page_buckets: Sequence[int] | None = None,
                 kv_dtype: str | None = None,
                 pool_hbm_bytes: int | None = None,
                 prefix_cache_pages: int | None = None,
                 spec_decode: bool | None = None, spec_k: int | None = None,
                 spec_draft_layers: int | None = None, admission=None,
                 device="cuda"):
        if kv_layout not in ("paged", "dense", "ragged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if admission:
            raise NotImplementedError(
                f"admission={admission!r} is not ported yet (ROADMAP Queue "
                "1 item 5)")
        self._dev = resolve_device(device)
        if params["embed_tokens"].device != self._dev:
            raise ValueError(f"params live on "
                             f"{params['embed_tokens'].device}, the engine "
                             f"was asked to run on {self._dev}")
        # the draft builds from the view BEFORE the serving precision, as
        # in the JAX engine
        spec_src = (model_config, params)
        self._dequant = None
        if precision in ("int8", "weight_only_int8"):
            # weights live quantized on the device; every step dequantizes
            # one layer's weights at a time just before use
            params = weight_only_quantize(params)
            self._dequant = weight_only_dequantize
        elif precision == "bfloat16":
            params = {k: v.to(torch.bfloat16) for k, v in params.items()}
            # the config drives activation and KV dtype: bf16 weights
            # under an f32 config would promote every product to f32
            model_config = dataclasses.replace(model_config,
                                               dtype=torch.bfloat16)
        elif precision == "float16":
            raise NotImplementedError(
                "precision='float16' is not served by the port: kernels K1 "
                "and K3 take f32 and bf16 only (ROADMAP Queue 2, "
                "configurations the port does not yet run: fp16)")
        elif precision is not None:
            raise ValueError(f"unknown serving precision {precision!r}")
        self._cfg = model_config
        self._params = params
        # "int8" | "fp8" | None; every unquantized spelling is None, a
        # typo raises
        self._kv_dtype = normalize_kv_dtype(kv_dtype)
        if kv_layout == "dense":
            if self._kv_dtype is not None:
                raise ValueError("kv_dtype quantization needs the paged "
                                 "pool (kv_layout='paged' or 'ragged'); "
                                 "the dense slot cache is the "
                                 "full-precision baseline")
            if pool_hbm_bytes is not None:
                raise ValueError("pool_hbm_bytes sizes the paged page "
                                 "pool; the dense slot cache is sized by "
                                 "max_batch × max_len — a silently ignored "
                                 "budget would hide a misconfiguration")
            if prefix_cache_pages:
                raise ValueError("prefix sharing needs the paged pool "
                                 "(kv_layout='paged' or 'ragged') — the "
                                 "dense slot cache has no shareable page "
                                 "unit")
        # "ragged" is the paged pool read through the ragged kernel
        self._ragged = kv_layout == "ragged"
        self._layout = "dense" if kv_layout == "dense" else "paged"
        self.B, self.S = int(max_batch), int(max_len)
        self._buckets = tuple(sorted(b for b in prompt_buckets
                                     if b <= max_len))
        if not self._buckets:
            raise ValueError("no prompt bucket fits max_len")
        self.burst = int(burst)
        self.eos_id = -1 if eos_id is None else int(eos_id)
        self.pad_id = int(pad_id)
        self._temp, self._top_k = float(temperature), int(top_k)
        self._gen = torch.Generator(device=self._dev)
        self._gen.manual_seed(int(seed))

        # slot state lives host-side and is uploaded per burst
        self._pos = np.zeros(self.B, np.int32)
        self._tok = np.zeros(self.B, np.int32)
        self._done = np.ones(self.B, bool)         # done == slot free
        self._limit = np.zeros(self.B, np.int32)
        self._slot_req: list[ServedRequest | None] = [None] * self.B

        self._queue: deque[ServedRequest] = deque()
        self._finished: dict[int, ServedRequest] = {}
        self._next_rid = 0
        self.stats = {"bursts": 0, "decode_steps": 0, "prefills": 0,
                      "prefill_bursts": 0, "admission_stalls": 0,
                      "preemptions": 0, "max_concurrent": 0,
                      "page_buckets_used": []}
        # the prefix_* / cow_copies / spec_* counters appear on first use,
        # as in the JAX engine
        self._prefix = None
        if self._layout == "paged":
            self._init_pool(page_size, num_pages, page_buckets,
                            pool_hbm_bytes, prefix_cache_pages)
        else:
            from ..models.llama_decode import init_kv_cache
            self._cache = init_kv_cache(self._cfg, self.B, self.S,
                                        device=self._dev)
        # the draft half of speculative decoding; None when off or gated
        self._spec, why = spec_from_env(
            spec_src[0], spec_src[1], max_batch=self.B, max_len=self.S,
            prompt_buckets=self._buckets, temperature=self._temp,
            paged=self._layout == "paged", spec_decode=spec_decode,
            k=spec_k, draft_layers=spec_draft_layers, device=self._dev)
        if why:
            self.stats["spec_disabled"] = why

    def _init_pool(self, page_size, num_pages, page_buckets, pool_hbm_bytes,
                   prefix_cache_pages):
        """The paged layouts' pool, allocator, page buckets, block tables
        and prefix index."""
        from ..models.llama_paged import init_paged_kv_cache, page_bytes
        self._ps = int(page_size)
        if self._ps < 1:
            raise ValueError("page_size must be >= 1")
        slot_max_pages = pages_for(self.S, self._ps)
        if pool_hbm_bytes is not None:
            # a device byte budget: as many pages as it buys at this
            # kv_dtype (scales included)
            if num_pages is not None:
                raise ValueError("pass num_pages or pool_hbm_bytes, not both")
            num_pages = pages_for_budget(
                pool_hbm_bytes,
                page_bytes(self._cfg, self._ps, self._kv_dtype))
        elif num_pages is None:
            # capacity for every slot at max_len, plus the scratch page
            num_pages = self.B * slot_max_pages + 1
        self._alloc = PageAllocator(num_pages)
        # the gather path's block-table widths: a burst reads the bucket of
        # its widest live slot (the ragged path reads full width)
        pb = (default_page_buckets(slot_max_pages) if page_buckets is None
              else tuple(sorted({min(int(p), slot_max_pages)
                                 for p in page_buckets if int(p) >= 1})))
        if not pb or pb[-1] < slot_max_pages:
            pb = tuple(sorted(set(pb) | {slot_max_pages}))
        self._page_buckets = pb
        self._cache = init_paged_kv_cache(self._cfg, num_pages, self._ps,
                                          kv_dtype=self._kv_dtype,
                                          device=self._dev)
        # per-slot block tables (host truth); _admit_seq orders slots by
        # admission for preemption
        self._page_tbl: list[list[int]] = [[] for _ in range(self.B)]
        self._admit_seq = [0] * self.B
        self._seq = 0
        # prefix index over THIS pool; None (or 0) keeps the engine
        # without one
        if prefix_cache_pages and int(prefix_cache_pages) > 0:
            self._prefix = PrefixCache(
                self._alloc, self._ps,
                min(int(prefix_cache_pages), self._alloc.usable))

    def _dev_of(self, a):
        """A host array as a tensor on the engine's device."""
        return torch.from_numpy(a).to(self._dev)

    def _table(self, active, P: int):
        """The [B, P] block table on the device: each active slot's pages,
        scratch everywhere else."""
        bt = np.full((self.B, P), SCRATCH_PAGE, np.int32)
        for b in active:
            ids = self._page_tbl[b]
            bt[b, :len(ids)] = ids
        return self._dev_of(bt)

    # ------------------------------------------------------------- intake
    def add_request(self, prompt_ids, max_new_tokens: int = 32) -> int:
        """Enqueue one request; a request that could never be admitted is
        rejected here with ValueError, never truncated later."""
        prompt, max_new_tokens = self.check_admissible(prompt_ids,
                                                       max_new_tokens)
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(ServedRequest(rid, prompt, max_new_tokens))
        return rid

    def check_admissible(self, prompt_ids,
                         max_new_tokens: int = 32) -> tuple[list, int]:
        """Raise ValueError when this request could NEVER be admitted
        (empty prompt, sub-1 budget, over-bucket/over-budget, a page
        demand beyond the pool); returns the parsed (prompt, budget)."""
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) > self._buckets[-1]:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the largest bucket "
                f"{self._buckets[-1]}")
        if len(prompt) + max_new_tokens > self.S:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len {self.S}")
        if self._layout == "paged":
            worst = pages_for(len(prompt) + max_new_tokens, self._ps)
            if not self._ragged:
                # the gather path's prefill writes the whole bucket
                worst = max(worst, pages_for(self._bucket_len(len(prompt)),
                                             self._ps))
            if worst > self._alloc.usable:
                raise ValueError(
                    f"request needs {worst} pages but the pool only has "
                    f"{self._alloc.usable} usable — it could never be "
                    "admitted")
        return prompt, max_new_tokens

    def _bucket_len(self, n: int) -> int:
        return next(b for b in self._buckets if b >= n)

    # ----------------------------------------------------------- retire
    def _finish(self, req: ServedRequest) -> None:
        req.done = True
        self._finished[req.rid] = req

    def _retire_slot(self, slot: int) -> None:
        """Free a slot and (paged) its pages. Zeroing its host state points
        its frozen writes at row 0 (of the scratch page, paged)."""
        self._slot_req[slot] = None
        self._pos[slot] = 0
        self._tok[slot] = self.pad_id
        self._done[slot] = True
        self._limit[slot] = 0
        if self._layout == "paged":
            self._alloc.free(self._page_tbl[slot])
            self._page_tbl[slot] = []
        if self._spec is not None:
            # every path that vacates a slot lands here, so the next
            # occupant re-prefills the draft from ITS sequence
            self._spec.invalidate(slot)

    def _preempt(self, slot: int) -> None:
        """Pool ran dry mid-flight: push this slot's request back to the
        FRONT of the queue and restart it later from scratch (at
        temperature 0 the regenerated tokens are identical)."""
        req = self._slot_req[slot]
        req.out = []
        self._queue.appendleft(req)
        self._retire_slot(slot)
        self.stats["preemptions"] += 1

    # ------------------------------------------------------ prefix sharing
    def _count(self, key: str, n: int = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + int(n)

    def _reclaim_to(self, need: int) -> bool:
        """free_pages >= need, evicting IDLE prefix-index pages if that is
        what it takes: the index borrows idle pool capacity, and live
        demand always wins it back."""
        short = int(need) - self._alloc.free_pages
        if short > 0 and self._prefix is not None:
            self._prefix.reclaim(short)
        return self._alloc.free_pages >= int(need)

    def _palloc(self, n: int) -> list | None:
        """alloc() with prefix-index reclaim behind it: the ONE allocation
        entry for admits, growth and copy-on-write targets."""
        if not self._reclaim_to(n):
            return None
        return self._alloc.alloc(n)

    def _prefix_match(self, req: ServedRequest) -> tuple[list, int]:
        """(shared pages, matched token count) for this prompt; each page
        already carries this request's reference (freed like any other
        page on retire)."""
        if self._prefix is None:
            return [], 0
        return self._prefix.match(req.prompt)

    def _prefix_hit_account(self, pages: list, matched: int) -> None:
        """Hit bookkeeping, called only once the admission is past its
        stall exit: a stalled request re-matches every scheduler step
        (releasing its references each time), and counting those retries
        would inflate the hit counts."""
        self._count("prefix_hits")
        self._count("prefix_tokens_shared", matched)
        self._count("prefix_pages_shared", len(pages))

    def _prefix_insert(self, req: ServedRequest, slot: int) -> None:
        """Index this request's full prompt pages so the NEXT admission
        with this prefix shares instead of recomputing. Called only once
        the prefill's readback has landed (at merge): an admit-time insert
        would let a same-pass full-prefix hit copy-on-write a page the
        burst's prefill phase has not written yet."""
        if self._prefix is not None:
            self._prefix.insert(req.prompt, self._page_tbl[slot])

    def _admit_resume(self, req: ServedRequest, slot: int,
                      shared: list) -> tuple:
        """Full-prefix hit (every prompt position's K/V already cached):
        no prefill at all; decode resumes at the LAST prompt token. The
        next launch's first step recomputes position tlen-1's K/V (a
        write the growth sweep first copies into a private tail page,
        since that page is shared) and samples the first generated token,
        the arithmetic a prefill's sampling runs. Returns the slot state
        (req, slot, pos, tok, limit) the gather path re-applies after its
        readback, which is stale for this slot."""
        tlen = len(req.prompt)
        limit = min(tlen + req.max_new_tokens - 1, self.S - 1)
        self._page_tbl[slot] = shared
        self._slot_req[slot] = req
        self._admit_seq[slot] = self._seq = self._seq + 1
        self._pos[slot] = tlen - 1
        self._tok[slot] = int(req.prompt[-1])
        self._done[slot] = False
        self._limit[slot] = limit
        self._count("prefix_resumes")
        return req, slot, tlen - 1, int(req.prompt[-1]), limit

    def _cow_for_burst(self, b: int, last_pos: int) -> bool:
        """Copy-on-write sweep over slot ``b``'s write window [pos,
        last_pos]: any page other holders still map (another block table,
        or the prefix index) is copied into a fresh private page before
        the launch's writes can touch it (the copy is enqueued first on
        the pool's stream). False when the pool cannot supply a copy
        target (the caller preempts, as for a growth deficit)."""
        from ..models.llama_paged import copy_pages
        tbl = self._page_tbl[b]
        for li in range(int(self._pos[b]) // self._ps,
                        int(last_pos) // self._ps + 1):
            if li >= len(tbl):
                break
            if self._alloc.refcount(tbl[li]) <= 1:
                continue
            got = self._palloc(1)
            if got is None:
                # zero-copy fallback: if the ONLY other holder is the
                # prefix index (refcount exactly 2 = this slot + one
                # more, and the index confirms the hold by dropping it),
                # releasing the index's reference makes the page private
                # with no allocation; without it, a worst-case-sized slot
                # whose tail page the index shares would preempt ITSELF
                # forever (free, re-admit, re-match, fail the same copy).
                # At refcount >= 3 another SLOT shares the page: keep the
                # entry and preempt
                if self._prefix is not None \
                        and self._alloc.refcount(tbl[li]) == 2 \
                        and self._prefix.drop_page(tbl[li]):
                    continue
                return False
            self._cache = copy_pages(self._cache, [tbl[li]], got)
            self._alloc.free([tbl[li]])
            tbl[li] = got[0]
            self._count("cow_copies")
        return True

    # ------------------------------------------------------------- admit
    def _admit_ragged(self):
        """Pop + allocate + stage admissions for the next burst: pages for
        the ACTUAL prompt length; the prompt prefills inside the burst. A
        prefix-index hit maps the shared pages and its row carries ONLY
        the unshared suffix (prefill_start > 0); a full-prefix hit stages
        nothing — it joins the burst's decode rows at the last prompt
        token. Returns [(req, slot, suffix_len, prefill_start)]."""
        staged = []
        stalled = False
        while self._queue and None in self._slot_req:
            req = self._queue[0]
            tlen = len(req.prompt)
            shared, matched = self._prefix_match(req)
            resume = bool(shared) and matched >= tlen
            need = 0 if resume else pages_for(tlen - matched, self._ps)
            if not self._reclaim_to(need):
                if shared:
                    self._alloc.free(shared)
                stalled = True   # stays queued; pages free as slots retire
                break
            self._queue.popleft()
            if shared:
                self._prefix_hit_account(shared, matched)
            slot = self._slot_req.index(None)
            if resume:
                self._admit_resume(req, slot, shared)
                continue
            self._page_tbl[slot] = shared + self._alloc.alloc(need)
            self._slot_req[slot] = req
            self._admit_seq[slot] = self._seq = self._seq + 1
            # host truth for the growth loop and the merge; the burst's
            # prefill phase re-derives pos/tok/done for staged slots
            self._pos[slot] = tlen
            self._tok[slot] = self.pad_id
            self._done[slot] = False
            self._limit[slot] = min(tlen + req.max_new_tokens - 1,
                                    self.S - 1)
            self.stats["prefills"] += 1
            if shared:
                self._count("prefix_marginal_pages", need)
            staged.append((req, slot, tlen - matched, matched))
        if stalled:
            self.stats["admission_stalls"] += 1
        return staged

    def _grow_for_burst(self, active: list, last_pos_of=None) -> list:
        """Allocate pages so every slot in ``active`` covers this launch's
        writes, plus the copy-on-write sweep: a shared page in the write
        window is copied private BEFORE dispatch, so shared prefix pages
        stay read-only whoever decodes past them. Preempts youngest-first
        when the pool runs dry (a lone slot always fits: add_request
        rejected anything that can't; idle prefix-index pages are
        reclaimed before anyone is preempted). ``last_pos_of`` overrides a
        slot's write-window end (a verify writes pos + proposals rows, not
        a whole burst). Returns the surviving active list (possibly
        empty)."""
        while True:
            grown = True
            for b in list(active):
                if last_pos_of is None:
                    last_pos = min(int(self._pos[b]) + self.burst - 1,
                                   int(self._limit[b]))
                else:
                    last_pos = int(last_pos_of(b))
                deficit = pages_for(last_pos + 1, self._ps) \
                    - len(self._page_tbl[b])
                got = self._palloc(deficit) if deficit > 0 else []
                if got is not None:
                    self._page_tbl[b].extend(got)
                    if self._cow_for_burst(b, last_pos):
                        continue
                victim = max(active, key=lambda s: self._admit_seq[s])
                self._preempt(victim)
                active.remove(victim)
                grown = False
                break
            if grown or not active:
                return active

    # ---------------------------------------------------- gather ("paged")
    def _dispatch_burst_paged(self):
        """Grow block tables to cover this burst's writes, then dispatch the
        gather burst over the page bucket of the widest live slot. Returns
        (old_pos, device results) or None when nothing is active; no host
        sync here."""
        from ..models.llama_paged import llama_paged_decode_burst
        active = [b for b, r in enumerate(self._slot_req) if r is not None]
        if not active:
            return None
        active = self._grow_for_burst(active)
        if not active:
            return None
        width = max(len(self._page_tbl[b]) for b in active)
        P = next(p for p in self._page_buckets if p >= width)
        if P not in self.stats["page_buckets_used"]:
            self.stats["page_buckets_used"] = sorted(
                self.stats["page_buckets_used"] + [P])
        old_pos = self._pos.copy()
        (self._cache, pos_d, tok_d, done_d, emitted_d) = \
            llama_paged_decode_burst(
                self._params, self._cache, self._table(active, P),
                self._dev_of(self._pos), self._dev_of(self._tok),
                self._dev_of(self._done), self._dev_of(self._limit),
                self.eos_id, self._gen, config=self._cfg, n=self.burst,
                temperature=self._temp, top_k=self._top_k,
                pad_id=self.pad_id, dequant=self._dequant,
                kv_dtype=self._kv_dtype)
        self.stats["bursts"] += 1
        self.stats["decode_steps"] += self.burst
        return old_pos, pos_d, tok_d, done_d, emitted_d

    def _admit_paged(self):
        """Pop + bucket + allocate + dispatch prefills: host work that
        overlaps the burst in flight. Admission is gated by free pages and
        a free slot. A prefix-index hit maps the shared pages and prefills
        only the suffix (``llama_paged_prefill_suffix``, its prefix table
        padded to a page bucket); a full-prefix hit dispatches nothing and
        resumes decode at the last prompt token. Returns (staged: [(req,
        slot, tlen, first token on the device)], installed: the resumes'
        slot state)."""
        from ..models.llama_paged import (llama_paged_prefill_slot,
                                          llama_paged_prefill_suffix)
        staged, installed = [], []
        stalled = False
        while self._queue and None in self._slot_req:
            req = self._queue[0]
            tlen = len(req.prompt)
            shared, matched = self._prefix_match(req)
            resume = bool(shared) and matched >= tlen
            tb = 0 if resume else self._bucket_len(tlen - matched)
            need = pages_for(tb, self._ps)
            if not self._reclaim_to(need):
                if shared:
                    self._alloc.free(shared)
                stalled = True   # stays queued; pages free as slots retire
                break
            self._queue.popleft()
            if shared:
                self._prefix_hit_account(shared, matched)
            slot = self._slot_req.index(None)
            if resume:
                installed.append(self._admit_resume(req, slot, shared))
                continue
            pages = self._alloc.alloc(need)
            suffix = tlen - matched
            toks = np.full(tb, self.pad_id, np.int32)
            toks[:suffix] = req.prompt[matched:]
            kw = dict(config=self._cfg, temperature=self._temp,
                      top_k=self._top_k, generator=self._gen,
                      dequant=self._dequant, kv_dtype=self._kv_dtype)
            if shared:
                pp = matched // self._ps
                ptbl = np.full(next(p for p in self._page_buckets if p >= pp),
                               SCRATCH_PAGE, np.int32)
                ptbl[:pp] = shared
                first, self._cache = llama_paged_prefill_suffix(
                    self._params, self._cache, self._dev_of(toks),
                    self._dev_of(np.asarray(pages, np.int32)),
                    self._dev_of(ptbl), matched, suffix, **kw)
                self._count("prefix_marginal_pages",
                            pages_for(suffix, self._ps))
            else:
                first, self._cache = llama_paged_prefill_slot(
                    self._params, self._cache, self._dev_of(toks),
                    self._dev_of(np.asarray(pages, np.int32)), tlen, **kw)
            # pages past the real prompt hold only bucket-pad rows the
            # mask never exposes: free them now (a later owner's writes
            # queue behind this prefill on the pool's stream); growth
            # allocates the decode page when it is needed
            keep = pages_for(suffix, self._ps)
            self._alloc.free(pages[keep:])
            self._page_tbl[slot] = shared + pages[:keep]
            self._slot_req[slot] = req   # reserved; state lands at the sync
            self._admit_seq[slot] = self._seq = self._seq + 1
            self.stats["prefills"] += 1
            staged.append((req, slot, tlen, first))
        if stalled:
            self.stats["admission_stalls"] += 1
        self.stats["prefill_bursts"] += bool(staged)
        return staged, installed

    def _sync_merge_paged(self, inflight, staged, installed) -> int:
        """The one blocking point of a gather step: ONE readback of the
        burst (slot state, emissions) and every staged first token, then
        host bookkeeping. Slots admitted this step sat free during the
        burst, so its readback is stale for them: the drain skips them,
        the resumes' admitted state is re-applied and the prefilled slots
        start decoding from their first token."""
        if inflight is None and not staged and not installed:
            return 0
        firsts = [f for *_, f in staged]
        vals = _read_back(*(inflight[1:] if inflight else ()),
                          *([torch.stack(firsts)] if firsts else ()))
        emitted_total = 0
        if inflight:
            pos, tok, done, emitted = vals[:4]
            self._pos, self._tok, self._done = pos, tok, done.astype(bool)
            emitted_total += self._drain_burst(
                inflight[0], self._done, emitted,
                skip={s for _, s, *_ in staged + installed})
        for req, slot, pos0, tok0, limit0 in installed:
            # a resume emits its first token in the next burst
            self._pos[slot] = pos0
            self._tok[slot] = tok0
            self._done[slot] = False
            self._limit[slot] = limit0
        for (req, slot, tlen, _), first in zip(staged, vals[-1] if firsts
                                               else ()):
            first = int(first)
            req.out.append(first)
            emitted_total += 1
            # the first token is back, so the prompt pages' content
            # landed: index them (before any retire)
            self._prefix_insert(req, slot)
            if req.max_new_tokens <= 1 or first == self.eos_id:
                self._finish(req)
                self._retire_slot(slot)
                continue
            self._pos[slot] = tlen
            self._tok[slot] = first
            self._done[slot] = False
            self._limit[slot] = min(tlen + req.max_new_tokens - 1,
                                    self.S - 1)
        self.stats["max_concurrent"] = max(self.stats["max_concurrent"],
                                           self.active)
        return emitted_total

    # ---------------------------------------------------------- "dense"
    def _admit_dense(self) -> int:
        """Prefill every admissible request into a free slot
        (``llama_prefill_slot``: kernel K1 in every layer), then ONE
        readback of their first tokens. Returns the tokens emitted."""
        from ..models.llama_decode import llama_prefill_slot
        staged = []
        while self._queue and None in self._slot_req:
            req = self._queue.popleft()
            slot = self._slot_req.index(None)
            tlen = len(req.prompt)
            toks = np.full(self._bucket_len(tlen), self.pad_id, np.int32)
            toks[:tlen] = req.prompt
            first, self._cache = llama_prefill_slot(
                self._params, self._cache, self._dev_of(toks), slot, tlen,
                config=self._cfg, temperature=self._temp, top_k=self._top_k,
                generator=self._gen, dequant=self._dequant)
            self.stats["prefills"] += 1
            self._slot_req[slot] = req
            staged.append((req, slot, tlen, first))
        if not staged:
            return 0
        self.stats["prefill_bursts"] += 1
        firsts, = _read_back(torch.stack([f for *_, f in staged]))
        for (req, slot, tlen, _), first in zip(staged, firsts):
            first = int(first)
            req.out.append(first)
            if req.max_new_tokens <= 1 or first == self.eos_id:
                self._finish(req)
                self._slot_req[slot] = None
                continue
            self._pos[slot] = tlen
            self._tok[slot] = first
            self._done[slot] = False
            self._limit[slot] = min(tlen + req.max_new_tokens - 1,
                                    self.S - 1)
        return len(staged)

    def _step_dense(self) -> int:
        """Admit synchronously, then one burst over the dense slot cache
        and its one readback (the JAX engine's order for this layout)."""
        from ..models.llama_decode import llama_decode_burst
        emitted_total = self._admit_dense()
        if self.active == 0:
            return emitted_total
        self.stats["max_concurrent"] = max(self.stats["max_concurrent"],
                                           self.active)
        old_pos = self._pos.copy()
        (self._cache, pos_d, tok_d, done_d, emitted_d) = llama_decode_burst(
            self._params, self._cache, self._dev_of(self._pos),
            self._dev_of(self._tok), self._dev_of(self._done),
            self._dev_of(self._limit), self.eos_id, config=self._cfg,
            n=self.burst, temperature=self._temp, top_k=self._top_k,
            pad_id=self.pad_id, generator=self._gen, dequant=self._dequant)
        self.stats["bursts"] += 1
        self.stats["decode_steps"] += self.burst
        pos, tok, done, emitted = _read_back(pos_d, tok_d, done_d, emitted_d)
        self._pos, self._tok, self._done = pos, tok, done.astype(bool)
        return emitted_total + self._drain_burst(old_pos, self._done,
                                                 emitted)

    # ----------------------------------------------------------- ragged
    def _dispatch_ragged(self, staged):
        """ONE launch covering this burst's admissions (ragged prefill) and
        every decoding slot. Returns (old_pos, device results) or None
        when nothing is active."""
        from ..models.llama_paged import llama_ragged_burst
        active = [b for b, r in enumerate(self._slot_req) if r is not None]
        if not active:
            return None
        active = self._grow_for_burst(active)
        # growth may have preempted a just-staged slot back to the queue
        staged[:] = [s for s in staged if self._slot_req[s[1]] is s[0]]
        if not active:
            return None
        t_max = self._buckets[-1]                # the ONE static width
        new_tokens = np.full((self.B, t_max), self.pad_id, np.int32)
        new_lens = np.zeros(self.B, np.int32)
        starts = np.zeros(self.B, np.int32)
        for req, slot, sl, start in staged:
            new_tokens[slot, :sl] = req.prompt[start:]
            new_lens[slot] = sl
            starts[slot] = start

        dev = self._dev_of
        old_pos = self._pos.copy()
        (self._cache, pos_d, tok_d, done_d, emitted_d, firsts_d) = \
            llama_ragged_burst(
                self._params, self._cache,
                self._table(active, pages_for(self.S, self._ps)),
                dev(self._pos), dev(self._tok), dev(self._done),
                dev(self._limit), dev(new_tokens), dev(new_lens),
                dev(starts), self.eos_id, self._gen, config=self._cfg,
                n=self.burst, has_prefill=bool(staged),
                temperature=self._temp, top_k=self._top_k,
                pad_id=self.pad_id, kv_dtype=self._kv_dtype,
                dequant=self._dequant)
        self.stats["bursts"] += 1
        self.stats["decode_steps"] += self.burst
        self.stats["prefill_bursts"] += bool(staged)
        return old_pos, pos_d, tok_d, done_d, emitted_d, firsts_d

    def _drain_burst(self, old_pos, done, emitted, skip=frozenset()) -> int:
        """Extend each live slot's output by its ``pos - old_pos`` burst
        emissions and finish+retire the slots the device marked done.
        ``skip`` holds slots whose readback is stale (admitted while the
        gather burst was in flight). Returns the token count drained."""
        total = 0
        for slot, req in enumerate(self._slot_req):
            if req is None or slot in skip:
                continue
            n_new = int(self._pos[slot] - old_pos[slot])
            req.out.extend(int(t) for t in emitted[:n_new, slot])
            total += n_new
            if done[slot]:
                self._finish(req)
                self._retire_slot(slot)
        return total

    def _sync_merge_ragged(self, inflight, staged) -> int:
        """The one blocking point of a step: ONE device-to-host readback of
        the merged burst (slot state, emissions, prefill first tokens),
        then pure host bookkeeping."""
        if inflight is None:
            return 0
        old_pos = inflight[0]
        pos, tok, done, emitted, firsts = _read_back(*inflight[1:])
        self._pos, self._tok = pos, tok
        done = done.astype(bool)
        self._done = done.copy()
        emitted_total = 0
        for req, slot, *_ in staged:
            # the prefill token, sampled inside the same burst; the drain
            # below appends this slot's decode emissions after it
            req.out.append(int(firsts[slot]))
            emitted_total += 1
            # the burst is read back: the prompt pages' content landed in
            # the pool, so NOW they are indexable
            self._prefix_insert(req, slot)
        emitted_total += self._drain_burst(old_pos, done, emitted)
        self.stats["max_concurrent"] = max(
            self.stats["max_concurrent"],
            sum(r is not None for r in self._slot_req))
        return emitted_total

    # ------------------------------------------------------- speculative
    def _spec_applicable(self) -> bool:
        """Speculative steps run when there is decode work and no
        admission this engine could do instead: an empty queue, or a full
        slot table (the plain path resumes the moment a slot frees AND the
        queue has work, so admissions never starve behind speculation)."""
        if self._spec is None or self.active == 0:
            return False
        return not self._queue or None not in self._slot_req

    def _step_spec(self) -> int:
        """One speculative iteration: the draft proposes up to k tokens
        per live slot, ONE target launch per layer verifies every slot's
        segment (``llama_paged_verify``), and the accept-prefix walk emits
        1..k+1 tokens per slot. Returns the tokens emitted."""
        from ..models.llama_paged import llama_paged_verify
        spec = self._spec
        # (prompt, out) ride as a PAIR: propose() slices the few tokens it
        # needs, never the concatenated sequence
        jobs = [(b, int(self._pos[b]), int(self._limit[b]),
                 (r.prompt, r.out))
                for b, r in enumerate(self._slot_req) if r is not None]
        props = spec.propose(jobs)
        # grow + COW over the verify window [pos, pos + n_props]: any page
        # another block table or the prefix index maps is privatized
        # BEFORE the speculative writes, so a later rewind frees only
        # private pages
        active = self._grow_for_burst(
            [b for b, *_ in jobs],
            last_pos_of=lambda b: int(self._pos[b]) + len(props[b]))
        if not active:
            return 0          # everything preempted; the queue serves next

        Tv = spec.k + 1
        tokens = np.full((self.B, Tv), self.pad_id, np.int32)
        n_tok = np.zeros(self.B, np.int32)
        start = np.zeros(self.B, np.int32)
        for b in active:
            row = [int(self._tok[b])] + props[b]
            tokens[b, :len(row)] = row
            n_tok[b] = len(row)
            start[b] = self._pos[b]
        if self._ragged:
            P = pages_for(self.S, self._ps)      # full width, always
        else:
            P = next(p for p in self._page_buckets
                     if p >= max(len(self._page_tbl[b]) for b in active))
        dev = self._dev_of
        targets_d, self._cache = llama_paged_verify(
            self._params, self._cache, self._table(active, P), dev(start),
            dev(tokens), dev(n_tok), config=self._cfg, ragged=self._ragged,
            kv_dtype=self._kv_dtype, dequant=self._dequant)
        targets, = _read_back(targets_d)
        self.stats["bursts"] += 1
        self._count("spec_steps")
        self._count("spec_slot_launches", len(active))

        emitted_total = proposed = accepted = 0
        for b in active:
            req = self._slot_req[b]
            pos0 = int(self._pos[b])
            out_toks, acc, done = accept_prefix(
                props[b], targets[b, :int(n_tok[b])], pos=pos0,
                limit=int(self._limit[b]), eos_id=self.eos_id)
            req.out.extend(out_toks)
            emitted_total += len(out_toks)
            proposed += len(props[b])
            accepted += acc
            self._pos[b] = pos0 + len(out_toks)
            self._tok[b] = out_toks[-1]
            self._done[b] = done
            if done:
                self._finish(req)
                self._retire_slot(b)
                continue
            spec.commit(b, acc)
            # rewind the rejected tail's writes: pages past the accepted
            # position hold only stale speculative rows; free them (the
            # sweep above privatized anything shared, so a freed page can
            # only be this slot's own)
            keep = pages_for(int(self._pos[b]), self._ps)
            tbl = self._page_tbl[b]
            if len(tbl) > keep:
                self._alloc.free(tbl[keep:])
                del tbl[keep:]
        self._count("spec_proposed", proposed)
        self._count("spec_accepted", accepted)
        self._count("spec_emitted", emitted_total)
        self.stats["max_concurrent"] = max(self.stats["max_concurrent"],
                                           self.active)
        return emitted_total

    def step(self) -> int:
        """One scheduling iteration; returns the tokens it emitted. A
        speculative step when ``_spec_applicable``; otherwise, ragged:
        admit, launch one mixed burst, block once on its readback; paged
        (overlapped): dispatch the burst, admit and dispatch prefills while
        it runs, block once on the combined readback; dense: admit, then
        burst."""
        if self._spec_applicable():
            return self._step_spec()
        if self._ragged:
            staged = self._admit_ragged()
            inflight = self._dispatch_ragged(staged)
            return self._sync_merge_ragged(inflight, staged)
        if self._layout == "paged":
            inflight = self._dispatch_burst_paged()
            staged, installed = self._admit_paged()
            return self._sync_merge_paged(inflight, staged, installed)
        return self._step_dense()

    # ------------------------------------------------------------ status
    def take_finished(self) -> dict[int, ServedRequest]:
        """Drain the finished-request table (rid -> ServedRequest)."""
        out, self._finished = self._finished, {}
        return out

    @property
    def active(self) -> int:
        """Slots holding a request (admitted, not yet retired)."""
        return sum(r is not None for r in self._slot_req)

    @property
    def pending(self) -> int:
        return len(self._queue) + self.active

    @property
    def pages_in_use(self) -> int:
        return self._alloc.pages_in_use if self._layout == "paged" else 0

    @property
    def page_size(self) -> int:
        if self._layout != "paged":
            raise ValueError("dense layout has no pages")
        return self._ps

    def run(self) -> dict:
        """Drain the queue; returns {rid: [generated token ids]}."""
        while self.pending:
            self.step()
        return {rid: req.out for rid, req in self.take_finished().items()}

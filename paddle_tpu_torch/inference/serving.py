"""Continuous-batching LLM serving — the port of the ragged path of
``paddle_tpu/inference/serving.py``.

ONE burst function whose batch dimension is a pool of slots with
independent positions, so requests of different prompt lengths and
generation budgets share every decode step (iteration-level scheduling):

  * admit — a queued request takes a free slot and pages for its actual
    prompt length; its prompt rides into the next burst as a (token row,
    length) pair and prefills inside the burst (``llama_ragged_burst``),
    so its first token lands that same burst;
  * decode — the burst runs ``burst`` single-token steps over all active
    slots; a slot retires on EOS or its length budget and emits padding
    until the host swaps a new request in between bursts.

The KV cache is the paged pool of ``models/llama_paged.py``, read through
the ragged kernel: the block table rides full width (the kernel reads only
live pages), so there is neither a page bucket nor a prompt bucket. Pages
are allocated on admit and per burst, freed on retire; when the pool runs
dry mid-flight the youngest slot is preempted back to the queue front (at
temperature 0 its tokens regenerate exactly).

The host scheduler is plain Python between device calls and keeps slot
state in numpy. Each step uploads the slot state, launches the burst and
blocks exactly once, on one device-to-host readback of the merged result.

Quantized pages: ``kv_dtype="int8"`` or ``"fp8"`` stores the pool through
the port's block codecs (``quant/codec.py``: payload plus one f32 scale per
(row, kv head)) and every attention read dequantizes through kernel K4.
``pool_hbm_bytes`` sizes the pool by a byte budget instead of a page
count: the same budget buys ~1.94× the pages in int8 or fp8 at head_dim
128, scales included.

Only ``kv_layout="ragged"`` is ported. The other layouts, serving
precisions, prefix sharing, speculative decoding and admission policies
raise; the ``PADDLE_SERVE_KV_DTYPE`` environment knob (which the JAX
engine reads when ``kv_dtype`` is None) waits for the port of
``utils/env_flags.py``, so here ``kv_dtype=None`` always means pages in
the model dtype; metrics, chaos, SLO and admin hooks wait for later
slices.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..quant.codec import normalize_kv_dtype
from .paging import PageAllocator, SCRATCH_PAGE, pages_for, pages_for_budget

__all__ = ["ContinuousBatcher", "ServedRequest"]


@dataclasses.dataclass
class ServedRequest:
    rid: int
    prompt: list
    max_new_tokens: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    reason: str = "complete"   # how it retired


class ContinuousBatcher:
    """Slot-pool serving engine over the ragged paged burst.

    engine = ContinuousBatcher(cfg, params, max_batch=8, max_len=1024)
    rid = engine.add_request([1, 2, 3], max_new_tokens=64)
    results = engine.run()          # {rid: [generated token ids]}
    """

    def __init__(self, model_config, params, max_batch: int = 4,
                 max_len: int = 512,
                 prompt_buckets: Sequence[int] = (32, 64, 128, 256),
                 burst: int = 8, eos_id: int | None = None, pad_id: int = 0,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 precision: str | None = None, kv_layout: str = "ragged",
                 page_size: int = 16, num_pages: int | None = None,
                 kv_dtype: str | None = None,
                 pool_hbm_bytes: int | None = None,
                 prefix_cache_pages: int | None = None,
                 spec_decode: bool | None = None, admission=None,
                 device="cuda"):
        if kv_layout in ("paged", "dense"):
            raise NotImplementedError(
                f"kv_layout={kv_layout!r} is not ported yet; the port "
                "serves kv_layout='ragged'")
        if kv_layout != "ragged":
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        for name, val in (("precision", precision),
                          ("prefix_cache_pages", prefix_cache_pages),
                          ("spec_decode", spec_decode),
                          ("admission", admission)):
            if val:
                raise NotImplementedError(
                    f"{name}={val!r} is not ported yet")
        self._dev = resolve_device(device)
        if params["embed_tokens"].device != self._dev:
            raise ValueError(f"params live on "
                             f"{params['embed_tokens'].device}, the engine "
                             f"was asked to run on {self._dev}")
        self._cfg = model_config
        self._params = params
        # "int8" | "fp8" | None; every unquantized spelling is None, a
        # typo raises
        self._kv_dtype = normalize_kv_dtype(kv_dtype)
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
                page_bytes(model_config, self._ps, self._kv_dtype))
        elif num_pages is None:
            # capacity for every slot at max_len, plus the scratch page
            num_pages = self.B * slot_max_pages + 1
        self._alloc = PageAllocator(num_pages)
        self._cache = init_paged_kv_cache(model_config, num_pages, self._ps,
                                          kv_dtype=self._kv_dtype,
                                          device=self._dev)
        # per-slot block tables (host truth); _admit_seq orders slots by
        # admission for preemption
        self._page_tbl: list[list[int]] = [[] for _ in range(self.B)]
        self._admit_seq = [0] * self.B
        self._seq = 0

        self._queue: deque[ServedRequest] = deque()
        self._finished: dict[int, ServedRequest] = {}
        self._next_rid = 0
        self.stats = {"bursts": 0, "decode_steps": 0, "prefills": 0,
                      "prefill_bursts": 0, "admission_stalls": 0,
                      "preemptions": 0, "max_concurrent": 0}

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
        worst = pages_for(len(prompt) + max_new_tokens, self._ps)
        if worst > self._alloc.usable:
            raise ValueError(
                f"request needs {worst} pages but the pool only has "
                f"{self._alloc.usable} usable — it could never be admitted")
        return prompt, max_new_tokens

    # ----------------------------------------------------------- retire
    def _finish(self, req: ServedRequest) -> None:
        req.done = True
        self._finished[req.rid] = req

    def _retire_slot(self, slot: int) -> None:
        """Free a slot and its pages. Zeroing its host state points its
        frozen writes at row 0 of the scratch page."""
        self._slot_req[slot] = None
        self._pos[slot] = 0
        self._tok[slot] = self.pad_id
        self._done[slot] = True
        self._limit[slot] = 0
        self._alloc.free(self._page_tbl[slot])
        self._page_tbl[slot] = []

    def _preempt(self, slot: int) -> None:
        """Pool ran dry mid-flight: push this slot's request back to the
        FRONT of the queue and restart it later from scratch (at
        temperature 0 the regenerated tokens are identical)."""
        req = self._slot_req[slot]
        req.out = []
        self._queue.appendleft(req)
        self._retire_slot(slot)
        self.stats["preemptions"] += 1

    # ------------------------------------------------------------- admit
    def _admit_ragged(self):
        """Pop + allocate + stage admissions for the next burst: pages for
        the ACTUAL prompt length; the prompt prefills inside the burst.
        Returns [(req, slot, prompt_len, prefill_start)]."""
        staged = []
        stalled = False
        while self._queue and None in self._slot_req:
            req = self._queue[0]
            tlen = len(req.prompt)
            pages = self._alloc.alloc(pages_for(tlen, self._ps))
            if pages is None:
                stalled = True   # stays queued; pages free as slots retire
                break
            self._queue.popleft()
            slot = self._slot_req.index(None)
            self._page_tbl[slot] = pages
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
            staged.append((req, slot, tlen, 0))
        if stalled:
            self.stats["admission_stalls"] += 1
        return staged

    def _grow_for_burst(self, active: list) -> list:
        """Allocate pages so every slot in ``active`` covers this burst's
        writes, preempting youngest-first when the pool runs dry (a lone
        slot always fits: add_request rejected anything that can't).
        Returns the surviving active list (possibly empty)."""
        while True:
            grown = True
            for b in list(active):
                last_pos = min(int(self._pos[b]) + self.burst - 1,
                               int(self._limit[b]))
                deficit = pages_for(last_pos + 1, self._ps) \
                    - len(self._page_tbl[b])
                got = self._alloc.alloc(deficit) if deficit > 0 else []
                if got is not None:
                    self._page_tbl[b].extend(got)
                    continue
                victim = max(active, key=lambda s: self._admit_seq[s])
                self._preempt(victim)
                active.remove(victim)
                grown = False
                break
            if grown or not active:
                return active

    # ------------------------------------------------------------ burst
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
        P = pages_for(self.S, self._ps)          # full width, always
        bt = np.full((self.B, P), SCRATCH_PAGE, np.int32)
        for b in active:
            ids = self._page_tbl[b]
            bt[b, :len(ids)] = ids
        t_max = self._buckets[-1]                # the ONE static width
        new_tokens = np.full((self.B, t_max), self.pad_id, np.int32)
        new_lens = np.zeros(self.B, np.int32)
        starts = np.zeros(self.B, np.int32)
        for req, slot, sl, start in staged:
            new_tokens[slot, :sl] = req.prompt[start:]
            new_lens[slot] = sl
            starts[slot] = start

        def dev(a):
            return torch.from_numpy(a).to(self._dev)

        old_pos = self._pos.copy()
        (self._cache, pos_d, tok_d, done_d, emitted_d, firsts_d) = \
            llama_ragged_burst(
                self._params, self._cache, dev(bt), dev(self._pos),
                dev(self._tok), dev(self._done), dev(self._limit),
                dev(new_tokens), dev(new_lens), dev(starts), self.eos_id,
                self._gen, config=self._cfg, n=self.burst,
                has_prefill=bool(staged), temperature=self._temp,
                top_k=self._top_k, pad_id=self.pad_id,
                kv_dtype=self._kv_dtype)
        self.stats["bursts"] += 1
        self.stats["decode_steps"] += self.burst
        self.stats["prefill_bursts"] += bool(staged)
        return old_pos, pos_d, tok_d, done_d, emitted_d, firsts_d

    def _drain_burst(self, old_pos, done, emitted) -> int:
        """Extend each live slot's output by its ``pos - old_pos`` burst
        emissions and finish+retire the slots the device marked done.
        Returns the token count drained."""
        total = 0
        for slot, req in enumerate(self._slot_req):
            if req is None:
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
        pos, tok, done, emitted, firsts = inflight[1:]
        B = self.B
        flat = torch.cat([pos.to(torch.int32), tok.to(torch.int32),
                          done.to(torch.int32), firsts.to(torch.int32),
                          emitted.to(torch.int32).reshape(-1)]).cpu().numpy()
        self._pos = flat[:B].copy()
        self._tok = flat[B:2 * B].copy()
        done = flat[2 * B:3 * B].astype(bool)
        self._done = done.copy()
        firsts = flat[3 * B:4 * B]
        emitted = flat[4 * B:].reshape(-1, B)
        emitted_total = 0
        for req, slot, *_ in staged:
            # the prefill token, sampled inside the same burst; the drain
            # below appends this slot's decode emissions after it
            req.out.append(int(firsts[slot]))
            emitted_total += 1
        emitted_total += self._drain_burst(old_pos, done, emitted)
        self.stats["max_concurrent"] = max(
            self.stats["max_concurrent"],
            sum(r is not None for r in self._slot_req))
        return emitted_total

    def step(self) -> int:
        """One scheduling iteration: admit, launch one mixed burst, block
        once on its readback. Returns the tokens it emitted."""
        staged = self._admit_ragged()
        inflight = self._dispatch_ragged(staged)
        return self._sync_merge_ragged(inflight, staged)

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
        return self._alloc.pages_in_use

    def run(self) -> dict:
        """Drain the queue; returns {rid: [generated token ids]}."""
        while self.pending:
            self.step()
        return {rid: req.out for rid, req in self.take_finished().items()}

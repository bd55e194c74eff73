"""Speculative decoding on the paged serving engine — the port of
``paddle_tpu/inference/speculative.py``.

A DRAFT model proposes up to ``k`` greedy tokens per live slot, then the
target verifies all of them in ONE launch per layer
(``models.llama_paged.llama_paged_verify``: each slot's row carries
[current token, d_1..d_k] as a q_len = k+1 segment at the slot's position
and returns per-position greedy targets). Accept-prefix semantics keep
temperature-0 token identity with plain decode unconditionally:

  * accept the longest prefix where draft and target argmax agree — those
    tokens ARE what plain decode would have emitted;
  * the first disagreement emits the TARGET's token (the correction) and
    discards the rejected tail;
  * a full agreement also emits the target's bonus token.

So the draft's quality moves THROUGHPUT (accepted tokens per launch),
never OUTPUT. Rejected tokens cost nothing durable: their target-pool
writes are stale rows behind the masks and their trailing pages are freed
(pages a prefix cache shares were copied private by the growth sweep
BEFORE any speculative write).

The draft is the target truncated to its leading ``draft_layers`` layers
(embeddings, final norm and head kept; the layer tensors are views of the
target's, no copy), with its own DENSE slot cache
(``llama_decode.init_kv_cache``, one extra row as an overflow scratch):
rewind is a host-side integer, since the cache is valid through a per-slot
watermark and stale rows beyond it are masked. A slot the plain path
advanced catches up by FORCING known sequence tokens through the same
propose launch, proposing fewer tokens that round.

Differences from the JAX module:

* ``spec_from_env`` reads no environment: its arguments alone decide, and
  ``spec_decode=None`` means off until ``utils/env_flags.py`` is ported
  (ROADMAP Queue 1 item 5). Its gates are JAX's (temperature > 0, k < 1,
  a layout without pages); it returns the reason beside the missing
  draft, and the engine records it in ``stats["spec_disabled"]`` (the
  flight recorder waits for item 5).
* A draft that fails to build RAISES. The JAX engine catches every
  exception there and serves without a draft; on the port that would
  hide a device or kernel fault.
* ``precision="int8"`` (the weight-only int8 draft,
  ``quantization.weight_only_quantize`` of the truncated draft) is an
  argument of ``SpeculativeDecoder`` and ``spec_from_env`` only: the
  engine reads no ``PADDLE_SPEC_DRAFT_PRECISION``.
* No spans or metrics (item 5); ``stats["draft_s"]`` keeps the host
  seconds of the propose calls, which end in a readback.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

__all__ = ["SpeculativeDecoder", "accept_prefix", "draft_from_target",
           "draft_spec_burst", "spec_from_env", "DEFAULT_K"]

# the JAX package's default for PADDLE_SPEC_K
DEFAULT_K = 4


def _seq_slice(parts, a: int, b: int) -> list:
    """``seq[a:b]`` of a slot's full token sequence, where ``parts`` is
    the (prompt, emitted) PAIR, without building their concatenation (the
    hot path reads at most k+2 tokens per warm slot per launch)."""
    prompt, out = parts
    n = len(prompt)
    if b <= n:
        return list(prompt[a:b])
    if a >= n:
        return list(out[a - n:b - n])
    return list(prompt[a:]) + list(out[:b - n])


def accept_prefix(proposals, targets, *, pos: int, limit: int,
                  eos_id: int):
    """The pure accept-prefix walk → (emitted tokens, accepted count,
    done).

    ``targets`` has ``len(proposals) + 1`` entries: targets[j] is the
    target's greedy token after consuming [current, d_1..d_j], the token
    at absolute position ``pos + j + 1``. The walk emits targets[j] as
    long as the previous positions agreed, stopping at the first
    disagreement (targets[j] IS the correction), at the bonus position, or
    wherever plain decode would freeze (eos, or the position reaching
    ``limit``: the decode loop's ``new_pos >= limit``). The emitted list
    is exactly the next tokens a plain greedy serve would produce,
    1 <= len <= k+1."""
    emitted: list[int] = []
    accepted = 0
    n_prop = len(proposals)
    for j, t in enumerate(targets):
        t = int(t)
        emitted.append(t)
        new_pos = pos + j + 1
        if t == eos_id or new_pos >= limit:
            return emitted, accepted, True
        if j < n_prop and t == int(proposals[j]):
            accepted += 1
            continue
        break
    return emitted, accepted, False


def draft_from_target(params, config, n_layers: int):
    """(draft_params, draft_config): the target truncated to its first
    ``n_layers`` decoder layers — each stacked per-layer tensor sliced
    ``[:n]`` (a view, no copy), embeddings, final norm and lm head kept.
    ``n_layers`` equal to the target's depth returns the params UNSLICED
    (the self-draft: it proposes exactly the target's greedy continuation,
    the deterministic full-accept fixture)."""
    from ..models.llama import split_layer_params

    L = int(config.num_hidden_layers)
    n = max(1, min(int(n_layers), L))
    dcfg = dataclasses.replace(config, num_hidden_layers=n)
    if n == L:
        return params, dcfg
    layer, other = split_layer_params(params)
    draft = dict(other)
    draft.update({name: v[:n] for name, v in layer.items()})
    return draft, dcfg


def draft_spec_burst(params, cache, pos, inputs, n_forced, config, n: int,
                     dequant=None):
    """n greedy draft steps over all slots (one propose call).

    pos [B]: the draft-cache row step 0 writes at (the slot's valid
    watermark). inputs [B, n] / n_forced [B]: step j feeds inputs[:, j]
    while j < n_forced (known sequence tokens: catch-up and the current
    token) and its OWN previous sample after (speculation). Each step is
    ``llama_decode_step_slots`` on the dense draft cache; write rows clamp
    to the cache's last row (the overflow scratch row: a slot at its
    budget keeps proposing junk the host caps away without clobbering a
    valid row). ``dequant``: a weight-only int8 draft's dequantizer.
    Returns (cache, samples [n, B]): samples[j] is the greedy token after
    step j, so a slot with n_forced = f proposes samples[f-1 : n-1]."""
    from ..models.llama_decode import llama_decode_step_slots

    last = cache["k"][0].shape[1] - 1
    cur = torch.zeros_like(pos, dtype=torch.int32)
    pos32 = pos.to(torch.int32)
    samples = []
    with torch.no_grad():
        for j in range(n):
            tok = torch.where(j < n_forced, inputs[:, j].to(torch.int32),
                              cur)
            wpos = torch.clamp(pos32 + j, max=last)
            logits, cache = llama_decode_step_slots(params, cache, wpos, tok,
                                                    config, dequant)
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
            samples.append(cur)
    return cache, torch.stack(samples)


class SpeculativeDecoder:
    """The draft half of speculative serving, owned by ONE batcher.
    ``propose()`` returns up to k greedy draft tokens per verifying slot;
    after the target's verify the batcher calls ``commit(slot, accepted)``
    for a live slot (the valid watermark advances over the current token
    and the accepted run); retiring or preempting a slot goes through
    ``invalidate``, after which its next use re-prefills."""

    def __init__(self, config, params, *, max_batch: int, max_len: int,
                 prompt_buckets, k: int, draft_layers: int | None = None,
                 precision: str | None = None, device="cuda"):
        from .._device import resolve_device
        from ..models.llama_decode import init_kv_cache

        self.k = int(k)
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        L = int(config.num_hidden_layers)
        n = int(draft_layers) if draft_layers else -(-L // 2)
        dparams, self._cfg = draft_from_target(params, config, n)
        self.draft_layers = self._cfg.num_hidden_layers
        self._dequant = None
        if precision in ("int8", "weight_only_int8"):
            from ..quantization import (weight_only_dequantize,
                                        weight_only_quantize)
            dparams = weight_only_quantize(dparams)
            self._dequant = weight_only_dequantize
        elif precision:
            raise ValueError(f"unknown draft precision {precision!r}")
        self._params = dparams
        self._dev = resolve_device(device)
        self.B, self.S = int(max_batch), int(max_len)
        # + 1 row: the overflow scratch row draft_spec_burst clamps
        # over-budget speculative writes into (never a valid row)
        self._S1 = self.S + 1
        self._buckets = tuple(sorted(prompt_buckets))
        self._cache = init_kv_cache(self._cfg, self.B, self._S1,
                                    device=self._dev)
        # valid[b]: rows [0, valid) of slot b's draft cache hold the K/V
        # of the slot's REAL sequence; pend[b]: where valid lands if the
        # in-flight proposals are accepted (set at propose)
        self._valid = np.zeros(self.B, np.int64)
        self._pend = np.zeros(self.B, np.int64)
        self.stats = {"draft_launches": 0, "draft_prefills": 0,
                      "draft_s": 0.0}

    def invalidate(self, slot: int) -> None:
        """Forget a slot's draft state (retire, preempt, re-admit): the
        next propose re-prefills it from the sequence the host holds."""
        self._valid[slot] = 0
        self._pend[slot] = 0

    def commit(self, slot: int, accepted: int) -> None:
        """The verify accepted ``accepted`` draft tokens for a STILL-LIVE
        slot: its cache is now valid through the current token plus the
        accepted run (the correction or bonus token was never drafted; the
        next propose feeds it as a forced input)."""
        self._valid[slot] = self._pend[slot] + int(accepted)

    def propose(self, jobs) -> dict:
        """jobs: [(slot, pos, limit, (prompt, emitted))] for every
        verifying slot (seq[pos] is the current token). Returns {slot:
        [proposed tokens]}, possibly empty for a slot whose draft is still
        catching up (its verify row degenerates to a plain decode step)
        or whose budget caps speculation."""
        t0 = time.perf_counter()
        props = self._propose(jobs)
        self.stats["draft_s"] += time.perf_counter() - t0
        return props

    def _propose(self, jobs) -> dict:
        from ..models.llama_decode import llama_prefill_slot

        # 1. cold slots prefill their known prefix (bucketed, at most the
        #    widest bucket; any remainder closes through forced catch-up)
        for slot, pos, _limit, parts in jobs:
            if self._valid[slot] == 0 and pos > 0:
                n0 = min(int(pos), self._buckets[-1])
                tb = next(b for b in self._buckets if b >= n0)
                toks = np.zeros(tb, np.int32)
                toks[:n0] = _seq_slice(parts, 0, n0)
                llama_prefill_slot(self._params, self._cache,
                                   torch.from_numpy(toks).to(self._dev),
                                   slot, n0, config=self._cfg,
                                   dequant=self._dequant)
                self._valid[slot] = n0
                self.stats["draft_prefills"] += 1

        # 2. ONE propose call: k+1 greedy steps; per slot the first
        #    n_forced steps feed known tokens (catch-up gap + the current
        #    token), the rest speculate
        Td = self.k + 1
        base = np.zeros(self.B, np.int32)
        inputs = np.zeros((self.B, Td), np.int32)
        n_forced = np.zeros(self.B, np.int32)
        for slot, pos, _limit, parts in jobs:
            v = int(self._valid[slot])
            nf = min(pos - v + 1, Td)
            inputs[slot, :nf] = _seq_slice(parts, v, v + nf)
            n_forced[slot] = nf
            base[slot] = v

        def dev(a):
            return torch.from_numpy(a).to(self._dev)

        self._cache, samples_d = draft_spec_burst(
            self._params, self._cache, dev(base), dev(inputs),
            dev(n_forced), config=self._cfg, n=Td, dequant=self._dequant)
        samples = samples_d.cpu().numpy()                  # [Td, B]
        self.stats["draft_launches"] += 1

        props: dict[int, list[int]] = {}
        for slot, pos, limit, _parts in jobs:
            nf = int(n_forced[slot])
            # plain decode from pos can emit at most limit - pos tokens,
            # and m proposals emit at most m + 1: never draft past what
            # the budget could accept
            cap = max(0, min(self.k, int(limit) - int(pos) - 1, Td - nf))
            props[slot] = [int(samples[nf - 1 + i, slot])
                           for i in range(cap)]
            self._pend[slot] = int(base[slot]) + nf
        return props

    def summary(self) -> dict:
        return {"k": self.k, "draft_layers": self.draft_layers,
                **{n: (round(v, 6) if isinstance(v, float) else v)
                   for n, v in self.stats.items()}}


def spec_from_env(config, params, *, max_batch: int, max_len: int,
                  prompt_buckets, temperature: float, paged: bool,
                  spec_decode: bool | None = None, k: int | None = None,
                  draft_layers: int | None = None,
                  precision: str | None = None, device="cuda"):
    """(SpeculativeDecoder or None, the reason it is None or None).

    Off (None, None) unless ``spec_decode`` is true: the environment knobs
    wait for the port of ``utils/env_flags.py``. The JAX package's gates
    turn speculation off with a reason: a layout without pages, a
    temperature above 0 (accept-prefix over argmax is only exact at 0), a
    k below 1. ``k`` None is 4 and ``draft_layers`` None (or 0) half the
    target's layers, the JAX package's defaults. A draft that fails to
    build raises."""
    if not spec_decode:
        return None, None
    if not paged:
        return None, "dense kv layout has no rewindable page unit"
    if temperature > 0.0:
        return None, ("temperature > 0: greedy accept-prefix is only exact "
                      "at temperature 0")
    kk = DEFAULT_K if k is None else int(k)
    if kk < 1:
        return None, f"spec k={kk} < 1"
    return SpeculativeDecoder(config, params, max_batch=max_batch,
                              max_len=max_len, prompt_buckets=prompt_buckets,
                              k=kk, draft_layers=draft_layers,
                              precision=precision, device=device), None

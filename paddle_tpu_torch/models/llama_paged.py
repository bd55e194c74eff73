"""Paged KV cache and the ragged burst — the port of the ragged half of
``paddle_tpu/models/llama_paged.py``.

The cache is a shared POOL of fixed-size pages per layer,
``[num_pages, page_size, KV, hd]``, with per-slot block tables
``[B, P]`` int32 mapping logical page j of slot b to a physical page.
Physical page 0 is the SCRATCH page (``inference.paging.SCRATCH_PAGE``):
idle slots and writes that no live request owns land there, and no live
row is ever read from it.

Every attention read goes through the ragged kernel
(``ops/ragged_attention.py``): decode rows and ragged prefill rows alike,
reading only each slot's live pages. Pool writes are indexed assignments
(``pool[page_ids, rows] = ...``) IN PLACE — the JAX package donated the
pool buffer to its jitted burst (``donate_argnums=(1,)``) so XLA could
update it in place; writing in place is the port's counterpart, and the
returned cache holds the same tensors it was given.

Quantized pages (``kv_dtype`` "int8" | "fp8"): the payload pools keep the
``[num_pages, page_size, KV, hd]`` layout in the codec's payload dtype and
a per-(row, kv head) f32 scale rides in parallel ``[num_pages, page_size,
KV]`` pools under ``"k_scale"`` / ``"v_scale"`` (``quant/codec.py``, the
block being the head_dim vector). Writes quantize the fresh rows and store
payload and scale at the same indexes; the ragged kernel dequantizes what
it reads (kernel K4). ``kv_dtype=None`` is the unquantized cache, with no
scale pools.

Prefix sharing and speculative decoding (the ragged read only):
``copy_pages`` is the copy-on-write primitive (payload and scale rows of
whole pages); a suffix prefill is ``_ragged_prefill_phase`` with
``prefill_start > 0``; ``llama_paged_verify`` writes each slot's
speculative segment row by row and reads it back through the ragged
kernel with ``q_len = n_tok``, ``kv_len = start + n_tok``.

MoE configs: every function here runs the FFN (``llama._mlp``) over all
rows of its launch — dead lanes, pad rows and ``q_len = 0`` slots
included — exactly as the JAX package does, since an expert's capacity
couples the rows routed together.

Waiting for later slices: the gather read path (and its quantized read,
the gather branch of ``llama_paged_verify``, ``llama_paged_prefill_suffix``),
page export/import and the sharded pool (ROADMAP Queue 1 items 4, 7, 8).
"""
from __future__ import annotations

import torch

from .._device import resolve_device
from ..inference.paging import SCRATCH_PAGE
from ..ops.ragged_attention import ragged_paged_attention
from ..quant.codec import (SCALE_DTYPE, quantize_lastdim,
                           scale_itemsize, wire_dtype, wire_itemsize)
from .llama import (LlamaConfig, _mlp, _qkv, _rmsnorm, _rope, layer_slice,
                    lm_head_logits, split_layer_params)
from .llama_decode import _sample

__all__ = ["init_paged_kv_cache", "page_bytes", "paged_kv_bytes_per_token",
           "llama_ragged_burst", "copy_pages", "llama_paged_verify"]


def init_paged_kv_cache(config: LlamaConfig, num_pages: int, page_size: int,
                        kv_dtype: str | None = None, device="cuda"):
    """Shared page pool: per-layer tuples of zeroed
    [num_pages, page_size, KV, hd] buffers. Page 0 is scratch — the usable
    pool is ``num_pages - 1`` pages.

    ``kv_dtype`` None: buffers in the model dtype, nothing else.
    "int8" / "fp8": payload buffers in the codec's payload dtype plus
    zeroed f32 scale pools [num_pages, page_size, KV] under "k_scale" and
    "v_scale"; one page id indexes payload and scale together."""
    c = config
    dev = resolve_device(device)
    shape = (int(num_pages), int(page_size), c.num_key_value_heads,
             c.head_dim)
    dt = c.dtype if kv_dtype is None else wire_dtype(kv_dtype)
    cache = {
        "k": tuple(torch.zeros(shape, dtype=dt, device=dev)
                   for _ in range(c.num_hidden_layers)),
        "v": tuple(torch.zeros(shape, dtype=dt, device=dev)
                   for _ in range(c.num_hidden_layers)),
    }
    if kv_dtype is not None:
        for name in ("k_scale", "v_scale"):
            cache[name] = tuple(
                torch.zeros(shape[:-1], dtype=SCALE_DTYPE, device=dev)
                for _ in range(c.num_hidden_layers))
    return cache


def copy_pages(cache, src_ids, dst_ids):
    """Copy whole pool pages ``src_ids[i] -> dst_ids[i]`` in place across
    every leaf (payload pools always, scale pools when quantized): the
    COPY-ON-WRITE primitive of prefix sharing. Before a burst writes into
    a page other block tables still map, the scheduler copies it into a
    freshly allocated private page and redirects only the writer. The
    copies are enqueued on the pools' device stream, so they land before
    any later launch on it reads or writes those pages. Returns the
    cache."""
    for bufs in cache.values():
        dev = bufs[0].device
        s = torch.as_tensor(list(src_ids), dtype=torch.long, device=dev)
        d = torch.as_tensor(list(dst_ids), dtype=torch.long, device=dev)
        for buf in bufs:
            buf[d] = buf[s]
    return cache


def _kv_row_head_bytes(config: LlamaConfig, kv_dtype: str | None) -> int:
    """Bytes one (row, kv head) K-or-V block occupies: head_dim payload
    elements plus, quantized, its f32 scale."""
    if kv_dtype is None:
        return int(config.head_dim) \
            * torch.empty((), dtype=config.dtype).element_size()
    return int(config.head_dim) * wire_itemsize(kv_dtype) + scale_itemsize()


def page_bytes(config: LlamaConfig, page_size: int,
               kv_dtype: str | None = None) -> int:
    """Device bytes one PAGE ID costs: K+V across all layers, scales
    included — the unit ``pool_hbm_bytes`` is spent in."""
    c = config
    return int(2 * c.num_hidden_layers * int(page_size)
               * c.num_key_value_heads * _kv_row_head_bytes(c, kv_dtype))


def paged_kv_bytes_per_token(config: LlamaConfig, pages: int, page_size: int,
                             live_tokens: int | None = None,
                             kv_dtype: str | None = None) -> int:
    """Decode-attention K+V bytes read per emitted token per slot. With
    ``live_tokens`` the read is the slot's live pages,
    ``ceil(live_tokens / page_size)`` — what the ragged kernel reads —
    and ``pages`` is ignored. Quantized pages bill their payload and
    scale bytes."""
    if live_tokens is not None:
        live_tokens = int(live_tokens)
        pages = 0 if live_tokens <= 0 \
            else (live_tokens - 1) // int(page_size) + 1
    return int(pages) * page_bytes(config, page_size, kv_dtype)


def _ragged_attn(q, kp, vp, block_table, q_lens, kv_lens, *, page_size,
                 ksc=None, vsc=None):
    """The ragged kernel over one layer's pool (K3, or K4 when the scale
    pools ``ksc``/``vsc`` are given) — the unsharded branch of the JAX
    package's ``_ragged_attn`` (the head-sharded pool waits for the
    distributed slice)."""
    return ragged_paged_attention(q, kp, vp, block_table, q_lens, kv_lens,
                                  page_size=page_size, k_scale=ksc,
                                  v_scale=vsc)


def _layer_pools(cache, l, quant):
    """Layer ``l``'s (k, v, k_scale, v_scale) pools; the scales are None
    for an unquantized cache."""
    if not quant:
        return cache["k"][l], cache["v"][l], None, None
    return (cache["k"][l], cache["v"][l], cache["k_scale"][l],
            cache["v_scale"][l])


def _ragged_decode_step_slots(params, cache, block_table, pos, tok,
                              config: LlamaConfig,
                              kv_dtype: str | None = None,
                              attn=_ragged_attn):
    """One single-token step over all slots: slot b writes its K/V row at
    ``pos[b]`` through its block table (in place; quantized first when
    ``kv_dtype`` is set, payload and scale at the same index), then the
    ragged kernel reads its ceil((pos+1)/page_size) live pages (q_len 1,
    kv_len pos+1). ``attn`` is the pool read (``_ragged_attn``'s
    signature); an oracle passes the plain version. Every slot's row,
    free slots' included, goes through the FFN (an MoE config routes all
    B rows together, as the JAX package does). Returns next-token logits
    [B, V] f32."""
    c = config
    layer_p, other = split_layer_params(params)
    B = tok.shape[0]
    ps = cache["k"][0].shape[1]
    x = other["embed_tokens"][tok.long()[:, None]].to(c.dtype)
    positions = pos[:, None].to(torch.int32)
    pos_l = pos.long()
    page = block_table.long().gather(1, (pos_l // ps)[:, None])[:, 0]
    row = pos_l % ps
    one = torch.ones_like(pos, dtype=torch.int32)
    kv_lens = (pos + 1).to(torch.int32)
    quant = kv_dtype is not None
    for l in range(c.num_hidden_layers):
        lp = layer_slice(layer_p, l)
        h = _rmsnorm(x, lp["ln1"], c.rms_norm_eps)
        q, k, v = _qkv(h, lp, c)
        q, k = _rope(q, k, positions, c.rope_theta, c.head_dim)
        kp, vp, ksp, vsp = _layer_pools(cache, l, quant)
        ku, vu = k[:, 0], v[:, 0]
        if quant:
            ku, ksu = quantize_lastdim(ku, kv_dtype)
            vu, vsu = quantize_lastdim(vu, kv_dtype)
            ksp[page, row] = ksu
            vsp[page, row] = vsu
        kp[page, row] = ku
        vp[page, row] = vu
        att = attn(q, kp, vp, block_table, one, kv_lens, page_size=ps,
                   ksc=ksp, vsc=vsp)
        y = x + (att.reshape(B, 1, -1) @ lp["wo"])
        x = _mlp(y, lp, c)
    return lm_head_logits(x[:, 0, :], other, c)


def _ragged_prefill_phase(params, cache, block_table, new_tokens, new_lens,
                          prefill_start, config: LlamaConfig,
                          kv_dtype: str | None = None, attn=_ragged_attn):
    """Ragged prompt forward for every newly admitted slot at once.

    new_tokens [B, Tmax] (the engine's one static width), new_lens [B]
    (0 = slot not prefilling: its lanes are dead compute), prefill_start
    [B] (the absolute position the slot's row starts at; 0 for an ordinary
    admission). Per layer the K/V rows land in the slot's pages from
    logical page ``prefill_start // page_size``; non-prefilling slots, and
    rows past the table's width, write to the scratch page so a decoding
    neighbour's context is never touched. With ``kv_dtype`` the padded
    rows quantize first (pad rows of zeros give zero payloads, as in the
    JAX package) and their scales land at the same indexes. The ragged
    kernel then reads them back causally (q_len = new_lens, kv_len =
    prefill_start + new_lens); ``attn`` as in
    ``_ragged_decode_step_slots``. All B·Tmax rows go through the FFN,
    the dead lanes of a short prompt and the zero rows of a slot that is
    not prefilling included: an MoE config routes them together with the
    live rows, which the JAX package does too, so capacity and drops
    come out the same. Returns (last-position logits [B, V], cache)."""
    c = config
    layer_p, other = split_layer_params(params)
    B, Tmax = new_tokens.shape
    ps = int(cache["k"][0].shape[1])
    t_pages = (Tmax - 1) // ps + 1
    pad = t_pages * ps - Tmax
    P = block_table.shape[1]
    dev = new_tokens.device
    is_new = new_lens > 0
    start32 = prefill_start.to(torch.int32)
    idx = (start32 // ps).long()[:, None] \
        + torch.arange(t_pages, device=dev)[None, :]
    gathered = block_table.long().gather(1, idx.clamp(max=P - 1))
    wt = torch.where(is_new[:, None] & (idx < P), gathered,
                     torch.full_like(gathered, SCRATCH_PAGE))
    x = other["embed_tokens"][new_tokens.long()].to(c.dtype)
    positions = start32[:, None] + torch.arange(
        Tmax, dtype=torch.int32, device=dev)[None, :]
    lens32 = new_lens.to(torch.int32)
    kv_lens = start32 + lens32
    quant = kv_dtype is not None
    for l in range(c.num_hidden_layers):
        lp = layer_slice(layer_p, l)
        h = _rmsnorm(x, lp["ln1"], c.rms_norm_eps)
        q, k, v = _qkv(h, lp, c)
        q, k = _rope(q, k, positions, c.rope_theta, c.head_dim)
        kp, vp, ksp, vsp = _layer_pools(cache, l, quant)
        shape = (B, t_pages, ps) + tuple(k.shape[2:])
        krows = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        vrows = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        # whole pages per (slot, logical page); scratch takes the
        # colliding writes, whichever lands last
        if quant:
            krows, ksrows = quantize_lastdim(krows, kv_dtype)  # + [B,T+pad,KV]
            vrows, vsrows = quantize_lastdim(vrows, kv_dtype)
            ksp[wt] = ksrows.reshape(shape[:-1])
            vsp[wt] = vsrows.reshape(shape[:-1])
        kp[wt] = krows.reshape(shape)
        vp[wt] = vrows.reshape(shape)
        att = attn(q, kp, vp, block_table, lens32, kv_lens, page_size=ps,
                   ksc=ksp, vsc=vsp)
        y = x + (att.reshape(B, Tmax, -1) @ lp["wo"])
        x = _mlp(y, lp, c)
    last = x[torch.arange(B, device=dev), (lens32 - 1).clamp(min=0).long()]
    return lm_head_logits(last, other, c), cache


def llama_ragged_burst(params, cache, block_table, pos, tok, done, limit,
                       new_tokens, new_lens, prefill_start, eos_id: int,
                       generator, config: LlamaConfig, n: int,
                       has_prefill: bool, temperature: float = 0.0,
                       top_k: int = 0, pad_id: int = 0,
                       kv_dtype: str | None = None, attn=_ragged_attn):
    """One mixed prefill+decode burst.

    Slots with ``new_lens[b] > 0`` first prefill their prompt (ragged, any
    length ≤ Tmax in the same launch), sample their first token and join
    the ``n`` decode steps alongside the already-decoding slots. A slot
    stops on ``eos_id`` or when its position reaches ``limit``; finished
    slots emit ``pad_id`` and freeze. All state stays on the device.
    ``kv_dtype`` ("int8" | "fp8" | None) is the cache's page codec (see
    ``init_paged_kv_cache``); ``attn`` is the pool read of every layer
    (the ragged kernel; an oracle passes the plain version).

    Returns (cache, pos, tok, done, emitted [n, B], firsts [B]) — firsts
    holds each newly admitted slot's prefill token (pad_id elsewhere)."""
    firsts = torch.full_like(tok, pad_id)
    with torch.no_grad():
        if has_prefill:
            logits, cache = _ragged_prefill_phase(
                params, cache, block_table, new_tokens, new_lens,
                prefill_start, config, kv_dtype=kv_dtype, attn=attn)
            first = _sample(logits, temperature, top_k, generator)
            is_new = new_lens > 0
            firsts = torch.where(is_new, first, firsts)
            tok = torch.where(is_new, first, tok)
            pos = torch.where(is_new, (prefill_start + new_lens).to(pos.dtype),
                              pos)
            done = torch.where(is_new, (first == eos_id) | (pos >= limit),
                               done)
        emitted = []
        for _ in range(n):
            logits = _ragged_decode_step_slots(params, cache, block_table,
                                               pos, tok, config,
                                               kv_dtype=kv_dtype, attn=attn)
            nxt = _sample(logits, temperature, top_k, generator)
            emitted.append(torch.where(done, torch.full_like(nxt, pad_id),
                                       nxt))
            new_pos = torch.where(done, pos, pos + 1)
            tok = torch.where(done, tok, nxt)
            done = done | (nxt == eos_id) | (new_pos >= limit)
            pos = new_pos
    emitted = torch.stack(emitted) if emitted \
        else torch.empty((0, tok.shape[0]), dtype=tok.dtype,
                         device=tok.device)
    return cache, pos, tok, done, emitted, firsts


def llama_paged_verify(params, cache, block_table, start, tokens, n_tok,
                       config: LlamaConfig, ragged: bool = True,
                       kv_dtype: str | None = None):
    """ONE launch per layer verifying every slot's speculative segment.

    tokens [B, Tv] int32 (Tv = k+1): slot b's row is [current token,
    proposals...] padded; n_tok [B] the live row length (0 skips the
    slot: its writes go to the scratch page, its targets are junk the host
    ignores); start [B] the slot's position, where row j lands at absolute
    position start + j — not page-aligned, so the K/V rows are written
    one by one through the block table (live rows to their page and row,
    dead rows to ``SCRATCH_PAGE``; quantized first with ``kv_dtype``),
    exactly as a decode step would write them one launch at a time. The
    ragged kernel then reads them back with q_len = n_tok and kv_len =
    start + n_tok, so its bottom-right causal mask lets row j attend rows
    <= start + j. Rows past the accepted prefix become stale pool rows the
    masks hide; the host rewinds by resetting pos and freeing trailing
    pages (shared pages were copied private by the growth sweep before
    these writes).

    Returns (targets [B, Tv] int32 — the greedy token after each row
    position, i.e. targets[b, j] is the token at start + j + 1 — and the
    cache). Greedy only: speculative serving runs at temperature 0, where
    accept-prefix is exact. ``ragged=False`` (the JAX package's gather
    read) is not ported."""
    if not ragged:
        raise NotImplementedError(
            "llama_paged_verify(ragged=False), the gather read path, is not "
            "ported yet (ROADMAP Queue 1 item 4); the port verifies through "
            "the ragged kernel")
    c = config
    layer_p, other = split_layer_params(params)
    B, Tv = tokens.shape
    ps = int(cache["k"][0].shape[1])
    P = block_table.shape[1]
    dev = tokens.device
    start32 = start.to(torch.int32)
    lens32 = n_tok.to(torch.int32)
    kv_lens = start32 + lens32
    positions = start32[:, None] + torch.arange(
        Tv, dtype=torch.int32, device=dev)[None, :]
    live = torch.arange(Tv, device=dev)[None, :] < lens32[:, None]
    pg_idx = (positions // ps).long().clamp(max=P - 1)
    wpage = torch.where(live, block_table.long().gather(1, pg_idx),
                        torch.full_like(pg_idx, SCRATCH_PAGE))
    wrow = (positions % ps).long()
    quant = kv_dtype is not None
    with torch.no_grad():
        x = other["embed_tokens"][tokens.long()].to(c.dtype)
        for l in range(c.num_hidden_layers):
            lp = layer_slice(layer_p, l)
            h = _rmsnorm(x, lp["ln1"], c.rms_norm_eps)
            q, k, v = _qkv(h, lp, c)
            q, k = _rope(q, k, positions, c.rope_theta, c.head_dim)
            kp, vp, ksp, vsp = _layer_pools(cache, l, quant)
            if quant:
                k, ks = quantize_lastdim(k, kv_dtype)   # + scales [B,Tv,KV]
                v, vs = quantize_lastdim(v, kv_dtype)
                ksp[wpage, wrow] = ks
                vsp[wpage, wrow] = vs
            kp[wpage, wrow] = k
            vp[wpage, wrow] = v
            att = _ragged_attn(q, kp, vp, block_table, lens32, kv_lens,
                               page_size=ps, ksc=ksp, vsc=vsp)
            y = x + (att.reshape(B, Tv, -1) @ lp["wo"])
            x = _mlp(y, lp, c)
        logits = lm_head_logits(x, other, c)           # [B, Tv, V] f32
    return torch.argmax(logits, dim=-1).to(torch.int32), cache

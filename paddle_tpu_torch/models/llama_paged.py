"""Paged KV cache, its gather read path and the ragged burst — the port
of ``paddle_tpu/models/llama_paged.py``.

The cache is a shared POOL of fixed-size pages per layer,
``[num_pages, page_size, KV, hd]``, with per-slot block tables
``[B, P]`` int32 mapping logical page j of slot b to a physical page.
Physical page 0 is the SCRATCH page (``inference.paging.SCRATCH_PAGE``):
idle slots and writes that no live request owns land there, and no live
row is ever read from it.

Two read paths share the pool, as in the JAX package:

* the ragged kernel (``ops/ragged_attention.py``, kernels K3/K4), which
  reads only each slot's live pages: ``llama_ragged_burst`` (ragged
  prefill rows and decode rows in one burst) and
  ``llama_paged_verify(ragged=True)``;
* the GATHER path of the engine's default ``kv_layout="paged"``: decode
  gathers each slot's pages through its block table into a
  ``[B, P·page_size]`` view (P the engine's page bucket) and attends it
  with the dense decode's arithmetic (``llama_decode
  ._cached_attention_slots``, ``_suffix_attention``,
  ``_verify_attention``: plain tensor arithmetic, XLA einsums in the JAX
  package); a prompt prefills into its pages through
  ``llama_paged_prefill_slot``, whose attention is ``llama._attention``'s
  flash path (kernel K1 on a CUDA tensor). A quantized pool dequantizes
  right after the gather.

Dead rows of the gather read: a gathered row at or past a slot's kv_len
(scratch rows, a page's unwritten tail, stale speculative rows) is masked
to probability 0, but 0·NaN is NaN, so its V row is zeroed before the
product (``_live_rows``; ``_cached_attention_slots`` for decode rows), as
the plain version of K3 does. For finite pools the products are
unchanged (0·v = 0), so on the JAX package's pools, which hold only
finite rows, the results are the same.

Pool writes are indexed assignments (``pool[page_ids, rows] = ...``) IN
PLACE, on the pool's device stream — the JAX package donated the pool to
its jitted functions (``donate_argnums=(1,)``) so XLA could update it in
place; the returned cache holds the same tensors it was given. So a write
the host queues after another (a later owner of a freed page) lands after
it.

Quantized pages (``kv_dtype`` "int8" | "fp8"): the payload pools keep the
``[num_pages, page_size, KV, hd]`` layout in the codec's payload dtype and
a per-(row, kv head) f32 scale rides in parallel ``[num_pages, page_size,
KV]`` pools under ``"k_scale"`` / ``"v_scale"`` (``quant/codec.py``, the
block being the head_dim vector). Writes quantize the fresh rows and store
payload and scale at the same indexes; the ragged kernel dequantizes what
it reads (kernel K4), the gather path right after its gather.
``kv_dtype=None`` is the unquantized cache, with no scale pools.

Prefix sharing and speculative decoding: ``copy_pages`` is the
copy-on-write primitive (payload and scale rows of whole pages); a suffix
prefill is ``_ragged_prefill_phase`` with ``prefill_start > 0`` on the
ragged path, ``llama_paged_prefill_suffix`` on the gather path;
``llama_paged_verify`` writes each slot's speculative segment row by row
and reads it back through the slot's read path. ``gather_pages`` and
``scatter_pages`` are the host copies of whole pages (the page transfer's
export read and install write).

``dequant=`` (weight-only int8 serving) dequantizes one layer's weights
at a time inside the layer loop (``llama.layer_slice``).

MoE configs: every function here runs the FFN (``llama._mlp``) over all
rows of its launch — dead lanes, pad rows and ``q_len = 0`` slots
included — exactly as the JAX package does, since an expert's capacity
couples the rows routed together.

Waiting for later slices: the sharded pool (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import math

import torch

from .._device import resolve_device
from ..inference.paging import SCRATCH_PAGE
from ..ops.ragged_attention import ragged_paged_attention
from ..quant.codec import (SCALE_DTYPE, dequantize_lastdim,
                           quantize_lastdim, scale_itemsize, wire_dtype,
                           wire_itemsize)
from .llama import (LlamaConfig, _expand_gqa, _mlp, _qkv, _rmsnorm, _rope,
                    _trunk, f32_scale, layer_slice, lm_head_logits,
                    split_layer_params)
from .llama_decode import _cached_attention_slots, _sample, burst_steps

__all__ = ["init_paged_kv_cache", "page_bytes", "paged_kv_bytes_per_token",
           "gather_pages", "scatter_pages", "copy_pages",
           "llama_paged_prefill_slot", "llama_paged_prefill_suffix",
           "llama_paged_decode_burst", "llama_ragged_burst",
           "llama_paged_verify"]


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


def gather_pages(cache, page_ids) -> dict:
    """Host copies of the pool slices at ``page_ids``: {leaf name: [one
    CPU tensor [n_pages, ...] per layer]} over every leaf the pool has
    (payload pools always, scale pools when quantized), in the order of
    ``page_ids`` — index j is logical page j of the request; physical page
    ids never leave the process. One device-to-host copy per leaf."""
    out = {}
    for name, bufs in cache.items():
        ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                              device=bufs[0].device)
        out[name] = list(torch.stack([buf[ids] for buf in bufs]).cpu()
                         .unbind(0))
    return out


def scatter_pages(cache, page_ids, rows: dict):
    """Write page rows into the pool at ``page_ids`` in place (the inverse
    of :func:`gather_pages`). ``rows`` maps leaf names to per-layer arrays
    or tensors of shape [n_pages, ...]; leaves absent from ``rows`` keep
    their buffers (a full-precision install never touches scale pools).
    Values are cast to each buffer's dtype. The writes are enqueued on the
    pool's device stream. Returns the cache."""
    for name, bufs in cache.items():
        if name not in rows:
            continue
        if len(rows[name]) != len(bufs):
            raise ValueError(
                f"scatter_pages: {name} carries {len(rows[name])} layers, "
                f"pool has {len(bufs)}")
        ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                              device=bufs[0].device)
        for buf, r in zip(bufs, rows[name]):
            buf[ids] = torch.as_tensor(r).to(buf.device, buf.dtype)
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


def _write_pages(pools, page_ids, k, v, kv_dtype):
    """Write rows k/v [T, KV, hd] over whole pages ``page_ids`` [n] of one
    layer's ``pools`` (k, v, k_scale, v_scale), zero rows padding T up to
    n·page_size; quantized first with ``kv_dtype`` (a zero pad row gives a
    zero payload, as in the JAX package)."""
    kp, vp, ksp, vsp = pools
    n, ps = page_ids.shape[0], kp.shape[1]
    pad = n * ps - k.shape[0]
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    shape = (n, ps) + tuple(k.shape[1:])
    if kv_dtype is not None:
        k, ks = quantize_lastdim(k, kv_dtype)
        v, vs = quantize_lastdim(v, kv_dtype)
        ksp[page_ids] = ks.reshape(shape[:-1])
        vsp[page_ids] = vs.reshape(shape[:-1])
    kp[page_ids] = k.reshape(shape)
    vp[page_ids] = v.reshape(shape)


def _write_rows(pools, page, row, k, v, kv_dtype):
    """Write single rows k/v [..., KV, hd] at (``page``, ``row``) [...] of
    one layer's ``pools``, quantized first with ``kv_dtype``."""
    kp, vp, ksp, vsp = pools
    if kv_dtype is not None:
        k, ks = quantize_lastdim(k, kv_dtype)
        v, vs = quantize_lastdim(v, kv_dtype)
        ksp[page, row] = ks
        vsp[page, row] = vs
    kp[page, row] = k
    vp[page, row] = v


def _gathered(pools, table, dtype):
    """The K/V rows of the pages in ``table`` [..., P] (long) as
    [..., P·page_size, KV, hd] in ``dtype``: the gather read, a quantized
    pool dequantized right after it."""
    kp, vp, ksp, vsp = pools
    kc, vc = kp[table], vp[table]
    if ksp is not None:
        kc = dequantize_lastdim(kc, ksp[table], dtype)
        vc = dequantize_lastdim(vc, vsp[table], dtype)
    shape = tuple(table.shape[:-1]) + (-1,) + tuple(kp.shape[2:])
    return kc.reshape(shape), vc.reshape(shape)


def _live_rows(vc, kv_lens):
    """vc [B, R, KV, hd] with each slot's rows at or past its kv_len [B]
    set to 0: the masked rows' probabilities are exactly 0, and a NaN
    there (an unwritten row) must not reach the output as 0·NaN."""
    live = torch.arange(vc.shape[1], device=vc.device)[None, :] \
        < kv_lens.to(vc.device).long()[:, None]
    return torch.where(live[:, :, None, None], vc, vc.new_zeros(()))


def _paged_decode_step_slots(params, cache, block_table, pos, tok,
                             config: LlamaConfig,
                             kv_dtype: str | None = None, dequant=None):
    """One single-token step over all slots, K/V through the block table.

    block_table [B, P] int32; pos/tok [B]. Slot b writes this token's K/V
    into physical page ``block_table[b, pos[b] // page_size]`` (the page
    index clamped to the table's width, as a JAX gather clamps) at row
    ``pos[b] % page_size``, then attends its gathered P·page_size rows
    under the dense path's ``row <= pos`` mask
    (``_cached_attention_slots``, which zeroes the V rows past pos). Every
    slot's row, free slots' included, goes through the FFN. Returns
    next-token logits [B, V] f32."""
    c = config
    layer_p, other = split_layer_params(params, dequant)
    B = tok.shape[0]
    ps = cache["k"][0].shape[1]
    P = block_table.shape[1]
    bt = block_table.long()
    x = other["embed_tokens"][tok.long()[:, None]].to(c.dtype)
    positions = pos[:, None].to(torch.int32)
    pos_l = pos.long()
    page = bt.gather(1, (pos_l // ps).clamp(max=P - 1)[:, None])[:, 0]
    row = pos_l % ps
    quant = kv_dtype is not None
    for l in range(c.num_hidden_layers):
        lp = layer_slice(layer_p, l, dequant)
        h = _rmsnorm(x, lp["ln1"], c.rms_norm_eps)
        q, k, v = _qkv(h, lp, c)
        q, k = _rope(q, k, positions, c.rope_theta, c.head_dim)
        pools = _layer_pools(cache, l, quant)
        _write_rows(pools, page, row, k[:, 0], v[:, 0], kv_dtype)
        kc, vc = _gathered(pools, bt, c.dtype)
        att = _cached_attention_slots(q, kc, vc, pos, c)
        y = x + (att.reshape(B, 1, -1) @ lp["wo"])
        x = _mlp(y, lp, c)
    return lm_head_logits(x[:, 0, :], other, c)


def _paged_prefill_logits(params, cache, tokens, page_ids, tlen,
                          config: LlamaConfig, dequant=None,
                          kv_dtype: str | None = None):
    """``llama_paged_prefill_slot`` up to its sampling: (the logits at
    position tlen - 1 [1, V] f32, cache)."""
    x, other, ks, vs = _trunk(params, tokens[None, :], config, dequant)
    ids = page_ids.long()
    for l in range(config.num_hidden_layers):
        _write_pages(_layer_pools(cache, l, kv_dtype is not None), ids,
                     ks[l][0], vs[l][0], kv_dtype)
    return lm_head_logits(x[:, int(tlen) - 1, :], other, config), cache


def llama_paged_prefill_slot(params, cache, tokens, page_ids, tlen,
                             config: LlamaConfig, temperature: float = 0.0,
                             top_k: int = 0, generator=None, dequant=None,
                             kv_dtype: str | None = None):
    """Prefill ONE request's prompt into its allocated pages.

    tokens [Tb] int32 padded to a bucket length; page_ids [ceil(Tb/ps)]
    physical pages (logical order); ``tlen`` the real prompt length. The
    prompt forward is ``llama._trunk`` (attention through kernel K1 on a
    CUDA tensor); every layer's K/V then lands in all ceil(Tb/ps) pages —
    rows past tlen hold pad K/V that the validity mask hides until decode
    overwrites them, so the host may free pages past ``tlen // ps`` right
    after the call (a later owner's writes queue behind these on the
    pool's stream). With ``kv_dtype`` only the cache writes quantize: the
    prompt forward and the first token stay full precision, as in the JAX
    package. Samples the first generated token at tlen - 1; returns
    (first token as a 0-d int32 tensor, cache)."""
    with torch.no_grad():
        logits, cache = _paged_prefill_logits(params, cache, tokens,
                                              page_ids, tlen, config,
                                              dequant, kv_dtype)
        first = _sample(logits, temperature, top_k, generator)
    return first[0], cache


def _suffix_attention(q, k_all, v_all, start, rows_p, config: LlamaConfig):
    """Causal attention of suffix queries over [gathered prefix rows ++
    in-pass suffix rows]. q [1, T, H, hd]; k_all/v_all [1, rows_p + T,
    KV, hd], the first ``rows_p`` rows the prefix pages gathered from the
    pool (valid below ``start``; the caller zeroes V past it), the last T
    the suffix computed in this pass (causal). The JAX package's
    arithmetic: logits in q's dtype widened to f32, the -1e30 mask, the
    f32 softmax rounded to q.dtype."""
    c = config
    k_all, v_all = _expand_gqa(k_all, v_all, c)
    scale = 1.0 / math.sqrt(c.head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q,
                          k_all).to(torch.float32) * scale
    T = q.shape[1]
    dev = q.device
    cols = torch.arange(rows_p + T, device=dev)[None, :]
    qpos = torch.arange(T, device=dev)[:, None]
    valid = torch.where(cols < rows_p, cols < int(start),
                        (cols - rows_p) <= qpos)
    logits = logits.masked_fill(~valid[None, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_all)


def llama_paged_prefill_suffix(params, cache, tokens, page_ids,
                               prefix_table, start, tlen,
                               config: LlamaConfig,
                               temperature: float = 0.0, top_k: int = 0,
                               generator=None, dequant=None,
                               kv_dtype: str | None = None):
    """Prefill ONLY a prompt's unshared SUFFIX against cached prefix pages
    (prefix sharing on the gather path).

    tokens [Tb] int32: the suffix (prompt positions [start, start+tlen))
    padded to a bucket length; page_ids [ceil(Tb/ps)] the fresh pages its
    rows land in (``start`` is a multiple of page_size); prefix_table [Pp]
    the SHARED pages holding positions [0, start), padded with scratch to
    a page bucket; ``tlen`` the real suffix length. Per layer the suffix
    K/V is written into its fresh pages as :func:`llama_paged_prefill_slot`
    writes, then the suffix queries attend [the prefix pages gathered from
    the pool ++ the in-pass suffix] (``_suffix_attention``, plain tensor
    arithmetic as in the JAX package): the pool rows are the bits the
    original request's prefill wrote (dequantized for a quantized pool),
    so greedy outputs match an unshared serve. Samples the first generated
    token at suffix position tlen - 1; returns (first, cache)."""
    c = config
    layer_p, other = split_layer_params(params, dequant)
    T = tokens.shape[0]
    ps = int(cache["k"][0].shape[1])
    rows_p = prefix_table.shape[0] * ps
    start = int(start)
    dev = tokens.device
    ids, ptab = page_ids.long(), prefix_table.long()
    positions = start + torch.arange(T, dtype=torch.int32,
                                     device=dev)[None, :]
    prefix_live = torch.tensor([start], device=dev)
    quant = kv_dtype is not None
    with torch.no_grad():
        x = other["embed_tokens"][tokens.long()[None, :]].to(c.dtype)
        for l in range(c.num_hidden_layers):
            lp = layer_slice(layer_p, l, dequant)
            h = _rmsnorm(x, lp["ln1"], c.rms_norm_eps)
            q, k, v = _qkv(h, lp, c)
            q, k = _rope(q, k, positions, c.rope_theta, c.head_dim)
            pools = _layer_pools(cache, l, quant)
            _write_pages(pools, ids, k[0], v[0], kv_dtype)
            # the shared prefix rows, from pages disjoint from the writes
            kc, vc = _gathered(pools, ptab, c.dtype)
            vc = _live_rows(vc[None], prefix_live)
            att = _suffix_attention(q, torch.cat([kc[None], k], 1),
                                    torch.cat([vc, v], 1), start, rows_p,
                                    c)
            y = x + (att.reshape(1, T, -1) @ lp["wo"])
            x = _mlp(y, lp, c)
        logits = lm_head_logits(x[:, int(tlen) - 1, :], other, c)
        first = _sample(logits, temperature, top_k, generator)
    return first[0], cache


def llama_paged_decode_burst(params, cache, block_table, pos, tok, done,
                             limit, eos_id: int, generator,
                             config: LlamaConfig, n: int,
                             temperature: float = 0.0, top_k: int = 0,
                             pad_id: int = 0, dequant=None,
                             kv_dtype: str | None = None):
    """n paged-decode steps through the gather read — the ``"paged"``
    layout's hot loop. Same contract as ``llama_decode_burst`` plus
    block_table [B, P] (P the page bucket of the widest live slot): a slot
    stops on ``eos_id`` or ``limit``, finished slots emit ``pad_id`` and
    freeze (their frozen write lands in their own page while they hold
    one, in scratch page 0 once the host retires them and zeroes their
    table row). Returns (cache, pos, tok, done, emitted [n, B])."""
    def logits_of(pos, tok):
        return _paged_decode_step_slots(params, cache, block_table, pos,
                                        tok, config, kv_dtype, dequant)

    pos, tok, done, emitted = burst_steps(
        logits_of, pos, tok, done, limit, eos_id, n, temperature, top_k,
        pad_id, generator)
    return cache, pos, tok, done, emitted


def _ragged_decode_step_slots(params, cache, block_table, pos, tok,
                              config: LlamaConfig,
                              kv_dtype: str | None = None,
                              attn=_ragged_attn, dequant=None):
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
    layer_p, other = split_layer_params(params, dequant)
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
        lp = layer_slice(layer_p, l, dequant)
        h = _rmsnorm(x, lp["ln1"], c.rms_norm_eps)
        q, k, v = _qkv(h, lp, c)
        q, k = _rope(q, k, positions, c.rope_theta, c.head_dim)
        pools = _layer_pools(cache, l, quant)
        _write_rows(pools, page, row, k[:, 0], v[:, 0], kv_dtype)
        kp, vp, ksp, vsp = pools
        att = attn(q, kp, vp, block_table, one, kv_lens, page_size=ps,
                   ksc=ksp, vsc=vsp)
        y = x + (att.reshape(B, 1, -1) @ lp["wo"])
        x = _mlp(y, lp, c)
    return lm_head_logits(x[:, 0, :], other, c)


def _ragged_prefill_phase(params, cache, block_table, new_tokens, new_lens,
                          prefill_start, config: LlamaConfig,
                          kv_dtype: str | None = None, attn=_ragged_attn,
                          dequant=None):
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
    layer_p, other = split_layer_params(params, dequant)
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
        lp = layer_slice(layer_p, l, dequant)
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
                       kv_dtype: str | None = None, attn=_ragged_attn,
                       dequant=None):
    """One mixed prefill+decode burst.

    Slots with ``new_lens[b] > 0`` first prefill their prompt (ragged, any
    length ≤ Tmax in the same launch), sample their first token and join
    the ``n`` decode steps alongside the already-decoding slots. A slot
    stops on ``eos_id`` or when its position reaches ``limit``; finished
    slots emit ``pad_id`` and freeze. All state stays on the device.
    ``kv_dtype`` ("int8" | "fp8" | None) is the cache's page codec (see
    ``init_paged_kv_cache``); ``attn`` is the pool read of every layer
    (the ragged kernel; an oracle passes the plain version); ``dequant``
    as in the module docstring.

    Returns (cache, pos, tok, done, emitted [n, B], firsts [B]) — firsts
    holds each newly admitted slot's prefill token (pad_id elsewhere)."""
    firsts = torch.full_like(tok, pad_id)
    with torch.no_grad():
        if has_prefill:
            logits, cache = _ragged_prefill_phase(
                params, cache, block_table, new_tokens, new_lens,
                prefill_start, config, kv_dtype=kv_dtype, attn=attn,
                dequant=dequant)
            first = _sample(logits, temperature, top_k, generator)
            is_new = new_lens > 0
            firsts = torch.where(is_new, first, firsts)
            tok = torch.where(is_new, first, tok)
            pos = torch.where(is_new, (prefill_start + new_lens).to(pos.dtype),
                              pos)
            done = torch.where(is_new, (first == eos_id) | (pos >= limit),
                               done)

    def logits_of(pos, tok):
        return _ragged_decode_step_slots(params, cache, block_table, pos,
                                         tok, config, kv_dtype=kv_dtype,
                                         attn=attn, dequant=dequant)

    pos, tok, done, emitted = burst_steps(
        logits_of, pos, tok, done, limit, eos_id, n, temperature, top_k,
        pad_id, generator)
    return cache, pos, tok, done, emitted, firsts


def _verify_attention(q, kc, vc, start, config: LlamaConfig):
    """Verify-segment attention for the GATHER read: q [B, Tv, H, hd]
    queries at absolute positions ``start[b] + j`` over the block-table-
    gathered rows kc/vc [B, R, KV, hd] (row r = logical position r);
    query j attends rows <= start + j, the offset mask the ragged kernel
    computes from (q_len, kv_len). The arithmetic of
    ``_cached_attention_slots`` (grouped einsum, f32 logits, -1e30 mask,
    softmax rounded to q.dtype), so greedy targets match the plain decode
    step's token for token."""
    c = config
    H, KV = c.num_attention_heads, c.num_key_value_heads
    B, Tv, _, hd = q.shape
    R = kc.shape[1]
    qg = q.reshape(B, Tv, KV, H // KV, hd)
    logits = torch.einsum("btkgd,bskd->bkgts", qg.to(torch.float32),
                          kc.to(torch.float32)) * f32_scale(c.head_dim)
    dev = q.device
    cols = torch.arange(R, device=dev)[None, None, :]
    qpos = start.to(dev).long()[:, None, None] \
        + torch.arange(Tv, device=dev)[None, :, None]
    valid = cols <= qpos                                    # [B, Tv, R]
    logits = logits.masked_fill(~valid[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, vc)
    return out.reshape(B, Tv, H, hd)


def llama_paged_verify(params, cache, block_table, start, tokens, n_tok,
                       config: LlamaConfig, ragged: bool = True,
                       kv_dtype: str | None = None, dequant=None):
    """ONE launch per layer verifying every slot's speculative segment.

    tokens [B, Tv] int32 (Tv = k+1): slot b's row is [current token,
    proposals...] padded; n_tok [B] the live row length (0 skips the
    slot: its writes go to the scratch page, its targets are junk the host
    ignores); start [B] the slot's position, where row j lands at absolute
    position start + j — not page-aligned, so the K/V rows are written
    one by one through the block table (live rows to their page and row,
    dead rows to ``SCRATCH_PAGE``; quantized first with ``kv_dtype``),
    exactly as a decode step would write them one launch at a time. Then
    each slot reads them back through its read path: the ragged kernel
    (``ragged=True``) with q_len = n_tok and kv_len = start + n_tok, whose
    bottom-right causal mask lets row j attend rows <= start + j; or the
    gather (``ragged=False``, the ``"paged"`` layout, P the page bucket)
    and ``_verify_attention``, V rows at or past kv_len zeroed. Rows past
    the accepted prefix become stale pool rows the masks hide; the host
    rewinds by resetting pos and freeing trailing pages (shared pages
    were copied private by the growth sweep before these writes).

    Returns (targets [B, Tv] int32 — the greedy token after each row
    position, i.e. targets[b, j] is the token at start + j + 1 — and the
    cache). Greedy only: speculative serving runs at temperature 0, where
    accept-prefix is exact. ``dequant`` as in the module docstring."""
    c = config
    layer_p, other = split_layer_params(params, dequant)
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
    bt = block_table.long()
    pg_idx = (positions // ps).long().clamp(max=P - 1)
    wpage = torch.where(live, bt.gather(1, pg_idx),
                        torch.full_like(pg_idx, SCRATCH_PAGE))
    wrow = (positions % ps).long()
    quant = kv_dtype is not None
    with torch.no_grad():
        x = other["embed_tokens"][tokens.long()].to(c.dtype)
        for l in range(c.num_hidden_layers):
            lp = layer_slice(layer_p, l, dequant)
            h = _rmsnorm(x, lp["ln1"], c.rms_norm_eps)
            q, k, v = _qkv(h, lp, c)
            q, k = _rope(q, k, positions, c.rope_theta, c.head_dim)
            pools = _layer_pools(cache, l, quant)
            _write_rows(pools, wpage, wrow, k, v, kv_dtype)
            if ragged:
                kp, vp, ksp, vsp = pools
                att = _ragged_attn(q, kp, vp, block_table, lens32, kv_lens,
                                   page_size=ps, ksc=ksp, vsc=vsp)
            else:
                kc, vc = _gathered(pools, bt, c.dtype)
                att = _verify_attention(q, kc, _live_rows(vc, kv_lens),
                                        start32, c)
            y = x + (att.reshape(B, Tv, -1) @ lp["wo"])
            x = _mlp(y, lp, c)
        logits = lm_head_logits(x, other, c)           # [B, Tv, V] f32
    return torch.argmax(logits, dim=-1).to(torch.int32), cache

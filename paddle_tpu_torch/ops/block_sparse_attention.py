"""Block-sparse flash attention — the port of
``paddle_tpu/ops/block_sparse_attention.py``.

Attention over a COO pattern of attendable (query, key) pairs without any
[T, T] intermediate. As in the JAX package the pattern is compiled once on
the host (``pattern_to_block_map``, copied as is) into

* ``block_map`` [T/bq, T/bk] int32 — 0: the block holds no pair; v > 0:
  the block is computed with mask slot v − 1;
* ``partial_masks`` [P, bq, bk] int8 — slot 0 is all ones (every fully
  covered block), the others hold the pairs of one partial block.

What kernels K5 and K6 compute is the function of those two arrays:
``bsa_fwd_reference`` (K5: out and lse, masking by −inf, a row that
attends nothing giving out 0 and lse −inf) and ``bsa_bwd_reference`` (K6:
dq, dk, dv from the saved out and lse, lse pinned to 0 where it is not
finite, ds carrying the scale, dk = dsᵀ·q with the unscaled q). Both run
one query block at a time over that block's active key blocks, in exact
f32, and return outputs in their inputs' dtypes.

The CUDA kernels (``csrc/block_sparse_attention.cu``) do not walk the
pattern's blocks, whose size is the caller's (any divisor of T: 8, 70,
512, ...). ``tile_plan`` derives from ``block_map`` and ``partial_masks`` a
plan at the kernels' own tile of ``TILE`` × ``TILE``: each tile is skipped
(no pair), full (every pair: no per-element test) or mixed (one 64-bit
word of attended keys per query row). At T=8192 under a Longformer
pattern the 512-blocks that ``fused_attention`` picks cover 28.9% of T²,
the plan's 64-tiles 8.4%. bf16 runs on the Hopper tile core of
``csrc/hopper_attention.cuh``: ``bsa_fwd`` (wgmma products over the active
K/V tiles of each 128-row block, which TMA streams into a two-stage ring)
and ``bsa_bwd`` (one kernel doing the five products of each (key tile,
query tile) pair on wgmma, dq summed in an f32 accumulator by TMA
reduce-adds, with a preparation and a conversion kernel in the same launch
call); f32 runs on CUDA cores (``bsa_fwd``, ``bsa_bwd_dq`` and
``bsa_bwd_dkv``).

Dispatch follows the tensors' device and nothing else: CPU tensors take
the plain versions, CUDA tensors launch the kernels or raise. Tolerances
are ``flash_attention.tolerance``'s (per row of out and dq, per key of dk
and dv) and ``LSE_TOL`` on lse where it is finite: the kernels round p and
ds to bf16 as tensor-core operands exactly as K1 and K2 do. The bf16
backward sums dq in f32 across blocks in an order that changes from run
to run: dq's bits do, its bound does not.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from .._device import resolve_device
from .flash_attention import (_DTYPE_CODE, LSE_TOL, SUPPORTED_HEAD_DIMS,
                              _bwd_delta, _check, _check_tma, _scale,
                              _strides, tolerance)

__all__ = ["block_sparse_attention", "block_sparse_attention_plain",
           "compile_pattern", "pattern_to_block_map", "tile_plan",
           "bsa_fwd_reference", "bsa_bwd_reference", "bsa_forward",
           "bsa_backward", "tolerance", "LSE_TOL", "LAUNCHES", "TILE"]

# kernel launches by kernel name; chip_smoke.py zeroes it before the main
# path and reads it after
LAUNCHES: collections.Counter = collections.Counter()

TILE = 64   # the kernels' tile, query rows × keys (kTile in the source)


def pattern_to_block_map(rows, cols, T, block_q, block_k):
    """Compile a COO pattern (host arrays) into (block_map, partial_masks).

    O(nnz) host work, done once per mask — never materializes [T, T].
    """
    rows = np.asarray(rows, np.int64).reshape(-1)
    cols = np.asarray(cols, np.int64).reshape(-1)
    gq, gk = T // block_q, T // block_k
    # per-block nnz (duplicate pattern entries collapse via unique pairs)
    uniq_pair = np.unique(rows * T + cols)
    urows, ucols = uniq_pair // T, uniq_pair % T
    ulin = (urows // block_q) * gk + (ucols // block_k)
    counts = np.bincount(ulin, minlength=gq * gk).reshape(gq, gk)
    full = counts == block_q * block_k
    partial = (counts > 0) & ~full
    pidx = np.flatnonzero(partial.reshape(-1))
    # block_map semantics: 0 = skip; v > 0 = compute with mask slot v-1
    # (slot 0 is the shared all-ones block for fully-covered tiles)
    block_map = np.zeros((gq, gk), np.int32)
    block_map[full] = 1
    block_map.reshape(-1)[pidx] = np.arange(len(pidx), dtype=np.int32) + 2
    masks = np.zeros((len(pidx) + 1, block_q, block_k), np.int8)
    masks[0] = 1
    slot_by_lin = np.zeros(gq * gk, np.int64)
    slot_by_lin[pidx] = np.arange(len(pidx)) + 1
    in_partial = partial.reshape(-1)[ulin]
    pr, pc = urows[in_partial], ucols[in_partial]
    masks[slot_by_lin[ulin[in_partial]], pr % block_q, pc % block_k] = 1
    return block_map, masks


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The pattern at the kernels' tile (see ``tile_plan``). The 64-tile
    lists serve the f32 kernels, the pair lists the bf16 ones."""
    tile_map: np.ndarray  # [n, n] int8: 0 skip, 1 full, 2 mixed
    bits: np.ndarray      # [mixed, tile] int64: bit c of word r = pair (r, c)
    q_ptr: np.ndarray     # [n + 1] int32: q tile i's entries q_ent[ptr[i]:]
    q_ent: np.ndarray     # [active, 2] int32: (k tile, bits slot or −1)
    k_ptr: np.ndarray     # [n + 1] int32: the same by k tile
    k_ent: np.ndarray     # [active, 2] int32: (q tile, bits slot or −1)
    fwd_ptr: np.ndarray   # [m + 1] int32: 2-tile q block i's entries
    fwd_ent: np.ndarray   # [·, 3] int32: (k tile, slot of either half)
    fwd_order: np.ndarray  # [m] int32: q blocks, longest list first
    bwd_ptr: np.ndarray   # [m + 1] int32: the same by 2-tile k block
    bwd_ent: np.ndarray   # [·, 3] int32: (q tile, slot of either half)
    bwd_order: np.ndarray  # [m] int32: k blocks, longest list first


# a half's slot in a pair list where its tile holds no pair (−1: full,
# ≥ 0: its words in ``bits``); kSkip in the kernel source
SKIP = -2


def _by_first(major, minor, slot, n):
    """CSR-style (ptr [n + 1], entries [len, 2]) of (minor, slot) grouped
    by ``major`` (already sorted)."""
    ptr = np.concatenate([[0], np.cumsum(np.bincount(major, minlength=n))])
    return ptr.astype(np.int32), np.stack([minor, slot], 1).astype(np.int32)


def _pair_lists(tile_map, slot):
    """The lists of the bf16 kernels, whose blocks own two tiles along the
    first axis of ``tile_map`` [n, n] (``slot`` [n, n]: −1 full, ≥ 0 the
    mixed tile's words): (ptr [m + 1], entries [·, 3] = (tile along the
    second axis, slot of the first tile, slot of the second, ``SKIP``
    where that tile holds no pair), order [m]: the blocks by list length,
    longest first; m = ⌈n / 2⌉). Each list is the union of its two tiles'
    lists in ascending order; a block whose tiles hold no pair has an
    empty one."""
    n = tile_map.shape[0]
    m = -(-n // 2)
    tm = np.zeros((2 * m, n), tile_map.dtype)
    tm[:n] = tile_map
    sl = np.full((2 * m, n), SKIP, np.int64)
    sl[:n] = np.where(tile_map > 0, slot, SKIP)
    blk, tile = np.nonzero((tm.reshape(m, 2, n) > 0).any(1))
    ptr = np.concatenate([[0], np.cumsum(np.bincount(blk, minlength=m))])
    ent = np.stack([tile, sl[2 * blk, tile], sl[2 * blk + 1, tile]], 1)
    order = np.argsort(-np.diff(ptr), kind="stable")
    return ptr.astype(np.int32), ent.astype(np.int32), order.astype(np.int32)


def tile_plan(block_map, masks, T, block_q, block_k, tile=TILE):
    """Derive the kernels' plan from ``block_map`` and ``partial_masks``.

    Tiles are ``tile`` × ``tile`` from (0, 0); the last row and column of
    tiles stop at T. A tile is 1 (full) when it lies inside [0, T)² and
    the pattern holds every one of its pairs, 0 when it holds none, 2
    otherwise; each mixed tile gets ``tile`` 64-bit words (``tile`` ≤
    64), bit c of word r set when pair (r, c) of the tile is attended.
    The active tiles are listed by query tile (for the f32 ``bsa_fwd`` and
    ``bsa_bwd_dq``) and by key tile (for the f32 ``bsa_bwd_dkv``), each in
    ascending order; for the bf16 kernels, whose blocks own two tiles,
    by pair of query tiles (``bsa_fwd``) and by pair of key tiles
    (``bsa_bwd``), each with both halves' slots and an order that puts the
    longest lists first (``_pair_lists``). Host work is O(the active
    blocks' area), never [T, T]."""
    block_map = np.asarray(block_map)
    masks = np.asarray(masks)
    n = -(-T // tile)
    act = np.argwhere(block_map > 0)
    which, rr, cc = np.nonzero(masks[block_map[act[:, 0], act[:, 1]] - 1])
    r = act[which, 0] * block_q + rr
    c = act[which, 1] * block_k + cc
    lin = (r // tile) * n + c // tile
    counts = np.bincount(lin, minlength=n * n).reshape(n, n)
    tile_map = np.where(counts == tile * tile, 1,
                        np.where(counts > 0, 2, 0)).astype(np.int8)
    mixed = np.flatnonzero(tile_map.reshape(-1) == 2)
    slot = np.full(n * n, -1, np.int64)
    slot[mixed] = np.arange(len(mixed))
    s = slot[lin]
    keep = s >= 0
    dense = np.zeros((len(mixed), tile, 64), bool)      # a word per row
    dense[s[keep], r[keep] % tile, c[keep] % tile] = True
    packed = np.packbits(dense, axis=-1, bitorder="little")
    bits = np.ascontiguousarray(packed).view("<i8").reshape(len(mixed), tile)
    qi, kj = np.nonzero(tile_map)
    q_ptr, q_ent = _by_first(qi, kj, slot[qi * n + kj], n)
    kj2, qi2 = np.nonzero(tile_map.T)
    k_ptr, k_ent = _by_first(kj2, qi2, slot[qi2 * n + kj2], n)
    slot = slot.reshape(n, n)
    return TilePlan(tile_map, bits, q_ptr, q_ent, k_ptr, k_ent,
                    *_pair_lists(tile_map, slot),
                    *_pair_lists(tile_map.T, slot.T))


# -------------------------------------------------------- plain versions
def _host(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _blocks(block_map, masks, i, block_q, block_k, device):
    """The active key blocks of query block i: (key index [n·bk] on
    ``device``, attended mask [bq, n·bk] bool), or None."""
    js = np.flatnonzero(block_map[i])
    if js.size == 0:
        return None
    idx = torch.from_numpy((js[:, None] * block_k
                            + np.arange(block_k)).reshape(-1)).to(device)
    slots = torch.from_numpy(block_map[i, js].astype(np.int64) - 1) \
        .to(masks.device)
    m = masks[slots].to(device) != 0                 # [n, bq, bk]
    return idx, m.permute(1, 0, 2).reshape(block_q, -1)


def bsa_fwd_reference(q, k, v, block_map, masks, block_q, block_k,
                      sm_scale=None):
    """The plain PyTorch version of K5 on [B, T, H, D]: (out in q.dtype,
    lse [B, H, T] f32), all arithmetic in f32, one query block at a time
    over its active key blocks."""
    B, T, H, D = q.shape
    scale = _scale(D, sm_scale)
    block_map = _host(block_map)
    masks = torch.as_tensor(masks, device=q.device)
    f32 = torch.float32
    out = torch.zeros((B, T, H, D), dtype=f32, device=q.device)
    lse = torch.full((B, H, T), -math.inf, dtype=f32, device=q.device)
    for i in range(block_map.shape[0]):
        got = _blocks(block_map, masks, i, block_q, block_k, q.device)
        if got is None:
            continue
        idx, m = got
        rows = slice(i * block_q, (i + 1) * block_q)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, rows].to(f32) * scale,
                         k[:, idx].to(f32))
        s = s.masked_fill(~m, -math.inf)
        mx = s.amax(-1, keepdim=True)
        safe = torch.where(torch.isneginf(mx), torch.zeros_like(mx), mx)
        p = torch.exp(s - safe)
        denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
        out[:, rows] = torch.einsum("bhqk,bkhd->bqhd", p / denom,
                                    v[:, idx].to(f32))
        lse[:, :, rows] = (mx + torch.log(denom))[..., 0]
    return out.to(q.dtype), lse


def bsa_bwd_reference(q, k, v, out, lse, dout, block_map, masks, block_q,
                      block_k, sm_scale=None):
    """The plain PyTorch version of K6: (dq, dk, dv), each in its input's
    dtype, all arithmetic in f32 (delta = rowsum(out·dout) as the JAX
    package computes it outside its kernels)."""
    B, T, H, D = q.shape
    scale = _scale(D, sm_scale)
    block_map = _host(block_map)
    masks = torch.as_tensor(masks, device=q.device)
    f32 = torch.float32
    dof = dout.to(f32)
    delta = (out.to(f32) * dof).sum(-1).transpose(1, 2)[..., None]
    lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    dq = torch.zeros((B, T, H, D), dtype=f32, device=q.device)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    for i in range(block_map.shape[0]):
        got = _blocks(block_map, masks, i, block_q, block_k, q.device)
        if got is None:
            continue
        idx, m = got
        rows = slice(i * block_q, (i + 1) * block_q)
        qb, kb, vb = q[:, rows].to(f32), k[:, idx].to(f32), v[:, idx].to(f32)
        s = torch.einsum("bqhd,bkhd->bhqk", qb * scale, kb)
        p = torch.where(m, torch.exp(s - lse[:, :, rows, None]),
                        torch.zeros_like(s))
        dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, rows], vb)
        ds = p * (dp - delta[:, :, rows]) * scale
        dq[:, rows] = torch.einsum("bhqk,bkhd->bqhd", ds, kb)
        dk.index_add_(1, idx, torch.einsum("bhqk,bqhd->bkhd", ds, qb))
        dv.index_add_(1, idx, torch.einsum("bhqk,bqhd->bkhd", p,
                                           dof[:, rows]))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernels
def _validate(q, k, v, pattern):
    if q.dim() != 4 or q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"block-sparse attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (want three "
                         "[B, T, H, D])")
    B, T, H, D = q.shape
    if T != pattern.T:
        raise ValueError(f"block-sparse attention: T={T}, pattern compiled "
                         f"for T={pattern.T}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"block-sparse attention: head dim {D} not in "
                         f"{SUPPORTED_HEAD_DIMS} on a CUDA tensor")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"block-sparse attention: dtype {q.dtype} not in "
                        f"{list(_DTYPE_CODE)}")
    if min(B, T, H) == 0:
        raise ValueError("block-sparse attention: empty input")
    if q.device != pattern.device:
        raise ValueError(f"block-sparse attention: q on {q.device}, pattern "
                         f"on {pattern.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype, q.device)


def _kernel_layout(t):
    """``t`` itself when the kernels can read it through its strides,
    else a contiguous copy."""
    vec = 16 // t.element_size()
    if t.stride(-1) == 1 and not any(s % vec for s in t.stride()[:3]) \
            and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def _run(name, plan, scale, **tensors):
    """Launch kernel ``name`` on the current stream with the data pointers
    of ``tensors`` and then of ``plan``'s device arrays (in the C
    signature's order), raise on a launch error, and count the launch."""
    from . import _build
    q = tensors["q"]
    B, T, H, D = q.shape
    lib = _build.load("block_sparse_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name + "_launch")(
            *(t.data_ptr() for t in tensors.values()),
            *(a.data_ptr() for a in plan), _DTYPE_CODE[q.dtype], B, T, H, D,
            ctypes.c_float(scale), _strides(**tensors), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} "
                           f"({_build.error_string(err)})")
    LAUNCHES[name] += 1


def _bsa_fwd(q, k, v, pattern, scale):
    """Launch bsa_fwd: (out like q, lse [B, H, T] f32). f32 walks the tile
    lists, bf16 the pair lists."""
    _validate(q, k, v, pattern)
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_tma(name, t)
    B, T, H, _ = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _run("bsa_fwd", (*pattern.q_plan, pattern.bits, *pattern.fwd_plan),
         scale, q=q, k=k, v=v, out=out, lse=lse)
    return out, lse


def _bsa_bwd_dq(q, k, v, dout, lse, delta, pattern, scale):
    """Launch bsa_bwd_dq (f32): dq like q."""
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _run("bsa_bwd_dq", (*pattern.q_plan, pattern.bits), scale, q=q, k=k,
         v=v, dout=dout, lse=lse, delta=delta, dq=dq)
    return dq


def _bsa_bwd_dkv(q, k, v, dout, lse, delta, pattern, scale):
    """Launch bsa_bwd_dkv (f32): (dk like k, dv like v)."""
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _run("bsa_bwd_dkv", (*pattern.k_plan, pattern.bits), scale, q=q, k=k,
         v=v, dout=dout, lse=lse, delta=delta, dk=dk, dv=dv)
    return dk, dv


def _bsa_bwd_bf16(q, k, v, out, lse, dout, pattern, scale):
    """Launch bsa_bwd (bf16): (dq like q, dk like k, dv like v). Its f32
    scratch comes from here: lse·log2(e) and delta [B, H, Tp] (Tp = T
    rounded up to a whole 64-row tile) and the dq accumulator [B, T, H,
    D]; the launch's preparation kernel fills them, so none is zeroed
    here."""
    _check("out", out, q.dtype, q.device)
    if out.shape != q.shape:
        raise ValueError("block-sparse attention backward: out must be "
                         "like q")
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        _check_tma(name, t)
    B, T, H, D = q.shape
    Tp = -(-T // TILE) * TILE
    f32 = dict(dtype=torch.float32, device=q.device)
    lse2 = torch.empty((B, H, Tp), **f32)
    delta = torch.empty((B, H, Tp), **f32)
    dq_acc = torch.empty((B, T, H, D), **f32)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    ptr, ent, order = pattern.bwd_plan
    _run("bsa_bwd", (ptr, ent, pattern.bits, order), scale, q=q, k=k, v=v,
         out=out, dout=dout, lse=lse, lse2=lse2, delta=delta, dq_acc=dq_acc,
         dq=dq, dk=dk, dv=dv)
    return dq, dk, dv


def _bsa_bwd(q, k, v, out, lse, dout, pattern, scale):
    """(dq, dk, dv): bsa_bwd in bf16 (delta in its preparation kernel); in
    f32 delta, then bsa_bwd_dq and bsa_bwd_dkv."""
    _validate(q, k, v, pattern)
    dout = _kernel_layout(dout)
    _check("dout", dout, q.dtype, q.device)
    B, T, H, _ = q.shape
    if dout.shape != q.shape or lse.shape != (B, H, T) \
            or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("block-sparse attention backward: dout must be "
                         "like q and lse f32 [B, H, T] contiguous")
    if q.dtype == torch.bfloat16:
        return _bsa_bwd_bf16(q, k, v, out, lse, dout, pattern, scale)
    delta = _bwd_delta(out, dout)
    dq = _bsa_bwd_dq(q, k, v, dout, lse, delta, pattern, scale)
    dk, dv = _bsa_bwd_dkv(q, k, v, dout, lse, delta, pattern, scale)
    return dq, dk, dv


def _plain_forward(q, k, v, pattern):
    return bsa_fwd_reference(q, k, v, pattern.block_map, pattern.masks,
                             pattern.block_q, pattern.block_k)


def _plain_backward(q, k, v, out, lse, dout, pattern):
    return bsa_bwd_reference(q, k, v, out, lse, dout, pattern.block_map,
                             pattern.masks, pattern.block_q, pattern.block_k)


def bsa_forward(q, k, v, pattern):
    """(out, lse) of K5 under a compiled ``pattern``: the plain version on
    CPU tensors, the kernel on CUDA tensors."""
    if q.device.type == "cpu":
        return _plain_forward(q, k, v, pattern)
    if q.device.type != "cuda":
        raise ValueError(f"block-sparse attention: unsupported device "
                         f"{q.device}")
    return _bsa_fwd(q, k, v, pattern, _scale(q.shape[-1], None))


def bsa_backward(q, k, v, out, lse, dout, pattern):
    """(dq, dk, dv) of K6: the plain version on CPU tensors, the kernels
    on CUDA tensors."""
    if q.device.type == "cpu":
        return _plain_backward(q, k, v, out, lse, dout, pattern)
    if q.device.type != "cuda":
        raise ValueError(f"block-sparse attention: unsupported device "
                         f"{q.device}")
    return _bsa_bwd(q, k, v, out, lse, dout, pattern,
                    _scale(q.shape[-1], None))


class _BlockSparseAttention(torch.autograd.Function):
    """out = attention(q, k, v) under a compiled pattern through ``fwd``
    (→ out, lse); saves q, k, v, out and lse, and its backward runs
    ``bwd`` from them (the JAX package's custom_vjp in ``_get_bsa_fn``)."""

    @staticmethod
    def forward(ctx, q, k, v, pattern, fwd, bwd):
        out, lse = fwd(q, k, v, pattern)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.pattern, ctx.bwd = pattern, bwd
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, out, lse, dout, ctx.pattern)
        return dq, dk, dv, None, None, None


class CompiledPattern:
    """One COO pattern compiled for T and a block size, its arrays on one
    device: ``block_map`` (host, for the plain versions' loop),
    ``masks``, and the kernels' tile plan (``plan`` on the host, its
    lists and words on the device). Calling it runs attention on [B, T,
    H, D] q, k, v (differentiable); ``plain`` runs the plain versions."""

    def __init__(self, rows, cols, T, block_q, block_k, device):
        self.T, self.block_q, self.block_k = T, block_q, block_k
        self.device = device
        self.block_map, masks = pattern_to_block_map(rows, cols, T, block_q,
                                                     block_k)
        self.masks = torch.from_numpy(masks).to(device)
        self.plan = tile_plan(self.block_map, masks, T, block_q, block_k)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.q_plan = (dev(self.plan.q_ptr), dev(self.plan.q_ent))
        self.k_plan = (dev(self.plan.k_ptr), dev(self.plan.k_ent))
        self.fwd_plan = tuple(dev(getattr(self.plan, "fwd_" + x))
                              for x in ("ptr", "ent", "order"))
        self.bwd_plan = tuple(dev(getattr(self.plan, "bwd_" + x))
                              for x in ("ptr", "ent", "order"))
        self.bits = dev(self.plan.bits)

    def __call__(self, q, k, v):
        return _BlockSparseAttention.apply(q, k, v, self, bsa_forward,
                                           bsa_backward)

    def plain(self, q, k, v):
        return _BlockSparseAttention.apply(q, k, v, self, _plain_forward,
                                           _plain_backward)


@functools.lru_cache(maxsize=8)
def _get_pattern(rows_bytes, cols_bytes, T, block_q, block_k, device):
    """The compiled pattern, cached on the COO pattern's bytes as the JAX
    package's ``_get_bsa_fn`` is: each entry pins the masks and the plan
    on the device, so maxsize is small."""
    return CompiledPattern(np.frombuffer(rows_bytes, np.int64),
                           np.frombuffer(cols_bytes, np.int64), T, block_q,
                           block_k, torch.device(device))


def compile_pattern(rows, cols, T, block_q: int = 512, block_k: int = 512,
                    device="cuda"):
    """Resolve (and cache) the compiled pattern of one COO pattern on
    ``device``. This is the only point that reads the pattern to the host
    and hashes its bytes; the block map, masks and tile plan are built
    there once and moved to the device once."""
    dev = resolve_device(device)
    return _get_pattern(_host(rows).astype(np.int64).tobytes(),
                        _host(cols).astype(np.int64).tobytes(),
                        int(T), int(block_q), int(block_k), str(dev))


def _blocks_for(q, block_q, block_k):
    T = q.shape[1]
    block_q, block_k = min(block_q, T), min(block_k, T)
    assert T % block_q == 0 and T % block_k == 0, \
        f"pattern blocks must tile T: {T} % {block_q}/{block_k}"
    return T, block_q, block_k


def block_sparse_attention(q, k, v, rows, cols, block_q: int = 512,
                           block_k: int = 512):
    """Attention over the COO pattern (rows, cols) without any [T, T]
    intermediate. q/k/v: [B, T, H, D] (flash_attention layout), on q's
    device. Rows fully outside the pattern get output 0."""
    T, block_q, block_k = _blocks_for(q, block_q, block_k)
    return compile_pattern(rows, cols, T, block_q, block_k, q.device)(q, k,
                                                                       v)


def block_sparse_attention_plain(q, k, v, rows, cols, block_q: int = 512,
                                 block_k: int = 512):
    """``block_sparse_attention`` through the plain versions on any
    device: the reference a caller holds the kernels to, differentiable
    the same way."""
    T, block_q, block_k = _blocks_for(q, block_q, block_k)
    return compile_pattern(rows, cols, T, block_q, block_k,
                           q.device).plain(q, k, v)

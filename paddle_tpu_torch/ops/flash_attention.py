"""Flash attention — the port of ``paddle_tpu/ops/flash_attention.py``.

``flash_attention_raw(q, k, v, causal, sm_scale)`` on the [B, L, H, D]
layout, differentiable through ``_FlashAttention`` (the counterpart of the
JAX package's ``_flash_fwd_bwd`` custom_vjp). Dispatch follows the
tensors' device and nothing else:

* CPU tensors take the plain PyTorch versions below,
  ``flash_attention_reference`` (what kernel K1 computes) and
  ``flash_attention_bwd_reference`` (what K2 computes);
* CUDA tensors launch the hand-written Hopper kernels of
  ``csrc/flash_attention.cu``, built with nvcc at first use by
  ``_build.py``, or raise. bf16 runs on the Hopper tile core of
  ``csrc/hopper_attention.cuh``: ``flash_fwd`` (wgmma products over K/V
  tiles that TMA streams into a two-stage ring) and ``flash_bwd`` (one
  kernel doing the five products of each (key tile, query tile) pair on
  wgmma, dq summed in an f32 accumulator by TMA reduce-adds, with a
  preparation and a conversion kernel in the same launch call); f32 runs
  on CUDA cores (``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``).
  Nothing sends a CUDA tensor elsewhere: the JAX package's
  ``L % 128 or S % 128`` gate and its D padding have no counterpart — the
  kernels take any L and S and D in ``SUPPORTED_HEAD_DIMS`` natively.

Both compute the Pallas kernels' function: the bottom-right causal mask
(row r of L sees column c of S when c <= r + S − L), f32 scores times the
scale, probabilities kept in f32 for p·v (the Pallas kernel widens V to
f32), a row with no visible column giving 0 and lse = −inf, lse [B, H, L]
in f32. ``_fa_reference`` is the JAX package's XLA fallback, which rounds
the probabilities to the input dtype; ``masked_softmax`` is its softmax.

Tolerances of the kernels against the plain versions on the card (the
plain version itself is exact f32 arithmetic on the same inputs), per row:
``tolerance(ref, dtype)`` bounds each row of an output [B, *, H, D] (out
and dq per query row, dk and dv per key) by the tolerance times that row's
max|ref| plus ``ROW_FLOOR`` of the tensor's max|ref|. A per-tensor bound
would be set by the few rows that see one key (out[0] is v[0], of order
4) and would pass a wrong tile count for the bulk of rows, whose outputs
average thousands of keys and are of order 0.03.

* f32 (products in f32 on CUDA cores): summation order only (≈1e-6
  relative) — ``F32_TOL`` = 1e-4;
* bf16: the kernel rounds p (forward, and dv) and ds (dq, dk) to bf16 as
  tensor-core operands (≤ 2^-9 relative per term, averaging out over a
  row's terms) and each side rounds its output to bf16: two roundings of
  nearly equal values differ by at most one ulp, ≤ 2^-7 of the row's max
  — ``BF16_TOL`` = 2^-6, a 2× margin over that one ulp. The bf16
  backward sums dq in f32 across blocks, in an order that changes from
  run to run: dq's bits do, its bound does not (summation order moves it
  by ≈ 1e-6 relative);
* lse is f32 on both sides, held to ``LSE_TOL`` (absolute).
"""
from __future__ import annotations

import collections
import ctypes
import math

import numpy as np
import torch

__all__ = ["flash_attention_raw", "flash_attention_reference",
           "flash_attention_bwd_reference", "masked_softmax",
           "flash_attention_plain", "flash_forward", "flash_backward",
           "tolerance", "LAUNCHES", "F32_TOL", "BF16_TOL", "LSE_TOL",
           "ROW_FLOOR", "SUPPORTED_HEAD_DIMS"]

# kernel launches by kernel name; chip_smoke.py zeroes it before the main
# path and reads it after
LAUNCHES: collections.Counter = collections.Counter()

F32_TOL = 1e-4        # × the row's scale, see ``tolerance``
BF16_TOL = 2.0 ** -6  # × the row's scale
ROW_FLOOR = 2.0 ** -8  # share of the tensor's max|ref| in every row's scale
LSE_TOL = 1e-3        # absolute, on lse of order log(S)

SUPPORTED_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _scale(D: int, sm_scale) -> float:
    """The softmax scale as the f32 value the JAX package multiplies by
    (a Python float 1/sqrt(D) or ``sm_scale``, rounded once to f32)."""
    s = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    return float(np.float32(s))


def tolerance(ref, dtype):
    """Bound on |kernel − plain| for each element of an output [B, *, H,
    D] of K1 or K2, broadcastable against it: the dtype's tolerance times
    (max|ref| over the element's row + ROW_FLOOR × max|ref| over the
    tensor). See the module docstring."""
    r = ref.detach().to(torch.float32).abs()
    rel = F32_TOL if dtype == torch.float32 else BF16_TOL
    return rel * (r.amax(-1, keepdim=True) + ROW_FLOOR * r.max())


def _causal_mask(L: int, S: int, device) -> torch.Tensor:
    """[L, S] bool: row r sees column c when c <= r + S − L."""
    return torch.ones((L, S), dtype=torch.bool, device=device).tril(S - L)


def masked_softmax(logits, mask):
    """Softmax along the last axis where fully masked rows get all-zero
    probabilities instead of softmax(−inf row) = nan."""
    neg = torch.tensor(-math.inf, dtype=logits.dtype, device=logits.device)
    m = torch.where(mask, logits, neg).amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    return p / p.sum(-1, keepdim=True).clamp_min(1e-30)


def _fa_reference(q, k, v, causal):
    """The JAX package's XLA fallback: f32 logits, (masked) softmax, the
    probabilities rounded to the input dtype before the V product."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("blhd,bshd->bhls", q, k).to(torch.float32) * scale
    if causal:
        mask = _causal_mask(logits.shape[-2], logits.shape[-1], q.device)
        probs = masked_softmax(logits, mask).to(q.dtype)
    else:
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhls,bshd->blhd", probs, v)


def _scores(q, k, causal, scale):
    """f32 scores [B, H, L, S] times the scale, masked with −inf."""
    s = torch.einsum("blhd,bshd->bhls", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q.device)
        s = s.masked_fill(~mask, -math.inf)
    return s


def flash_attention_reference(q, k, v, causal, sm_scale=None):
    """The plain PyTorch version of K1: (out [B, L, H, D] in q.dtype,
    lse [B, H, L] f32)."""
    scale = _scale(q.shape[-1], sm_scale)
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)                         # masked entries: exp(−inf)=0
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhls,bshd->bhld", p, v.to(torch.float32)) / denom
    m_raw = s.amax(dim=-1, keepdim=True)
    lse = (m_raw + torch.log(denom))[..., 0]     # −inf for an empty row
    return o.permute(0, 2, 1, 3).to(q.dtype), lse


def flash_attention_bwd_reference(q, k, v, out, lse, dout, causal,
                                  sm_scale=None):
    """The plain PyTorch version of K2: (dq, dk, dv), each in its input's
    dtype, from the saved out and lse, all arithmetic in f32."""
    scale = _scale(q.shape[-1], sm_scale)
    f32 = torch.float32
    dof = dout.to(f32)
    delta = (dof * out.to(f32)).sum(-1).permute(0, 2, 1)[..., None]
    s = _scores(q, k, causal, scale)
    safe_lse = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    p = torch.exp(s - safe_lse[..., None])
    dp = torch.einsum("blhd,bshd->bhls", dof, v.to(f32))
    ds = p * (dp - delta)
    dq = torch.einsum("bhls,bshd->blhd", ds, k.to(f32)) * scale
    dk = torch.einsum("bhls,blhd->bshd", ds, q.to(f32)) * scale
    dv = torch.einsum("bhls,blhd->bshd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels
def _check(name, t, dtype, device):
    if t.device != device:
        raise ValueError(f"flash attention: {name} on {t.device}, q on "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"flash attention: {name} is {t.dtype}, q is {dtype}")
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"flash attention: {name} needs a contiguous last "
                         f"dim, strides in multiples of {vec} elements and "
                         f"a 16-byte aligned start (strides {t.stride()})")


def _check_tma(name, t):
    """The bf16 kernels read q, k, v (and the backward dout) through TMA
    tensor maps: on
    top of ``_check``'s 16-byte multiples and alignment, the map needs
    each dim of extent > 1 to step by a positive stride below 2^40
    bytes."""
    for size, stride in zip(t.shape[:3], t.stride()[:3]):
        if size > 1 and not 0 < stride * t.element_size() < 2 ** 40:
            raise ValueError(f"flash attention: {name} strides "
                             f"{t.stride()} cannot be a TMA map's (each "
                             "dim of extent > 1 needs a stride in (0, "
                             "2^40) bytes)")


def _validate(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (want "
                         "[B, L, H, D] and k, v [B, S, H, D])")
    B, L, H, D = q.shape
    if k.shape[0] != B or k.shape[2] != H or k.shape[3] != D:
        raise ValueError(f"flash attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on B, H or D")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {D} not in "
                         f"{SUPPORTED_HEAD_DIMS} on a CUDA tensor")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention: dtype {q.dtype} not in "
                        f"{list(_DTYPE_CODE)}")
    if min(B, L, H, k.shape[1]) == 0:
        raise ValueError("flash attention: empty input")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype, q.device)


def _strides(**tensors):
    """The C side's 24 element strides: (batch, seq, head) of q, k, v,
    out, dout, dq, dk, dv in that order, 0 for tensors a kernel lacks
    (lse and delta are contiguous [B, H, L] and pass none)."""
    vals = []
    for name in ("q", "k", "v", "out", "dout", "dq", "dk", "dv"):
        t = tensors.get(name)
        vals += list(t.stride()[:3]) if t is not None else [0, 0, 0]
    return (ctypes.c_longlong * 24)(*vals)


def _run(name, causal, scale, **tensors):
    """Launch kernel ``name`` on the current stream with the data pointers
    of ``tensors`` (in the C signature's order), raise on a launch error,
    and count the launch."""
    from . import _build
    q, S = tensors["q"], tensors["k"].shape[1]
    B, L, H, D = q.shape
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name + "_launch")(
            *(t.data_ptr() for t in tensors.values()), _DTYPE_CODE[q.dtype],
            B, L, S, H, D, int(causal), ctypes.c_float(scale),
            _strides(**tensors), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} "
                           f"({_build.error_string(err)})")
    LAUNCHES[name] += 1


def _flash_fwd(q, k, v, causal, scale):
    """Launch flash_fwd: (out like q, lse [B, H, L] f32)."""
    _validate(q, k, v)
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_tma(name, t)
    B, L, H, _ = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    _run("flash_fwd", causal, scale, q=q, k=k, v=v, out=out, lse=lse)
    return out, lse


def _bwd_delta(out, dout):
    """delta = rowsum(dout·out) in f32 as [B, H, L] for the f32 kernels,
    computed outside them as the JAX package computes it with jnp outside
    its two Pallas calls (the bf16 launch computes it in its preparation
    kernel)."""
    return (dout.to(torch.float32) * out.to(torch.float32)).sum(-1) \
        .transpose(1, 2).contiguous()


def _validate_bwd(q, k, v, dout, lse, delta):
    """What both backwards take; ``delta`` None for the bf16 one, which
    computes it."""
    _validate(q, k, v)
    _check("dout", dout, q.dtype, q.device)
    B, L, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t is None:
            continue
        if t.shape != (B, H, L) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash attention backward: {name} must be f32 "
                             f"[B, H, L] contiguous on {q.device}")
    if dout.shape != q.shape:
        raise ValueError("flash attention backward: dout must be like q")


def _bwd_dq(q, k, v, dout, lse, delta, causal, scale):
    """Launch flash_bwd_dq (f32): dq like q."""
    _validate_bwd(q, k, v, dout, lse, delta)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _run("flash_bwd_dq", causal, scale, q=q, k=k, v=v, dout=dout, lse=lse,
         delta=delta, dq=dq)
    return dq


def _bwd_dkv(q, k, v, dout, lse, delta, causal, scale):
    """Launch flash_bwd_dkv (f32): (dk like k, dv like v)."""
    _validate_bwd(q, k, v, dout, lse, delta)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _run("flash_bwd_dkv", causal, scale, q=q, k=k, v=v, dout=dout, lse=lse,
         delta=delta, dk=dk, dv=dv)
    return dk, dv


def _bwd_bf16(q, k, v, out, lse, dout, causal, scale):
    """Launch flash_bwd (bf16): (dq like q, dk like k, dv like v). Its f32
    scratch comes from here: lse·log2(e) and delta [B, H, Lp] (Lp = L
    rounded up to a whole 64-row tile) and the dq accumulator [B, L, H,
    D]; the launch's preparation kernel fills them, so none is zeroed
    here."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_bwd takes bf16, not {q.dtype} (f32 runs "
                         "flash_bwd_dq and flash_bwd_dkv)")
    _validate_bwd(q, k, v, dout, lse, None)
    _check("out", out, q.dtype, q.device)
    if out.shape != q.shape:
        raise ValueError("flash attention backward: out must be like q")
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        _check_tma(name, t)
    B, L, H, D = q.shape
    Lp = -(-L // 64) * 64
    f32 = dict(dtype=torch.float32, device=q.device)
    lse2 = torch.empty((B, H, Lp), **f32)
    delta = torch.empty((B, H, Lp), **f32)
    dq_acc = torch.empty((B, L, H, D), **f32)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _run("flash_bwd", causal, scale, q=q, k=k, v=v, out=out, dout=dout,
         lse=lse, lse2=lse2, delta=delta, dq_acc=dq_acc, dq=dq, dk=dk,
         dv=dv)
    return dq, dk, dv


def _flash_bwd(q, k, v, out, lse, dout, causal, scale):
    """(dq, dk, dv): flash_bwd in bf16; in f32 delta, then flash_bwd_dq
    and flash_bwd_dkv."""
    dout = dout.contiguous()
    if q.dtype == torch.bfloat16:
        return _bwd_bf16(q, k, v, out, lse, dout, causal, scale)
    delta = _bwd_delta(out, dout)
    dq = _bwd_dq(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = _bwd_dkv(q, k, v, dout, lse, delta, causal, scale)
    return dq, dk, dv


def flash_forward(q, k, v, causal=False, sm_scale=None):
    """(out, lse) of K1: the plain version on CPU tensors, the kernel on
    CUDA tensors."""
    scale = _scale(q.shape[-1], sm_scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {q.device}")
    return _flash_fwd(q, k, v, causal, scale)


def flash_backward(q, k, v, out, lse, dout, causal=False, sm_scale=None):
    """(dq, dk, dv) of K2: the plain version on CPU tensors, the kernels
    on CUDA tensors."""
    scale = _scale(q.shape[-1], sm_scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, dout, causal,
                                             scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {q.device}")
    return _flash_bwd(q, k, v, out, lse, dout, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v) through ``fwd`` (→ out, lse); saves q, k,
    v, out and lse, and its backward runs ``bwd`` from them (the JAX
    package's ``_flash_fwd_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, fwd, bwd):
        out, lse = fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale, ctx.bwd = causal, sm_scale, bwd
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, out, lse, dout, ctx.causal,
                             ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def flash_attention_raw(q, k, v, causal: bool = False, sm_scale=None):
    """Flash attention on [B, L, H, D] q and [B, S, H, D] k, v → [B, L, H,
    D] in q.dtype, differentiable in q, k and v. CPU tensors run the plain
    versions; CUDA tensors run the kernels or raise."""
    return _FlashAttention.apply(q, k, v, bool(causal), sm_scale,
                                 flash_forward, flash_backward)


def flash_attention_plain(q, k, v, causal: bool = False, sm_scale=None):
    """``flash_attention_raw`` through the plain versions on any device:
    the reference a caller holds the kernels to, differentiable the same
    way (K2's plain version in the backward)."""
    return _FlashAttention.apply(q, k, v, bool(causal), sm_scale,
                                 flash_attention_reference,
                                 flash_attention_bwd_reference)

"""Ragged paged attention — the port of ``paddle_tpu/ops/ragged_attention.py``.

``ragged_paged_attention`` reads each slot's live pages of a shared KV pool
through its block table. One function serves decode rows (``q_len = 1``),
ragged causal prefill rows and suffix rows (``kv_len > q_len > 1``).

Dispatch follows the tensors' device and nothing else:

* CPU tensors take ``ragged_paged_attention_reference``, the plain PyTorch
  version below;
* CUDA tensors launch the hand-written Hopper kernel
  ``csrc/ragged_paged_attention.cu`` (built with nvcc at first use by
  ``_build.py``), or raise. Nothing sends a CUDA tensor elsewhere.

Both compute the function ``_kernel_body`` of the TPU kernel computes, with
one deliberate difference for non-finite pool contents: V rows at or past
``kv_len`` are zeroed (the TPU kernel zeroes only rows past the live
pages), so a NaN in the dead tail of a live page cannot reach the output.
For finite pools the two are the same function. A query row whose mask is
empty (only possible when ``q_len > kv_len``, which no caller produces)
gives zeros.

Numerics of the kernel against the plain version: the plain version, like
the TPU kernel, normalises the softmax in f32 and rounds the probabilities
to the pool dtype before the V product; the kernel keeps an online softmax
in f32 and never rounds the probabilities. In f32 they differ by
summation order only. In bf16 each rounded probability is off by at most
2^-9 relative, which moves the output by at most 2^-9·max|V| (the
probabilities sum to 1), and each side rounds its output to bf16 (half an
ulp, 2^-9 relative, each): hence ``BF16_TOL_PER_MAX_V = 2^-7`` below, a
bound on ``max|kernel − plain| / max|V|`` with room for f32 noise.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ..models.llama import f32_scale

__all__ = ["ragged_paged_attention", "ragged_paged_attention_reference",
           "LAUNCHES", "F32_TOL", "BF16_TOL_PER_MAX_V", "SUPPORTED_HEAD_DIMS"]

# kernel launches by wrapper name; chip_smoke.py zeroes it before the main
# path and reads it after
LAUNCHES: collections.Counter = collections.Counter()

# |kernel − plain| bounds (see the module docstring): f32 differs by
# summation order (inputs of order 1); bf16 by probability and output
# rounding, relative to max|V|
F32_TOL = 1e-4
BF16_TOL_PER_MAX_V = 2.0 ** -7

SUPPORTED_HEAD_DIMS = (16, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ragged_paged_attention_reference(q, k_pool, v_pool, block_table, q_lens,
                                     kv_lens, *, page_size: int):
    """The plain PyTorch version: gather every block-table page, f32 logits
    times 1/sqrt(hd), the mask ``col < kv_len & col <= kv_len − q_len +
    qpos`` filled with -1e30 over the full static width, f32 softmax cast
    to the pool dtype, V rows at or past ``kv_len`` zeroed, f32
    accumulation. Rows are grouped ``qpos*groups + gi`` as in the TPU
    kernel, so a GQA group shares one kv head."""
    B, q_max, H, hd = q.shape
    _, ps, KV, _ = k_pool.shape
    if ps != page_size:
        raise ValueError(f"pool page size {ps} != page_size {page_size}")
    groups = H // KV
    span = q_max * groups
    R = block_table.shape[1] * ps
    bt = block_table.long()
    kc = k_pool[bt].reshape(B, R, KV, hd)
    vc = v_pool[bt].reshape(B, R, KV, hd)
    qh = q.reshape(B, q_max, KV, groups, hd).permute(0, 2, 1, 3, 4) \
        .reshape(B, KV, span, hd)
    logits = torch.einsum("bksd,brkd->bksr", qh.to(torch.float32),
                          kc.to(torch.float32)) * f32_scale(hd)
    dev = q.device
    cols = torch.arange(R, device=dev)
    qpos = torch.arange(span, device=dev) // groups
    kv_len = kv_lens.to(dev).long()[:, None, None, None]
    q_len = q_lens.to(dev).long()[:, None, None, None]
    live = cols[None, None, None, :] < kv_len                   # [B,1,1,R]
    valid = live & (cols[None, None, None, :]
                    <= kv_len - q_len + qpos[None, None, :, None])
    logits = logits.masked_fill(~valid, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v_pool.dtype)
    vz = vc.masked_fill(~live[:, 0, 0, :, None, None], 0)
    out = torch.einsum("bksr,brkd->bksd", probs.to(torch.float32),
                       vz.to(torch.float32))
    keep = valid.any(dim=-1, keepdim=True) & (q_len > 0)        # [B,KV,S,1]
    out = out.masked_fill(~keep, 0).to(q.dtype)
    return out.reshape(B, KV, q_max, groups, hd).permute(0, 2, 1, 3, 4) \
        .reshape(B, q_max, H, hd)


def ragged_paged_attention(q, k_pool, v_pool, block_table, q_lens, kv_lens,
                           *, page_size: int, k_scale=None, v_scale=None):
    """Ragged paged attention over a shared page pool.

    q           [B, Qmax, H, hd] — slot b's rows [0, q_lens[b]) are queries
                at absolute positions kv_lens[b] − q_lens[b] + r.
    k/v_pool    [num_pages, page_size, KV, hd] — the paged KV pool.
    block_table [B, Pmax] int32 — logical → physical page map per slot.
    q_lens      [B] int32 — 0 skips the slot (its output is zeros).
    kv_lens     [B] int32 — live context rows (attend rows < kv_lens[b]).

    Returns [B, Qmax, H, hd] in q.dtype. CPU tensors run the plain
    version; CUDA tensors run the kernel or raise."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "quantized KV pools (k_scale/v_scale) need kernel K4, "
            "ops/ragged_attention.py::_kernel_body_quant of the JAX "
            "package, which is not ported yet")
    tensors = (q, k_pool, v_pool, block_table, q_lens, kv_lens)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"ragged_paged_attention: tensors on several "
                         f"devices {sorted(map(str, devices))}")
    dev = q.device
    if dev.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pool, v_pool, block_table, q_lens, kv_lens,
            page_size=page_size)
    if dev.type != "cuda":
        raise ValueError(f"ragged_paged_attention: unsupported device {dev}")
    return _launch(q, k_pool, v_pool, block_table, q_lens, kv_lens,
                   int(page_size))


def _launch(q, k_pool, v_pool, block_table, q_lens, kv_lens, page_size):
    """Validate what the kernel takes, allocate the output, launch on the
    current stream and raise on a launch error."""
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"ragged_paged_attention: q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)}")
    B, q_max, H, hd = q.shape
    _, ps, KV, hd_p = k_pool.shape
    if ps != page_size:
        raise ValueError(f"pool page size {ps} != page_size {page_size}")
    if hd_p != hd or hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} (pool {hd_p}) not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if KV < 1 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q/pools must share one dtype in "
                        f"{list(_DTYPE_CODE)}; got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or q_lens.shape != (B,) or kv_lens.shape != (B,):
        raise ValueError("block_table must be [B, Pmax], q_lens/kv_lens [B]")
    for name, t in (("block_table", block_table), ("q_lens", q_lens),
                    ("kv_lens", kv_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("q_lens", q_lens),
                    ("kv_lens", kv_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:       # the kernel's vector loads
            raise ValueError(f"{name} must be 16-byte aligned")
    if B == 0 or q_max == 0:
        return torch.empty_like(q)

    from . import _build
    lib = _build.load("ragged_paged_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rpa_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), q_lens.data_ptr(), kv_lens.data_ptr(),
            out.data_ptr(), _DTYPE_CODE[q.dtype],
            B, q_max, H, KV, hd, ps, block_table.shape[1],
            *q.stride()[:3], *k_pool.stride()[:3], *out.stride()[:3],
            block_table.stride(0), ctypes.c_float(f32_scale(hd)), stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: "
                           f"cudaError {err} ({_build.error_string(err)})")
    LAUNCHES["ragged_paged_attention"] += 1
    return out

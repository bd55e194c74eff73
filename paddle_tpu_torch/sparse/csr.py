"""Sparse-masked attention — the port of ``paddle_tpu/sparse/csr.py``'s
``fused_attention`` (reference phi/kernels/sparse/fused_attention_kernel.h).

The mask is one of PyTorch's own sparse tensors, CSR
(``torch.sparse_csr_tensor``) or COO (``torch.sparse_coo_tensor``), [T, T];
only its pattern is read, its values are ignored, as in the JAX package.
Without an additive mask the pattern is compiled once into the
block-sparse kernels' arrays (``ops/block_sparse_attention``) and memoized
on the mask object; with ``key_padding_mask`` or ``attn_mask`` the JAX
package lowers to dense masked softmax, and so does the port, in plain
PyTorch (no kernel runs there in the JAX package either).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.block_sparse_attention import compile_pattern
from ..ops.flash_attention import _scale

__all__ = ["fused_attention"]


def _coo_parts(x):
    """(rows, cols) int64 of a sparse CSR or COO tensor's pattern, on its
    device (duplicate COO entries are merged)."""
    if x.layout == torch.sparse_csr:
        crows = x.crow_indices()
        rows = torch.repeat_interleave(
            torch.arange(crows.numel() - 1, device=crows.device),
            crows.diff())
        return rows, x.col_indices().to(torch.int64)
    if x.layout == torch.sparse_coo:
        idx = x.coalesce().indices()
        return idx[0], idx[1]
    raise TypeError(f"fused_attention: sparse_mask must be a sparse CSR or "
                    f"COO tensor, got layout {x.layout}")


def _block_geometry(T, block_size):
    """(T_eff, block): the tile the pattern is compiled at and T padded to
    a multiple of it when no tile divides T."""
    if block_size:
        # a user tile is rounded up to a multiple of 8, as the JAX package
        # rounds it for the TPU's sublanes
        block_size = max(8, -(-int(block_size) // 8) * 8)
        bs = block_size if T % block_size == 0 else None
    else:
        # the largest multiple of 8 that divides T, up to 512
        bs = next((b for b in range(min(512, T) & ~7, 7, -8)
                   if T % b == 0), None)
    if bs is not None:
        return T, bs
    # pad-to-tile: pattern entries never touch the padded rows and keys,
    # so padded keys are masked and padded rows give 0, sliced away
    bs = block_size if block_size else 128
    return -(-T // bs) * bs, bs


def fused_attention(query, key, value, sparse_mask, key_padding_mask=None,
                    attn_mask=None, block_size=None):
    """Sparse-masked attention: softmax over the scores kept by
    ``sparse_mask``'s pattern, the rest masked out.

    query/key/value: [B, H, T, D] on one device; sparse_mask: a sparse
    [T, T] tensor whose pattern selects the attendable pairs. Rows absent
    from the pattern give 0. Without additive masks this runs the
    block-sparse kernels (K5 forward, K6 backward) on CUDA tensors and
    their plain versions on CPU tensors, with no [T, T] intermediate."""
    q, k, v = query, key, value
    T = sparse_mask.shape[0]
    if key_padding_mask is None and attn_mask is None:
        T_eff, bs = _block_geometry(T, block_size)
        # the compiled pattern is memoized on the mask object, so a caller
        # that holds a mask across steps pays the O(nnz) host read and
        # hash once
        memo = getattr(sparse_mask, "_bsa_fn_memo", None)
        if memo is not None and memo[0] == (T_eff, bs) \
                and memo[1].device == q.device:
            fn = memo[1]
        else:
            rows, cols = _coo_parts(sparse_mask)
            fn = compile_pattern(rows, cols, T_eff, bs, bs, device=q.device)
            sparse_mask._bsa_fn_memo = ((T_eff, bs), fn)
        pad = T_eff - T
        if pad:
            q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        out = fn(q.transpose(1, 2), k.transpose(1, 2),
                 v.transpose(1, 2)).transpose(1, 2)
        return out[:, :, :T] if pad else out
    rows, cols = (x.to(q.device) for x in _coo_parts(sparse_mask))
    pattern = torch.zeros((T, T), dtype=torch.bool, device=q.device)
    pattern[rows, cols] = True
    logits = torch.einsum("bhtd,bhsd->bhts", q.to(torch.float32),
                          k.to(torch.float32)) * _scale(q.shape[-1], None)
    logits = logits.masked_fill(~pattern, -1e30)
    if key_padding_mask is not None:
        logits = logits + key_padding_mask[:, None, None, :].to(
            device=q.device, dtype=torch.float32)
    if attn_mask is not None:
        logits = logits + attn_mask[None, None].to(device=q.device,
                                                   dtype=torch.float32)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    # rows absent from the pattern attend to nothing → output 0, as on the
    # block-sparse path (a −1e30 row would soften to a uniform softmax)
    row_any = torch.zeros((T,), dtype=torch.bool, device=q.device)
    row_any[rows] = True
    probs = probs.masked_fill(~row_any[None, None, :, None], 0)
    return torch.einsum("bhts,bhsd->bhtd", probs, v)

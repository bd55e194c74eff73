"""Sparse tensors and sparse-masked attention — the port of
``paddle_tpu.sparse``'s attention path: ``fused_attention`` on PyTorch's
own sparse CSR and COO tensors. The rest of ``paddle_tpu.sparse`` (coalesce,
masked_matmul, maxpool, mask_as, ``CsrTensor``'s surface, the value-wise
ops) runs no kernel and waits for the framework's ``Tensor``."""
from __future__ import annotations

import torch

from .._device import resolve_device
from .csr import fused_attention

__all__ = ["sparse_coo_tensor", "sparse_csr_tensor", "fused_attention"]


def sparse_coo_tensor(indices, values, shape=None, dtype=None,
                      device="cuda"):
    """A torch sparse COO tensor on ``device`` (duplicates kept, as the
    JAX package's BCOO keeps them); ``shape`` defaults to one past the
    largest index of each dimension."""
    dev = resolve_device(device)
    idx = torch.as_tensor(indices, dtype=torch.int64, device=dev)
    val = torch.as_tensor(values, dtype=dtype, device=dev)
    if shape is None:
        shape = tuple(int(m) + 1 for m in idx.amax(1))
    return torch.sparse_coo_tensor(idx, val, tuple(shape),
                                   check_invariants=False)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None, device="cuda"):
    """A torch sparse CSR tensor on ``device`` from its compressed rows,
    columns and values."""
    dev = resolve_device(device)
    return torch.sparse_csr_tensor(
        torch.as_tensor(crows, dtype=torch.int64, device=dev),
        torch.as_tensor(cols, dtype=torch.int64, device=dev),
        torch.as_tensor(values, dtype=dtype, device=dev), tuple(shape),
        check_invariants=False)

"""Weight-only int8 quantization — the port of ``QuantizedWeight``,
``weight_only_quantize`` and ``weight_only_dequantize`` of
``paddle_tpu/quantization/__init__.py`` (the observers and fake quanters
wait for ROADMAP Queue 1 item 9).

``weight_only_quantize`` follows the JAX function as the serving engine
runs it, eagerly in its constructor: every step in the weight's own dtype
(absmax over every axis but the last, ``max(absmax, 1e-8) / qmax``,
``round(v / scale)`` half to even, clip, the int8 cast), the scale kept in
the weight's dtype with the reduced axes as size-1 dims. So the int8
values and scales equal the JAX package's bit for bit in f32 and bf16
(pinned by ``tests/test_torch_quant.py``), and dequantization,
``int8.to(orig) * scale`` in the original dtype, gives the same weights.

A layer-stacked weight ``[L, ...]`` shares one scale per output channel
across its layers, as in the JAX package. ``QuantizedWeight`` indexes like
the tensor it stands for (``w[l]`` is layer l's int8 matrix beside the
shared scale, ``w[:n]`` the first n layers), so ``layer_slice`` and the
draft's truncation work on a quantized tree unchanged, and the serving
functions dequantize one layer's weights just before they use them
(``dequant=weight_only_dequantize``).
"""
from __future__ import annotations

import torch

__all__ = ["QuantizedWeight", "weight_only_quantize",
           "weight_only_dequantize", "tree_nbytes"]


class QuantizedWeight:
    """int8 weight + per-output-channel scale (weight-only quantization).
    ``scale`` has the weight's rank, size 1 on every axis but the last,
    in ``orig_dtype``."""

    def __init__(self, int8: torch.Tensor, scale: torch.Tensor, orig_dtype):
        self.int8 = int8
        self.scale = scale
        self.orig_dtype = orig_dtype

    def dequantize(self) -> torch.Tensor:
        return self.int8.to(self.orig_dtype) * self.scale

    def __getitem__(self, idx):
        """The weight indexed along its leading axis: an int drops that
        axis from the scale too (its size-1 dim), a slice keeps it."""
        sidx = 0 if isinstance(idx, int) else slice(None)
        return QuantizedWeight(self.int8[idx], self.scale[sidx],
                               self.orig_dtype)

    @property
    def nbytes(self) -> int:
        return self.int8.nbytes + self.scale.nbytes


def weight_only_quantize(params: dict, bits: int = 8,
                         min_elems: int = 1024) -> dict:
    """Quantize every float matrix (ndim >= 2, >= ``min_elems`` elements)
    of a params dict to int8 + per-output-channel (last dim) scales; other
    entries pass through."""
    qmax = 2.0 ** (bits - 1) - 1

    def q(v):
        if not isinstance(v, torch.Tensor) or v.ndim < 2 \
                or v.numel() < min_elems or not v.is_floating_point():
            return v
        with torch.no_grad():
            absmax = v.abs().amax(dim=tuple(range(v.ndim - 1)), keepdim=True)
            floor = torch.tensor(1e-8, dtype=v.dtype, device=v.device)
            scale = torch.maximum(absmax, floor) / qmax
            int8 = torch.round(v / scale).clamp(-qmax, qmax).to(torch.int8)
        return QuantizedWeight(int8, scale.to(v.dtype), v.dtype)

    return {k: q(v) for k, v in params.items()}


def weight_only_dequantize(params: dict) -> dict:
    """Inverse: ``QuantizedWeight`` entries of a params dict (the whole
    tree, one layer's slice, or the embeddings and head) become dense
    tensors in their original dtype; other entries pass through."""
    return {k: v.dequantize() if isinstance(v, QuantizedWeight) else v
            for k, v in params.items()}


def tree_nbytes(params: dict) -> int:
    """Device bytes a params dict holds (int8 payloads and scales for the
    quantized entries)."""
    return sum(v.nbytes for v in params.values())

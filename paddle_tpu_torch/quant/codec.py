"""Block-wise quantization codecs — the port of ``paddle_tpu/quant/codec.py``.

Two symmetric codecs with one f32 scale per block, the block being the
LAST axis of whatever the caller hands in (the KV pages quantize per
(row, kv head), the ``head_dim`` vector as the block):

  * ``int8`` — round half to even onto the [-127, 127] integer grid,
    ``scale = absmax / 127``, payload ``torch.int8``;
  * ``fp8``  — saturating cast onto float8 e4m3 (±448 finite range),
    ``scale = absmax / 448``, payload ``torch.float8_e4m3fn``. The cast
    clips BEFORE converting, as the reference does: out-of-range values
    saturate and never turn into NaN.

The order of operations is the reference's — absmax, then
``max(absmax, floor) / qmax``, then ``x / scale`` — with the division by
the constant ``qmax`` done as XLA compiles it inside the JAX package's
jitted serving burst: a multiply by the f32 reciprocal ``1/qmax``. (Run
eagerly, the JAX function divides, and many scales then lie one f32 ulp
away.) So the payloads and scales equal those the JAX
engine's compiled codec writes, bit for bit (``torch.round`` and
``jnp.round`` both round half to even; the clipped cast to
``float8_e4m3fn`` rounds to nearest even on both sides; pinned by
``tests/test_torch_quant.py``). An all-zero block quantizes to zeros: the
scale floor keeps ``0 / scale`` finite.
"""
from __future__ import annotations

import torch

__all__ = ["MODES", "SCALE_DTYPE", "SCALE_GRANS", "wire_dtype",
           "wire_itemsize", "scale_itemsize", "quantize_lastdim",
           "dequantize_lastdim", "normalize_kv_dtype",
           "normalize_scale_gran"]

# mode -> (payload dtype, qmax = largest magnitude on the grid)
MODES = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}
# 1/qmax rounded once to f32 (the double 1/qmax rounds to the same f32 as
# the f32 quotient 1/qmax for both modes)
_RECIP = {mode: 1.0 / qmax for mode, (_, qmax) in MODES.items()}

_SCALE_FLOOR = 1e-30

SCALE_DTYPE = torch.float32

# kv_dtype spellings that mean "pages in the model dtype"
_KV_DTYPE_OFF = ("", "0", "off", "bf16", "bfloat16", "native")


def normalize_kv_dtype(raw) -> str | None:
    """The parser of the ``kv_dtype`` knob: None for every "unquantized"
    spelling, the codec mode for int8/fp8, ValueError for anything else —
    a typo must not silently serve full precision."""
    v = (raw or "").strip().lower()
    if v in _KV_DTYPE_OFF:
        return None
    if v not in MODES:
        raise ValueError(f"unknown kv_dtype {v!r} "
                         "(int8 | fp8 | bf16/'' for unquantized)")
    return v


# scale granularities of the page-transfer wire: "row" ships the pool's
# per-(row, head) scales, "page" one scale per (page, head)
SCALE_GRANS = ("row", "page")


def normalize_scale_gran(raw) -> str:
    """The parser of the KV scale-granularity knob: ''/None mean "row";
    anything else must name a granularity."""
    v = (raw or "").strip().lower()
    if not v:
        return "row"
    if v not in SCALE_GRANS:
        raise ValueError(f"unknown KV scale granularity {v!r} "
                         f"(one of {SCALE_GRANS})")
    return v


def wire_dtype(mode: str) -> torch.dtype:
    """The payload dtype that is stored (and would travel) for ``mode``."""
    return MODES[mode][0]


def wire_itemsize(mode: str) -> int:
    return torch.empty((), dtype=MODES[mode][0]).element_size()


def scale_itemsize() -> int:
    return torch.empty((), dtype=SCALE_DTYPE).element_size()


def quantize_lastdim(x: torch.Tensor, mode: str):
    """Quantize ``x`` with the LAST axis as the block.

    Returns ``(payload, scale)``: payload has x's shape in the mode's
    payload dtype, scale has shape ``x.shape[:-1]`` in float32, with
    ``scale = max(absmax, floor) · f32(1/qmax)`` so ``payload * scale ≈
    x``."""
    dt, qmax = MODES[mode]
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    scale = absmax.clamp_min(_SCALE_FLOOR) * _RECIP[mode]
    scaled = xf / scale[..., None]
    if mode == "int8":
        q = torch.round(scaled).clamp(-qmax, qmax).to(dt)
    else:
        q = scaled.clamp(-qmax, qmax).to(dt)
    return q, scale.to(SCALE_DTYPE)


def dequantize_lastdim(payload: torch.Tensor, scale: torch.Tensor,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_lastdim`: ``payload * scale`` in f32,
    rounded to ``out_dtype`` last."""
    return (payload.to(torch.float32)
            * scale.to(torch.float32)[..., None]).to(out_dtype)

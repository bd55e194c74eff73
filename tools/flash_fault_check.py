#!/usr/bin/env python3
"""Planted-fault check of the flash kernels' bounds, on one GPU.

    python3 tools/flash_fault_check.py

Through ``tools/fault_check.py``: plants one fault at a time in a
temporary copy of ``ops/csrc/flash_attention.cu`` (never in the
checkout), builds it with nvcc, and runs the three
flash kernels at the training path's shape (B=1, L=S=2048, H=32, D=128,
causal; N(0,1) inputs from a seeded numpy generator; f32 and bf16)
against their plain versions, as phase 6 of ``chip_smoke.py`` does. For
every output it prints max|kernel − plain|, that error's share of the
per-row bound ``flash_attention.tolerance`` that phase 6 applies, and its
share of a per-tensor bound (the same tolerance times the tensor's
max|ref|), to show what a per-tensor bound lets through. The copies:

* ``none``     — the kernels as they are; must pass;
* ``fwd_tile`` — flash_fwd drops the last visible kv tile of every q tile
  that starts at or past L/2, in the bf16 kernel on the Hopper tile core
  (``flash_fwd_kernel``) and in the f32 one (``flash_fwd_f32_kernel``);
* ``dq_tile``  — flash_bwd_dq drops the same tile;
* ``dkv_tile`` — flash_bwd_dkv drops its last q tile for every kv tile
  that starts at or past S/2.

Exits 0 when the unmutated kernels pass the per-row bound in both dtypes
and every planted fault fails it in both by at least
``fault_check.CATCH_FACTOR``.
"""
from __future__ import annotations

import sys

import numpy as np

import fault_check
from fault_check import Fault

SEED = 7
SHAPE = (1, 2048, 2048, 32, 128)          # B, L, S, H, D
TILES = "  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;"
TILES_CUT = ("  const int n_tiles = (kv_end > 0 ? (kv_end + kBK - 1) / kBK"
             " : 0) - (q0 >= p.L / 2);")
# the bf16 forward's tile count (flash_fwd_kernel, the Hopper tile core)
KV_TILES = "  const int n_kv = kv_end > 0 ? (kv_end + kTile - 1) / kTile : 0;"
KV_TILES_CUT = ("  const int n_kv = (kv_end > 0 ? (kv_end + kTile - 1) / kTile"
                " : 0) - (q0 >= p.L / 2);")
# (source text, replacement, which occurrence: TILES is 0 in the f32
# forward, 1 in dq)
FAULTS = {
    "none": None,
    "fwd_tile": Fault(sites=((KV_TILES, KV_TILES_CUT, 0),
                             (TILES, TILES_CUT, 0))),
    "dq_tile": (TILES, TILES_CUT, 1),
    "dkv_tile": ("  for (int qt = qt0; qt < n_qt; ++qt) {",
                 "  for (int qt = qt0; qt < n_qt - (k0 >= p.S / 2); ++qt) {",
                 0),
}


def measure(device="cuda"):
    """The kernels of the package beside this script's parent directory
    against their plain versions: {dtype: {output: [max_abs_err, share of
    the per-row bound, share of a per-tensor bound]}}."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    B, L, S, H, D = SHAPE
    rng = np.random.default_rng(SEED)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32))
                       .to(device, dtype)
                       for s in ((B, L, H, D), (B, S, H, D), (B, S, H, D),
                                 (B, L, H, D)))
        out, lse = fa.flash_forward(q, k, v, True)
        ref, ref_lse = fa.flash_attention_reference(q, k, v, True)
        got = {"out": out, "lse": lse[..., None],
               **dict(zip(("dq", "dk", "dv"), fa.flash_backward(
                   q, k, v, ref, ref_lse, do, True)))}
        want = {"out": ref, "lse": ref_lse[..., None],
                **dict(zip(("dq", "dk", "dv"),
                           fa.flash_attention_bwd_reference(
                               q, k, v, ref, ref_lse, do, True)))}
        if device == "cuda":
            torch.cuda.synchronize()
        rows = {}
        for name, g in got.items():
            r = want[name].float()
            diff = (g.float() - r).abs()
            err = float(diff.max())
            if name == "lse":                 # absolute bound, no rows
                rows[name] = [err, err / fa.LSE_TOL, "absolute"]
                continue
            tol = fa.tolerance(r, dtype)
            rel = fa.F32_TOL if dtype == torch.float32 else fa.BF16_TOL
            ten = err / (rel * float(r.abs().max()))
            rows[name] = [err, float(torch.nan_to_num(diff / tol,
                                                      nan=0.0).max()),
                          f"{ten:.3f} of a per-tensor bound"]
        result[str(dtype)[6:]] = rows
    return result


if __name__ == "__main__":
    sys.exit(fault_check.main(__file__, "flash_attention.cu", FAULTS,
                              measure))

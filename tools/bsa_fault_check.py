#!/usr/bin/env python3
"""Planted-fault check of the block-sparse kernels' bounds, on one GPU.

    python3 tools/bsa_fault_check.py

Through ``tools/fault_check.py``: plants one fault at a time in a
temporary copy of ``ops/csrc/block_sparse_attention.cu`` (never in the
checkout), builds it with nvcc, and runs the three block-sparse kernels
against their plain versions, as phase 8 of ``chip_smoke.py`` does, on two
patterns (a band of ±9 over 16-blocks at T=1024, and a Longformer window
of ±128 with 32 global tokens over 256-blocks at T=2048; B=1, H=4,
D=128; N(0,1) inputs from a seeded numpy generator; f32 and bf16). For
every output it prints max|kernel − plain| and that error's share of the
per-row bound ``block_sparse_attention.tolerance`` (lse: of ``LSE_TOL``).
The backward kernels take the plain forward's out and lse, so a forward
fault shows in out and lse alone. The copies:

* ``none``          — the kernels as they are; must pass;
* ``mixed_as_full`` — every mixed tile read as full (the mask ignored);
* ``last_k_tile``   — bsa_fwd skips the last active k tile of each q tile;
* ``dkv_q_tile``    — bsa_bwd_dkv skips the last active q tile of each k
  tile;
* ``ds_unscaled``   — ds without the scale (dq and dk).

Exits 0 when the unmodified kernels pass in both dtypes and every planted
fault fails the bound in some case of both.
"""
from __future__ import annotations

import sys

import numpy as np

import fault_check

SEED = 7
B, H, D = 1, 4, 128
FAULTS = {
    "none": None,
    "mixed_as_full": (
        "  return slot < 0 ? ~0ull : bits[(long long)slot * kTile + row];",
        "  return ~0ull;", 0),
    "last_k_tile": ("  const int a_end = ptr[qt + 1];",
                    "  const int a_end = ptr[qt + 1] - (ptr[qt + 1] > "
                    "ptr[qt]);", 0),
    "dkv_q_tile": ("  const int a_end = ptr[kt + 1];",
                   "  const int a_end = ptr[kt + 1] - (ptr[kt + 1] > "
                   "ptr[kt]);", 0),
    "ds_unscaled": ("  return pr * (dp - delta) * scale;",
                    "  return pr * (dp - delta);", 0),
}


def _patterns():
    """(label, T, rows, cols, block)."""
    from chip_smoke import band, longformer_pattern
    return [("band T=1024", 1024, *band(1024, 9), 16),
            ("longformer T=2048", 2048, *longformer_pattern(2048, 128, 32),
             256)]


def measure(device="cuda"):
    """The kernels of the package beside this script's parent directory
    against their plain versions: {dtype: {case output: [max_abs_err,
    share of the bound, note]}}."""
    import torch
    from paddle_tpu_torch.ops import block_sparse_attention as bsa
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        rows = {}
        for label, T, r, c, block in _patterns():
            pat = bsa.compile_pattern(r, c, T, block, block, device)
            q, k, v, do = (torch.from_numpy(rng.standard_normal(
                (B, T, H, D), np.float32)).to(device, dtype)
                for _ in range(4))
            out, lse = bsa.bsa_forward(q, k, v, pat)
            ref, ref_lse = bsa.bsa_fwd_reference(q, k, v, pat.block_map,
                                                 pat.masks, block, block)
            got = {"out": out, "lse": lse,
                   **dict(zip(("dq", "dk", "dv"), bsa.bsa_backward(
                       q, k, v, ref, ref_lse, do, pat)))}
            want = {"out": ref, "lse": ref_lse,
                    **dict(zip(("dq", "dk", "dv"), bsa.bsa_bwd_reference(
                        q, k, v, ref, ref_lse, do, pat.block_map, pat.masks,
                        block, block)))}
            if device == "cuda":
                torch.cuda.synchronize()
            for name, g in got.items():
                w = want[name].float()
                diff = (g.float() - w).abs()
                if name == "lse":      # absolute bound where finite
                    diff = torch.nan_to_num(diff, nan=0.0)
                    err = float(diff.max())
                    rows[f"{label} lse"] = [err, err / bsa.LSE_TOL,
                                            "absolute"]
                    continue
                share = float(torch.nan_to_num(
                    diff / bsa.tolerance(w, dtype), nan=0.0).max())
                rows[f"{label} {name}"] = [float(diff.max()), share, ""]
        result[str(dtype)[6:]] = rows
    return result


if __name__ == "__main__":
    sys.exit(fault_check.main(__file__, "block_sparse_attention.cu", FAULTS,
                              measure))

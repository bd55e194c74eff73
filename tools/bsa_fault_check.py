#!/usr/bin/env python3
"""Planted-fault check of the block-sparse kernels' bounds, on one GPU.

    python3 tools/bsa_fault_check.py

Through ``tools/fault_check.py``: plants one fault at a time in a
temporary copy of ``ops/csrc/block_sparse_attention.cu`` (never in the
checkout), builds it with nvcc, and runs the block-sparse kernels against
their plain versions, as phase 8 of ``chip_smoke.py`` does, on three
patterns (a band of ±9 over 16-blocks at T=1024; a Longformer window of
±128 with 32 global tokens over 256-blocks at T=2048; a band of ±12 at
T=256 whose rows from 100 and keys from 60 are outside the pattern, so
that the 128-key block from key 128 has an empty list; B=1, H=4, D=128;
N(0,1) inputs from a seeded numpy generator; f32 and bf16), with the
allocator's free memory poisoned with NaN before each kernel call
(``chip_smoke.poison_cache``), so that an output left unwritten fails.
For every output it prints max|kernel − plain| and that error's share of
the per-row bound ``block_sparse_attention.tolerance`` (lse: of
``LSE_TOL``; a non-finite output counts as failing). The backward
kernels take the plain forward's out and lse, so a forward fault shows in
out and lse alone. The copies:

* ``none``              — the kernels as they are; must pass;
* ``ds_unscaled``       — ds without the scale (``ds_of``, which the f32
  and bf16 backwards share); must fail dq or dk in both dtypes;
* ``bwd_last_dq``       — ``bsa_bwd_kernel`` drops the dq reduce-add of
  its list's last q tile; must fail bf16 dq;
* ``bwd_mixed_as_full`` — ``bsa_bwd_kernel``'s transposed test reads
  every mixed tile as full; must fail bf16 dk and dv;
* ``order_skip``        — the heaviest-first order of ``bsa_fwd_kernel``
  and ``bsa_bwd_kernel`` skips its first block (and runs the second
  twice); must fail bf16 out and dq;
* ``empty_no_store``    — a ``bsa_bwd_kernel`` block with an empty list
  skips its dk = dv = 0 store; must fail bf16 dk and dv of the pattern
  with keys outside;
* ``fwd_mixed_as_full`` — ``bsa_fwd_kernel`` reads every mixed tile as
  full; must fail bf16 out;
* ``mixed_as_full``     — the f32 kernels read every mixed tile as full;
* ``last_k_tile``       — the f32 bsa_fwd skips the last active k tile of
  each q tile;
* ``dkv_q_tile``        — the f32 bsa_bwd_dkv skips the last active q
  tile of each k tile.

Exits 0 when the unmodified kernels pass in both dtypes and every planted
fault fails the bound, in the dtypes and outputs it names, by at least
``fault_check.CATCH_FACTOR``.
"""
from __future__ import annotations

import sys

import numpy as np

import fault_check
from fault_check import Fault

SEED = 7
B, H, D = 1, 4, 128
# bsa_bwd_kernel's sites
DQ_REDUCE = ("      if (threadIdx.x % kWG == 0) {\n"
             "        tma_reduce_add_4d(&tdq")
BWD_VIS = ("        const bool vis = slot < 0 || "
           "((cW[qc] >> kbit[x >> 1]) & 1ull);")
BWD_ORDER = "  const int kb = order[blockIdx.y];"
BWD_ACC = "  float dk_acc[D / 2], dv_acc[D / 2];"
# bsa_fwd_kernel's
FWD_ORDER = "  const int blk = order[blockIdx.y];"
FWD_MASKED = "    st.softmax(sc, scale_log2, slot >= 0,"
SKIP_FIRST = "[blockIdx.y + (blockIdx.y == 0)];"
FAULTS = {
    "none": None,
    "ds_unscaled": Fault(sites=(("  return pr * (dp - delta) * scale;",
                                 "  return pr * (dp - delta);", 0),),
                         cases=("dq", "dk")),
    "bwd_last_dq": Fault(sites=((DQ_REDUCE, DQ_REDUCE.replace(
        "== 0) {", "== 0 && i + 1 < n) {"), 0),),
                         must_fail=("bfloat16",), cases=("dq",)),
    "bwd_mixed_as_full": Fault(sites=((BWD_VIS, BWD_VIS.split("||")[0]
                                       + "|| true;", 0),),
                               must_fail=("bfloat16",), cases=("dk", "dv"),
                               every_case=True),
    "order_skip": Fault(sites=((FWD_ORDER, FWD_ORDER.replace(
        "[blockIdx.y];", SKIP_FIRST), 0), (BWD_ORDER, BWD_ORDER.replace(
            "[blockIdx.y];", SKIP_FIRST), 0)),
                        must_fail=("bfloat16",), cases=("out", "dq"),
                        every_case=True),
    "empty_no_store": Fault(sites=((BWD_ACC, "  if (n == 0) return;\n"
                                    + BWD_ACC, 0),),
                            must_fail=("bfloat16",),
                            cases=("T=256 dk", "T=256 dv"),
                            every_case=True),
    "fwd_mixed_as_full": Fault(sites=((FWD_MASKED, FWD_MASKED.replace(
        "slot >= 0,", "false,"), 0),), must_fail=("bfloat16",),
                               cases=("out",)),
    "mixed_as_full": Fault(sites=((
        "  return slot < 0 ? ~0ull : bits[(long long)slot * kTile + row];",
        "  return ~0ull;", 0),), must_fail=("float32",)),
    "last_k_tile": Fault(sites=(("  const int a_end = ptr[qt + 1];",
                                 "  const int a_end = ptr[qt + 1] - "
                                 "(ptr[qt + 1] > ptr[qt]);", 0),),
                         must_fail=("float32",), cases=("out",)),
    "dkv_q_tile": Fault(sites=(("  const int a_end = ptr[kt + 1];",
                                "  const int a_end = ptr[kt + 1] - "
                                "(ptr[kt + 1] > ptr[kt]);", 0),),
                        must_fail=("float32",), cases=("dk", "dv")),
}


def _patterns():
    """(label, T, rows, cols, block)."""
    from chip_smoke import band, longformer_pattern
    r, c = band(256, 12)
    keep = (r < 100) & (c < 60)
    return [("band T=1024", 1024, *band(1024, 9), 16),
            ("longformer T=2048", 2048, *longformer_pattern(2048, 128, 32),
             256),
            ("unattended T=256", 256, r[keep], c[keep], 32)]


def _share(got, want, tol):
    """(max |got − want|, its largest share of ``tol``): 0 where both
    agree exactly (lse's −inf rows), NaN where got is NaN."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ratio = torch.where(g == w, torch.zeros_like(diff), diff / tol)
    return float(diff.nan_to_num(nan=float("inf")).max()), \
        float(ratio.max())


def measure(device="cuda"):
    """The kernels of the package beside this script's parent directory
    against their plain versions: {dtype: {case output: [max_abs_err,
    share of the bound, note]}}."""
    import torch
    from chip_smoke import poison_cache
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
            poison_cache(device)
            out, lse = bsa.bsa_forward(q, k, v, pat)
            ref, ref_lse = bsa.bsa_fwd_reference(q, k, v, pat.block_map,
                                                 pat.masks, block, block)
            poison_cache(device)
            grads = bsa.bsa_backward(q, k, v, ref, ref_lse, do, pat)
            got = {"out": out, "lse": lse,
                   **dict(zip(("dq", "dk", "dv"), grads))}
            want = {"out": ref, "lse": ref_lse,
                    **dict(zip(("dq", "dk", "dv"), bsa.bsa_bwd_reference(
                        q, k, v, ref, ref_lse, do, pat.block_map, pat.masks,
                        block, block)))}
            if device == "cuda":
                torch.cuda.synchronize()
            for name, g in got.items():
                w = want[name].float()
                if name == "lse":      # absolute bound where finite
                    err, share = _share(g, w, bsa.LSE_TOL)
                    rows[f"{label} lse"] = [err, share, "absolute"]
                    continue
                err, share = _share(g, w, bsa.tolerance(w, dtype))
                rows[f"{label} {name}"] = [err, share, ""]
        result[str(dtype)[6:]] = rows
    return result


if __name__ == "__main__":
    sys.exit(fault_check.main(__file__, "block_sparse_attention.cu", FAULTS,
                              measure))

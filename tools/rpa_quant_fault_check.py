#!/usr/bin/env python3
"""Planted-fault check of the quantized ragged kernel's bound (K4), on one
GPU.

    python3 tools/rpa_quant_fault_check.py

Through ``tools/fault_check.py``: plants one fault at a time in a
temporary copy of ``ops/csrc/ragged_paged_attention.cu`` (never in the
checkout), builds it with nvcc, and holds K4 against its plain version as
phase 3 of ``chip_smoke.py`` does: int8 and fp8 pools, f32 and bf16
models, decode and ragged prefill rows, groups 1 and 4, head_dim 128,
page size 16, dead rows poisoned. For every case it prints max|kernel −
plain| and that error's share of the bound ``ragged_attention.tolerance``
(per row in f32, per element in bf16). The copies:

* ``none``       — the kernel as it is; must pass;
* ``row0_scale`` — every row of a page is dequantized with the scale of
  the page's row 0;
* ``last_page``  — each slot's last live page is skipped.

Exits 0 when the unmutated kernel passes the bound in every case and each
planted fault fails it in some case of every (codec, dtype).
"""
from __future__ import annotations

import sys

import fault_check

SEED = 11
SCALE_ROW = ("          const long long soff = page * p.s_sp + "
             "(j % p.ps) * p.s_sr + kvh;")
LIMIT = "      l = min(l, p.max_pages * p.ps);  // never read past the table row"
FAULTS = {
    "none": None,
    "row0_scale": (SCALE_ROW,
                   "          const long long soff = page * p.s_sp + kvh;",
                   0),
    "last_page": (LIMIT, LIMIT + "\n      l = min(l, (kv_len - 1) / p.ps * "
                  "p.ps);", 0),
}


def measure(device="cuda"):
    """K4 of the package beside this script's parent directory against
    its plain version: {"codec dtype": {"kind groups=g": [max_abs_err,
    share of the bound, note]}}; a non-finite output counts as an
    infinite share."""
    import numpy as np
    import torch
    import chip_smoke as cs
    rng = np.random.default_rng(SEED)
    ps, hd, max_pages = 16, 128, 64
    result = {}
    for groups, H, KV in ((1, 32, 32), (4, 32, 8)):
        for mode in ("int8", "fp8"):
            for dtype in (torch.float32, torch.bfloat16):
                kinds = {"decode": ([1] * 4, rng.integers(1, 1025, 4)),
                         "prefill": ([512, 300, 0, 37], [512, 300, 77, 37])}
                for kind, (ql, kl) in kinds.items():
                    args = cs.make_case(rng, ql, kl, H, KV, hd, ps,
                                        max_pages, dtype, device)
                    out, _, err, share = cs.k4_compare(
                        cs.quantize_case(args, mode), ps)
                    finite = bool(torch.isfinite(out).all())
                    group = result.setdefault(f"{mode} {str(dtype)[6:]}", {})
                    group[f"{kind} groups={groups}"] = [
                        err, share if finite else float("inf"),
                        "" if finite else "output not finite"]
    return result


if __name__ == "__main__":
    sys.exit(fault_check.main(__file__, "ragged_paged_attention.cu", FAULTS,
                              measure))

#!/usr/bin/env python3
"""Where K2's bf16 backward spends its time, on one GPU.

    python3 tools/flash_bwd_variants.py

Plants one variant at a time in a temporary copy of
``ops/csrc/flash_attention.cu`` (never in the checkout), as
``tools/fault_check.py`` plants faults, builds each copy with nvcc, and
times the whole ``flash_attention._flash_bwd`` call (preparation,
``flash_bwd_kernel``, conversion) at the training path's shape (B=1,
L=S=2048, H=32, D=128, bf16, causal and not) with ``chip_smoke.time_ms``
(CUDA events, median of 30 after 5 warm-ups). The variants compute wrong
gradients on purpose; only their times mean anything:

* ``base``      — the kernel as it is (timed first and last);
* ``exp2f``     — P by exp2f instead of ex2.approx.ftz;
* ``no_exp``    — P without its exponential (the FMA only);
* ``no_SdP``    — without the Sᵀ and dPᵀ products;
* ``no_dVdK``   — without the dV and dK products;
* ``no_dq``     — without dQ_partial (its products, staging, reduce-adds);
* ``no_kernel`` — the preparation and conversion kernels alone.

Prints one line per run and one JSON object {variant: {causal: ms}}.
"""
from __future__ import annotations

import json
import os
import sys

import fault_check

EXP = "vis ? ex2_ftz(fmaf(s[4 * j + e], scale_log2, -cLse[qc])) : 0.f;"
S_DP = ("      wgmma_ss_n64(s, desc_kmajor(myK, kk), desc_kmajor(cQ, kk), "
        "kk > 0);",
        "      wgmma_ss_n64(dp, desc_kmajor(myV, kk), desc_kmajor(cDO, kk), "
        "kk > 0);")
DV_DK = ("      wgmma_rs<D>(dv_acc, pa[kk], desc_mnmajor(cDO, kk));",
         "      wgmma_rs<D>(dk_acc, da[kk], desc_mnmajor(cQ, kk));")
DQ_HALF0 = ("      wgmma_ss_n64_mnb(dq, desc_kmajor(myDS, kk), "
            "desc_mnmajor(myK, kk),")
DQ_LOOP = "    for (int c = 0; c < D / 64; ++c) {\n      if (c > 0)"
LAUNCH = "  flash_bwd_kernel<D><<<dim3("
VARIANTS = {
    "base": None,
    "exp2f": (EXP, EXP.replace("ex2_ftz", "exp2f"), 0),
    "no_exp": (EXP, "vis ? fmaf(s[4 * j + e], scale_log2, -cLse[qc]) : 0.f;",
               0),
    "no_SdP": fault_check.Fault(sites=tuple((t, "      ;", 0)
                                            for t in S_DP)),
    "no_dVdK": fault_check.Fault(sites=tuple((t, "      ;", 0)
                                             for t in DV_DK)),
    "no_dq": fault_check.Fault(sites=(
        (DQ_HALF0, "      if (kk < 0) wgmma_ss_n64_mnb(dq, "
         "desc_kmajor(myDS, kk), desc_mnmajor(myK, kk),", 0),
        (DQ_LOOP, "    for (int c = 0; c < 0; ++c) {\n      if (c > 0)",
         0))),
    "no_kernel": (LAUNCH, "  if (p.B < 0) flash_bwd_kernel<D><<<dim3(", 0),
}
SHAPE = (1, 2048, 2048, 32, 128)       # B, L, S, H, D


def measure():
    """{causal: ms} of ``_flash_bwd`` for the package beside this script's
    parent directory."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.ops import flash_attention as fa
    B, L, S, H, D = SHAPE
    rng = np.random.default_rng(5)
    q, k, v, do = cs.flash_inputs(rng, B, L, S, H, D, torch.bfloat16)
    scale = fa._scale(D, None)
    res = {}
    for causal in (True, False):
        out, lse = fa.flash_forward(q, k, v, causal)
        res[str(causal)] = cs.time_ms(
            lambda: fa._flash_bwd(q, k, v, out, lse, do, causal, scale))
    return res


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if "--measure" in sys.argv[1:]:
        sys.path.insert(0, root)
        print(json.dumps(measure()))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    table = fault_check.time_variants(
        __file__, "flash_attention.cu", VARIANTS,
        [(name, name, ()) for name in [*VARIANTS, "base"]],
        lambda r: f"causal {r['True']:.4f} ms, non-causal "
                  f"{r['False']:.4f} ms")
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())

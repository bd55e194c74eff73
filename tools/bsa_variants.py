#!/usr/bin/env python3
"""Where K5's and K6's bf16 time goes, on one GPU.

    python3 tools/bsa_variants.py

Times ``block_sparse_attention._bsa_fwd`` (K5) and the whole bf16
``_bsa_bwd`` call (K6: preparation, ``bsa_bwd_kernel``, conversion) at
phase 8's shape and pattern (B=1, H=32, T=8192, D=128, the [B, T, H, D]
views of [B, H, T, D] tensors, Longformer ±256 with 64 global tokens,
blocks of 512) with ``chip_smoke.time_ms`` (CUDA events, median of 30
after 5 warm-ups), under variants that compute wrong results on purpose;
only their times mean anything. Two kinds:

* source variants, planted in a temporary copy of
  ``ops/csrc/block_sparse_attention.cu`` (never in the checkout) as
  ``tools/fault_check.py`` plants faults, each copy built with nvcc:
  ``base`` (the kernels as they are, timed first and last), ``no_SdP``
  (``bsa_bwd_kernel`` without its Sᵀ and dPᵀ products), ``no_dVdK``
  (without dV and dK), ``no_dq`` (without dQ_partial: its products,
  staging and reduce-adds), ``no_kernel`` (the preparation and
  conversion kernels alone);
* plan variants, run on the base build with the compiled pattern's pair
  lists changed on the device: ``reversed`` (the blocks with the longest
  lists launched last instead of first) and ``pole_cut`` (every list cut
  to the length of the second-longest, which removes the global tiles'
  long pole: if the time falls by no more than the share of steps it
  removes, the long lists do not bound the launch, and splitting them
  over several blocks cannot pay).

Prints one line per run and one JSON object {variant: [{kernel: ms}]}
with the steps per head of each plan.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import fault_check

SOURCE = "block_sparse_attention.cu"
S_DP = ("      wgmma_ss_n64(s, desc_kmajor(myK, kk), desc_kmajor(cQ, kk), "
        "kk > 0);",
        "      wgmma_ss_n64(dp, desc_kmajor(myV, kk), desc_kmajor(cDO, kk), "
        "kk > 0);")
DV_DK = ("      wgmma_rs<D>(dv_acc, pa[kk], desc_mnmajor(cDO, kk));",
         "      wgmma_rs<D>(dk_acc, da[kk], desc_mnmajor(cQ, kk));")
DQ_HALF0 = ("      wgmma_ss_n64_mnb(dq, desc_kmajor(myDS, kk), "
            "desc_mnmajor(myK, kk),")
DQ_LOOP = "    for (int c = 0; c < D / 64; ++c) {\n      if (c > 0)"
LAUNCH = "  bsa_bwd_kernel<D><<<dim3("
VARIANTS = {
    "base": None,
    "no_SdP": fault_check.Fault(sites=tuple((t, "      ;", 0)
                                            for t in S_DP)),
    "no_dVdK": fault_check.Fault(sites=tuple((t, "      ;", 0)
                                             for t in DV_DK)),
    "no_dq": fault_check.Fault(sites=(
        (DQ_HALF0, "      if (kk < 0) wgmma_ss_n64_mnb(dq, "
         "desc_kmajor(myDS, kk), desc_mnmajor(myK, kk),", 0),
        (DQ_LOOP, "    for (int c = 0; c < 0; ++c) {\n      if (c > 0)",
         0))),
    "no_kernel": (LAUNCH, "  if (p.B < 0) bsa_bwd_kernel<D><<<dim3(", 0),
}
PLAN_VARIANTS = ("reversed", "pole_cut")


def _plan_variant(fn, name):
    """Replace the compiled pattern ``fn``'s device pair lists with those of
    plan variant ``name``; returns the steps per head of each list."""
    import numpy as np
    import torch
    steps = {}
    for kind in ("fwd", "bwd"):
        ptr = getattr(fn.plan, kind + "_ptr")
        ent = getattr(fn.plan, kind + "_ent")
        order = getattr(fn.plan, kind + "_order")
        lens = np.diff(ptr)
        if name == "reversed":
            order = order[::-1].copy()
        elif name == "pole_cut":
            cap = np.sort(lens)[-2] if lens.size > 1 else lens.max()
            keep = np.arange(ent.shape[0]) - np.repeat(ptr[:-1], lens) \
                < np.repeat(np.minimum(lens, cap), lens)
            ent = ent[keep]
            ptr = np.concatenate([[0], np.cumsum(np.minimum(lens, cap))])
        dev = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
               .to(fn.device) for a in (ptr, ent, order)]
        setattr(fn, kind + "_plan", tuple(dev))
        steps[kind] = int(ptr[-1])
    return steps


def measure(plan_variant=None):
    """{kernel: ms} of K5 and K6 for the package beside this script's
    parent directory, under ``plan_variant`` (None: the plan as built)."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.ops import block_sparse_attention as bsa
    from paddle_tpu_torch.ops import flash_attention as fa
    B, H, T, D = cs.BSA_SHAPE
    rows, cols = cs.longformer_pattern(T, *cs.LONGFORMER)
    fn = bsa.compile_pattern(rows, cols, T, 512, 512, "cuda")
    steps = _plan_variant(fn, plan_variant) if plan_variant else {
        k: int(getattr(fn.plan, k + "_ptr")[-1]) for k in ("fwd", "bwd")}
    rng = np.random.default_rng(cs.SEED + 10)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, H, T, D), np.float32)).to("cuda", torch.bfloat16).transpose(1, 2)
        for _ in range(4))
    scale = fa._scale(D, None)
    out, lse = bsa._bsa_fwd(q, k, v, fn, scale)
    return {"K5": cs.time_ms(lambda: bsa._bsa_fwd(q, k, v, fn, scale)),
            "K6": cs.time_ms(lambda: bsa._bsa_bwd(q, k, v, out, lse, do, fn,
                                                  scale)),
            "steps_per_head": steps}


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if "--measure" in sys.argv[1:]:
        sys.path.insert(0, root)
        rest = sys.argv[sys.argv.index("--measure") + 1:]
        print(json.dumps(measure(rest[0] if rest else None)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bsa_variants: no CUDA device", file=sys.stderr)
        return 2
    runs = [(name, name, ()) for name in VARIANTS]
    runs += [(name, "base", (name,)) for name in PLAN_VARIANTS]
    runs.append(("base", "base", ()))
    table = fault_check.time_variants(
        __file__, SOURCE, VARIANTS, runs,
        lambda r: f"K5 {r['K5']:.4f} ms, K6 {r['K6']:.4f} ms, steps per "
                  f"head {r['steps_per_head']}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"card": card, "variants": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Planted-fault check of the flash kernels' bounds, on one GPU.

    python3 tools/flash_fault_check.py

Copies ``paddle_tpu_torch`` into a temporary directory (never into the
checkout), plants one fault at a time in the copy's
``ops/csrc/flash_attention.cu``, builds it with nvcc, and runs the three
flash kernels at the training path's shape (B=1, L=S=2048, H=32, D=128,
causal; N(0,1) inputs from a seeded numpy generator; f32 and bf16)
against their plain versions, as phase 6 of ``chip_smoke.py`` does. For
every output it prints max|kernel − plain|, that error's share of the
per-row bound ``flash_attention.tolerance`` that phase 6 applies, and its
share of a per-tensor bound (the same tolerance times the tensor's
max|ref|), to show what a per-tensor bound lets through. The copies:

* ``none``     — the kernels as they are; must pass;
* ``fwd_tile`` — flash_fwd drops the last visible kv tile of every q tile
  that starts at or past L/2;
* ``dq_tile``  — flash_bwd_dq drops the same tile;
* ``dkv_tile`` — flash_bwd_dkv drops its last q tile for every kv tile
  that starts at or past S/2.

Exits 0 when the unmutated kernels pass the per-row bound in both dtypes
and every planted fault fails it in both.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

SEED = 7
SHAPE = (1, 2048, 2048, 32, 128)          # B, L, S, H, D
TILES = "  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;"
TILES_CUT = ("  const int n_tiles = (kv_end > 0 ? (kv_end + kBK - 1) / kBK"
             " : 0) - (q0 >= p.L / 2);")
# (source text, replacement, which occurrence: 0 in flash_fwd, 1 in dq)
FAULTS = {
    "none": None,
    "fwd_tile": (TILES, TILES_CUT, 0),
    "dq_tile": (TILES, TILES_CUT, 1),
    "dkv_tile": ("  for (int qt = qt0; qt < n_qt; ++qt) {",
                 "  for (int qt = qt0; qt < n_qt - (k0 >= p.S / 2); ++qt) {",
                 0),
}


def measure(device="cuda"):
    """Run the kernels of the package beside this script's parent
    directory against their plain versions; print one JSON line
    {dtype: {output: [max_abs_err, share of the per-row bound, share of
    the per-tensor bound]}}."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
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
                rows[name] = [err, err / fa.LSE_TOL, err / fa.LSE_TOL]
                continue
            tol = fa.tolerance(r, dtype)
            rel = fa.F32_TOL if dtype == torch.float32 else fa.BF16_TOL
            rows[name] = [err, float(torch.nan_to_num(diff / tol,
                                                      nan=0.0).max()),
                          err / (rel * float(r.abs().max()))]
        result[str(dtype)[6:]] = rows
    print(json.dumps(result))
    return 0


def planted_copy(root, fault):
    """A temporary copy of the package (and this script) with ``fault``
    planted in its flash kernel source; returns the copy's directory."""
    tmp = tempfile.mkdtemp(prefix="flash_fault_")
    shutil.copytree(os.path.join(root, "paddle_tpu_torch"),
                    os.path.join(tmp, "paddle_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(tmp, "tools"))
    shutil.copy(os.path.abspath(__file__), os.path.join(tmp, "tools"))
    if fault is not None:
        old, new, which = fault
        src = os.path.join(tmp, "paddle_tpu_torch", "ops", "csrc",
                           "flash_attention.cu")
        text = open(src).read()
        parts = text.split(old)
        if len(parts) < which + 2:
            raise RuntimeError(f"fault site {old!r} not found (occurrence "
                               f"{which})")
        text = old.join(parts[:which + 1]) + new + old.join(parts[which + 1:])
        with open(src, "w") as f:
            f.write(text)
    return tmp


def main():
    import torch
    if not torch.cuda.is_available():
        print("flash_fault_check: no CUDA device", file=sys.stderr)
        return 2
    if "--measure" in sys.argv[1:]:
        return measure()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    verdict = {}
    for name, fault in FAULTS.items():
        tmp = planted_copy(root, fault)
        try:
            proc = subprocess.run(
                [sys.executable, os.path.join(tmp, "tools",
                                              os.path.basename(__file__)),
                 "--measure"], capture_output=True, text=True, timeout=900)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"{name}: the measuring run failed "
                               f"(exit {proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        verdict[name] = {}
        for dtype, rows in res.items():
            fails = [o for o, (_, row, _) in rows.items() if row > 1.0]
            tensor_fails = [o for o, (_, _, ten) in rows.items() if ten > 1.0]
            verdict[name][dtype] = bool(fails)
            print(f"[{name}] {dtype}: " + ", ".join(
                f"{o} err {e:.3e} ({row:.3f} of the per-row bound, "
                f"{ten:.3f} of a per-tensor bound)"
                for o, (e, row, ten) in rows.items()), flush=True)
            print(f"[{name}] {dtype}: fails the per-row bound in "
                  f"{fails or 'nothing'}; a per-tensor bound would fail "
                  f"{tensor_fails or 'nothing'}", flush=True)
    ok = not any(verdict["none"].values()) and all(
        all(v.values()) for n, v in verdict.items() if n != "none")
    print(json.dumps({"ok": ok, "fails_per_row_bound": verdict}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

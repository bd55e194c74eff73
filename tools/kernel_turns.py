#!/usr/bin/env python3
"""K2's bf16 backward, rpa_kernel's decode and K5/K6 (block-sparse
attention) of this tree against another tree's, in turns on one GPU.

    python3 tools/kernel_turns.py OTHER_TREE

OTHER_TREE is an unpacked checkout of another version of the repository
(say ``git archive <commit> | tar -x -C other --exclude=xplane``). The
script runs its measurement four times, each in a process of its own
that imports ``paddle_tpu_torch`` from one tree and builds that tree's
kernels with nvcc: the other tree, this one, this one, the other (so that
the card's drift falls on both alike). Each measurement times, with
``chip_smoke.time_ms`` (CUDA events, median of 30 after 5 warm-ups,
device time only), the calls the training and serving paths make:

* ``flash_attention._flash_bwd`` (K2: dq, dk and dv from out and lse,
  delta and any scratch included) in bf16 at B=1, L=S=2048, H=32, D=128,
  causal and not;
* ``ragged_paged_attention`` at decode (one query row a slot; K3 and K4
  on ``rpa_kernel``) over bf16, int8 and fp8 pages at B 1 and 4 and
  kv_len 128, 1024 and 4096 (H=KV=32, hd 128, page size 16, a table that
  reaches kv_len);
* ``block_sparse_attention._bsa_fwd`` (K5) and the whole bf16
  ``_bsa_bwd`` call (K6: dq, dk and dv from out and lse, delta and any
  scratch included) at ``sparse.fused_attention``'s shape in phase 8
  (B=1, H=32, T=8192, D=128, bf16, the [B, T, H, D] views of [B, H, T,
  D] tensors) under its Longformer pattern (window ±256, 64 global
  tokens, blocks of 512), the pattern compiled once before timing.

The inputs come from ``chip_smoke``'s seeded generators, the same in
every process. It prints one line per case with the four times and the
ratio of the other tree's mean to this one's, then one JSON object.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
BWD_SHAPE = (1, 2048, 2048, 32, 128)   # B, L, S, H, D
DECODE = {"B": (1, 4), "kv_len": (128, 1024, 4096)}
H, KV, HD, PS = 32, 32, 128, 16


def _chip_smoke():
    """This tree's chip_smoke (its generators and timer), by path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(tree):
    """{case: ms} for the kernels of ``tree`` (its paddle_tpu_torch)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import ragged_attention as ra
    assert os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(fa.__file__)))) == os.path.abspath(tree)
    cs = _chip_smoke()
    _build.build_all()
    res = {}
    B, L, S, Hb, D = BWD_SHAPE
    rng = np.random.default_rng(SEED + 5)
    q, k, v, do = cs.flash_inputs(rng, B, L, S, Hb, D, torch.bfloat16)
    scale = fa._scale(D, None)
    for causal in (True, False):
        out, lse = fa.flash_forward(q, k, v, causal)
        res[f"K2 bf16 backward causal={causal}"] = cs.time_ms(
            lambda: fa._flash_bwd(q, k, v, out, lse, do, causal, scale))
    del q, k, v, do, out, lse
    res.update(measure_bsa(cs))
    rng = np.random.default_rng(SEED + 16)
    for B in DECODE["B"]:
        for kv_len in DECODE["kv_len"]:
            args = cs.make_case(rng, [1] * B, [kv_len] * B, H, KV, HD, PS,
                                -(-kv_len // PS), torch.bfloat16)
            for pages in ("bf16", "int8", "fp8"):
                kw = {"page_size": PS}
                case = args
                if pages != "bf16":
                    qa = cs.quantize_case(args, pages)
                    case = qa[:6]
                    kw.update(k_scale=qa[6], v_scale=qa[7])
                res[f"decode {pages} B={B} kv_len={kv_len}"] = cs.time_ms(
                    lambda: ra.ragged_paged_attention(*case, **kw), iters=20)
    return res


def measure_bsa(cs):
    """{case: ms} of K5 and K6 at phase 8's shape and pattern."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import block_sparse_attention as bsa
    from paddle_tpu_torch.ops import flash_attention as fa
    B, H, T, D = cs.BSA_SHAPE
    rows, cols = cs.longformer_pattern(T, *cs.LONGFORMER)
    pattern = bsa.compile_pattern(rows, cols, T, 512, 512, "cuda")
    rng = np.random.default_rng(SEED + 10)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, H, T, D), np.float32)).to("cuda", torch.bfloat16).transpose(1, 2)
        for _ in range(4))
    scale = fa._scale(D, None)
    out, lse = bsa._bsa_fwd(q, k, v, pattern, scale)
    return {
        "K5 bf16 block-sparse forward": cs.time_ms(
            lambda: bsa._bsa_fwd(q, k, v, pattern, scale)),
        "K6 bf16 block-sparse backward": cs.time_ms(
            lambda: bsa._bsa_bwd(q, k, v, out, lse, do, pattern, scale)),
    }


def main():
    if "--measure" in sys.argv[1:]:
        print(json.dumps(measure(sys.argv[-1])))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) != 2 or not os.path.isdir(
            os.path.join(sys.argv[1], "paddle_tpu_torch")):
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    runs = []
    for name, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure", tree],
            capture_output=True, text=True, timeout=1500, cwd=tree)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"measuring {tree} failed "
                               f"(exit {proc.returncode})")
        runs.append((name, json.loads(proc.stdout.strip().splitlines()[-1])))
        print(f"[turn {len(runs)}] {name} tree measured", flush=True)
    table = {}
    for case in runs[0][1]:
        ms = [r[case] for _, r in runs]
        other_ms = (ms[0] + ms[3]) / 2
        this_ms = (ms[1] + ms[2]) / 2
        table[case] = {"other_ms": [ms[0], ms[3]], "this_ms": [ms[1], ms[2]],
                       "other_over_this": other_ms / this_ms}
        print(f"  {case}: other {ms[0]:.4f}, {ms[3]:.4f} ms; this "
              f"{ms[1]:.4f}, {ms[2]:.4f} ms; other / this "
              f"{other_ms / this_ms:.2f}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"card": card, "other": other, "turns": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

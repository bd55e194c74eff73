"""The planted-fault harness of ``tools/*_fault_check.py``, on one GPU.

Each entry script names a kernel source under
``paddle_tpu_torch/ops/csrc/``, a table of faults and a ``measure``
function, and calls ``main``. For each fault, ``main`` copies the package,
``chip_smoke.py`` and ``tools/`` into a temporary directory (never into the
checkout), plants the fault in the copy's source, and runs the copy's entry
script with ``--measure``: the kernels build with nvcc from the copy and
``measure`` holds them against their plain versions, printing one JSON line
``{group: {case: [max_abs_err, share of the kernel's bound, note]}}``. A
case fails when its share exceeds 1 or is not finite. ``main`` exits 0
when the unmodified copy (fault ``"none"``) fails no case and every
planted fault fails some case of every group.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile


def planted_copy(root, source, fault):
    """A temporary copy of the package, chip_smoke.py and tools/ with
    ``fault`` = (text, replacement, occurrence) planted in
    ``paddle_tpu_torch/ops/csrc/<source>``; returns the copy's path."""
    tmp = tempfile.mkdtemp(prefix="fault_check_")
    for name in ("paddle_tpu_torch", "tools"):
        shutil.copytree(os.path.join(root, name), os.path.join(tmp, name),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(root, "chip_smoke.py"), tmp)
    if fault is not None:
        old, new, which = fault
        src = os.path.join(tmp, "paddle_tpu_torch", "ops", "csrc", source)
        with open(src) as f:
            parts = f.read().split(old)
        if len(parts) < which + 2:
            raise RuntimeError(f"fault site {old!r} not found (occurrence "
                               f"{which})")
        with open(src, "w") as f:
            f.write(old.join(parts[:which + 1]) + new
                    + old.join(parts[which + 1:]))
    return tmp


def _fails(share):
    return not (math.isfinite(share) and share <= 1.0)


def main(script, source, faults, measure):
    """Run ``script`` (an entry script's ``__file__``) as set out in the
    module docstring; returns the exit code."""
    import torch
    tool = os.path.basename(script)
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(script)))
    if "--measure" in sys.argv[1:]:
        sys.path.insert(0, root)
        print(json.dumps(measure()))
        return 0
    caught = {}
    for name, fault in faults.items():
        tmp = planted_copy(root, source, fault)
        try:
            proc = subprocess.run(
                [sys.executable, os.path.join(tmp, "tools", tool),
                 "--measure"], capture_output=True, text=True, timeout=900)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"{name}: the measuring run failed "
                               f"(exit {proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        caught[name] = {}
        for group, cases in res.items():
            fails = [c for c, (_, share, _) in cases.items()
                     if _fails(share)]
            caught[name][group] = bool(fails)
            for case, (err, share, note) in cases.items():
                print(f"[{name}] {group} {case}: max_abs_err {err:.3e} "
                      f"({share:.3f} of the bound"
                      f"{', ' + note if note else ''})", flush=True)
            print(f"[{name}] {group}: fails the bound in "
                  f"{fails or 'nothing'}", flush=True)
    ok = not any(caught["none"].values()) and all(
        all(v.values()) for n, v in caught.items() if n != "none")
    print(json.dumps({"ok": ok, "fails_the_bound": caught}))
    return 0 if ok else 1

"""The planted-fault harness of ``tools/*_fault_check.py`` (and, through
``time_variants``, the timing harness of ``tools/*_variants.py``), on one
GPU.

Each entry script names a kernel source under
``paddle_tpu_torch/ops/csrc/``, a table of faults and a ``measure``
function, and calls ``main``. A fault is ``None`` (the unmodified copy),
one site ``(text, replacement, occurrence)``, or a ``Fault`` of several
sites and the groups it must fail. ``main`` first plants every fault in
memory and raises when a site's anchor text is not in the source, so a
stale anchor cannot pass quietly. Then, for each fault, it copies the
package, ``chip_smoke.py`` and ``tools/`` into a temporary directory (never
into the checkout), plants the fault in the copy's source, and runs the
copy's entry script with ``--measure``: the kernels build with nvcc from
the copy and ``measure`` holds them against their plain versions,
printing one JSON line ``{group: {case: [max_abs_err, share of the
kernel's bound, note]}}``. A case fails when its share exceeds 1 or is
not finite. ``main`` exits 0 when the unmodified copy fails no case and
every planted fault fails, in every group it must fail, some case it must
fail (or, with ``every_case``, each of its cases) by at least
``CATCH_FACTOR`` times its bound.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

# a planted fault must exceed its bound this many times over to count
CATCH_FACTOR = 10.0


@dataclasses.dataclass(frozen=True)
class Fault:
    """Sites ``(text, replacement, occurrence)``, planted in order, and the
    groups the fault must fail: those whose name holds one of
    ``must_fail`` (every group when it is empty), each in a case whose
    name holds one of ``cases`` (any case when it is empty) — so that a
    fault meant for one kernel cannot pass on another kernel's cases.
    With ``every_case``, each of ``cases`` must fail in each such group."""
    sites: tuple
    must_fail: tuple = ()
    cases: tuple = ()
    every_case: bool = False


def _as_fault(fault):
    if fault is None or isinstance(fault, Fault):
        return fault
    return Fault(sites=(fault,))


def plant(text, fault):
    """``text`` with every site of ``fault`` planted; raises when a site's
    anchor (at its occurrence) is not found."""
    for old, new, which in _as_fault(fault).sites:
        parts = text.split(old)
        if len(parts) < which + 2:
            raise RuntimeError(f"fault site {old!r} not found (occurrence "
                               f"{which})")
        text = old.join(parts[:which + 1]) + new + old.join(parts[which + 1:])
    return text


def planted_copy(root, source, fault):
    """A temporary copy of the package, chip_smoke.py and tools/ with
    ``fault`` planted in ``paddle_tpu_torch/ops/csrc/<source>``; returns
    the copy's path."""
    tmp = tempfile.mkdtemp(prefix="fault_check_")
    for name in ("paddle_tpu_torch", "tools"):
        shutil.copytree(os.path.join(root, name), os.path.join(tmp, name),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(root, "chip_smoke.py"), tmp)
    if fault is not None:
        src = os.path.join(tmp, "paddle_tpu_torch", "ops", "csrc", source)
        with open(src) as f:
            text = plant(f.read(), fault)
        with open(src, "w") as f:
            f.write(text)
    return tmp


def _fails(share):
    return not (math.isfinite(share) and share <= 1.0)


def _caught(share):
    return not math.isfinite(share) or share >= CATCH_FACTOR


def group_caught(spec, cases):
    """Whether a fault ``spec`` counts as caught in a group whose cases
    measured ``{case: [max_abs_err, share, note]}``: some case it names
    (any case when it names none) fails by at least CATCH_FACTOR, or with
    ``every_case`` each case it names does."""
    hit = [c for c, (_, share, _) in cases.items() if _caught(share)]
    if spec.every_case:
        return all(any(k in c for c in hit) for k in spec.cases)
    return any(not spec.cases or any(k in c for k in spec.cases)
               for c in hit)


def time_variants(script, source, variants, runs, describe):
    """The timing harness of ``tools/*_variants.py``: plants each of
    ``variants`` ({name: fault or None}) in a temporary copy as ``main``
    plants faults (every anchor checked first), builds every copy's
    ``source`` at once, then for each ``(name, copy, args)`` of ``runs``
    runs ``script --measure *args`` in the copy of variant ``copy`` and
    prints ``[name]`` and ``describe(result)``. Returns {name: [result of
    each of its runs]}."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(script)))
    with open(os.path.join(root, "paddle_tpu_torch", "ops", "csrc",
                           source)) as f:
        text = f.read()
    for variant in variants.values():
        if variant is not None:
            plant(text, variant)
    copies = {name: planted_copy(root, source, v)
              for name, v in variants.items()}
    build = ("import sys; sys.path.insert(0, sys.argv[1]); from "
             "paddle_tpu_torch.ops import _build; "
             f"_build.build_all([{os.path.splitext(source)[0]!r}])")
    try:
        procs = [subprocess.Popen([sys.executable, "-c", build, tmp])
                 for tmp in copies.values()]
        if any(p.wait() for p in procs):
            raise RuntimeError("a variant failed to build")
        table = {}
        for name, copy, args in runs:
            proc = subprocess.run(
                [sys.executable, os.path.join(copies[copy], "tools",
                                              os.path.basename(script)),
                 "--measure", *args], capture_output=True, text=True,
                timeout=900)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"{name}: the measuring run failed")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            table.setdefault(name, []).append(res)
            print(f"[{name}] {describe(res)}", flush=True)
    finally:
        for tmp in copies.values():
            shutil.rmtree(tmp, ignore_errors=True)
    return table


def main(script, source, faults, measure):
    """Run ``script`` (an entry script's ``__file__``) as set out in the
    module docstring; returns the exit code."""
    import torch
    tool = os.path.basename(script)
    root = os.path.dirname(os.path.dirname(os.path.abspath(script)))
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device", file=sys.stderr)
        return 2
    if "--measure" in sys.argv[1:]:        # in a copy, fault planted
        sys.path.insert(0, root)
        print(json.dumps(measure()))
        return 0
    with open(os.path.join(root, "paddle_tpu_torch", "ops", "csrc",
                           source)) as f:
        text = f.read()
    for fault in faults.values():           # every anchor, before any build
        if fault is not None:
            plant(text, fault)
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
        spec = _as_fault(fault) or Fault(sites=())
        caught[name] = {}
        for group, cases in res.items():
            worst = max(math.inf if math.isnan(share) else share
                        for _, share, _ in cases.values())
            fails = [c for c, (_, share, _) in cases.items()
                     if _fails(share)]
            if fault is None:
                caught[name][group] = bool(fails)
            elif not spec.must_fail or any(m in group
                                            for m in spec.must_fail):
                caught[name][group] = group_caught(spec, cases)
            for case, (err, share, note) in cases.items():
                print(f"[{name}] {group} {case}: max_abs_err {err:.3e} "
                      f"({share:.3f} of the bound"
                      f"{', ' + note if note else ''})", flush=True)
            print(f"[{name}] {group}: fails the bound in "
                  f"{fails or 'nothing'}; worst {worst:.3f} of the bound",
                  flush=True)
    ok = not any(caught["none"].values()) and all(
        v and all(v.values()) for n, v in caught.items() if n != "none")
    print(json.dumps({"ok": ok, "catch_factor": CATCH_FACTOR,
                      "caught": caught}))
    return 0 if ok else 1

#!/usr/bin/env python3
"""Planted-fault check of phase 9 of ``chip_smoke.py`` (prefix sharing
and speculative decoding on the serving engine), on one GPU.

    python3 tools/serve_fault_check.py

The faults live in the engine's Python modules, not in a kernel source,
so this script carries its own copy-and-plant loop (``fault_check.py``
plants only under ``ops/csrc/``) and reuses its ``Fault``, ``plant`` and
catch rules. It first plants every fault in memory (a stale anchor
raises before anything runs) and builds the kernels once in the
checkout; then, for each fault, it copies the package, ``chip_smoke.py``,
``tools/`` and the built kernels into a temporary directory (never into
the checkout), plants the fault in the copy's module, and runs the copy's
script with ``--measure``: Llama-2-7B at full width and depth, f32,
through ``chip_smoke.fault_legs`` — the prefix traffic with the index and
the speculative traffic with the self-draft and with the 16-layer draft,
each on a NaN-poisoned pool — printing one JSON line ``{run: {check:
[value, share of its bound, note]}}``. A check fails when its share
exceeds 1 or is not finite; an exact check (a count, an invariant, a
bitwise comparison) has share 0 when it holds and inf when it does not.
The copies:

* ``none``             — the engine as it is; must fail no check;
* ``verify_kv_len``    — ``llama_paged_verify`` reads one row past each
  slot's segment (kv_len = start + n_tok + 1): the verify rows see the
  next proposal and, at the segment's end, a row not yet written; must
  fail the f32 self-draft's tokens or acceptance;
* ``cow_skipped``      — the growth sweep copies no shared page, so a
  full-prefix resume rewrites the last prompt row inside the page the
  index shares; must fail the prefix run's check that the system prompt's
  pages stay bitwise as their prefill wrote them (the row holds the same
  K/V up to rounding, so the tokens cannot show it);
* ``rewind_kept``      — a verify's rejected tail keeps its pages; must
  fail the 16-layer draft's rewind check (no slot maps a page past
  pages_for(pos) after a speculative step; the self-draft accepts
  everything and rewinds nothing);
* ``insert_at_admit``  — a prompt's pages enter the index at admission,
  before its prefill ran: the duplicate admitted in the same pass resumes
  on them and copies its tail page unwritten (NaN); must fail the prefix
  run's tokens.

Exits 0 when the unmodified copy passes every check and each planted
fault fails a check it names by at least ``fault_check.CATCH_FACTOR``.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

import fault_check
from fault_check import Fault

PACKAGE = "paddle_tpu_torch"
KERNELS = ("ragged_paged_attention", "flash_attention")
VERIFY_LENS = ("    kv_lens = start32 + lens32\n    positions = "
               "start32[:, None] + torch.arange(\n        Tv,")
COW = ("                    if self._cow_for_burst(b, last_pos):\n"
       "                        continue")
REWIND = "            if len(tbl) > keep:"
MERGE_INSERT = ("            self._prefix_insert(req, slot)\n"
                "        emitted_total += self._drain_burst(")
ADMIT = "            staged.append((req, slot, tlen - matched, matched))"
# {name: None, or (module under the package, Fault)}
FAULTS = {
    "none": None,
    "verify_kv_len": ("models/llama_paged.py", Fault(
        sites=((VERIFY_LENS, VERIFY_LENS.replace("lens32\n", "lens32 + 1\n"),
                0),),
        must_fail=("spec f32 self-draft",), cases=("tokens", "acceptance"))),
    "cow_skipped": ("inference/serving.py", Fault(
        sites=((COW, "                    continue", 0),),
        must_fail=("prefix f32",), cases=("shared pages",))),
    "rewind_kept": ("inference/serving.py", Fault(
        sites=((REWIND, "            if False:", 0),),
        must_fail=("16-layer draft",), cases=("rewind",))),
    "insert_at_admit": ("inference/serving.py", Fault(
        sites=((MERGE_INSERT, "        emitted_total += self._drain_burst(",
                0),
               (ADMIT, "            self._prefix_insert(req, slot)\n" + ADMIT,
                0)),
        must_fail=("prefix f32",), cases=("tokens",))),
}


def measure():
    """Phase 9's fault runs on the package beside this script's parent
    directory: {run: {check: [value, share, note]}}."""
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.models.llama import LlamaConfig, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.llama2_7b()
    params = init_params(cfg, seed=cs.SEED, device="cuda")
    params32 = {k: v.float() for k, v in params.items()}
    del params
    return cs.fault_legs(cfg, params32)


def planted_copy(root, fault):
    """A temporary copy of the package, chip_smoke.py, tools/ and the
    built kernels with ``fault`` = (module, Fault) planted; returns its
    path."""
    tmp = tempfile.mkdtemp(prefix="serve_fault_check_")
    for name in (PACKAGE, "tools"):
        shutil.copytree(os.path.join(root, name), os.path.join(tmp, name),
                        ignore=shutil.ignore_patterns("__pycache__"))
    if os.path.isdir(os.path.join(root, "build")):
        shutil.copytree(os.path.join(root, "build"),
                        os.path.join(tmp, "build"))
    shutil.copy(os.path.join(root, "chip_smoke.py"), tmp)
    if fault is not None:
        path = os.path.join(tmp, PACKAGE, fault[0])
        with open(path) as f:
            text = fault_check.plant(f.read(), fault[1])
        with open(path, "w") as f:
            f.write(text)
    return tmp


def verdict(faults, results):
    """{fault: {run: caught (planted) or failed (unmodified)}} from the
    measured {fault: {run: {check: [value, share, note]}}}."""
    caught = {}
    for name, res in results.items():
        spec = faults[name][1] if faults[name] else None
        caught[name] = {}
        for group, cases in res.items():
            if spec is None:
                caught[name][group] = any(fault_check._fails(share)
                                          for _, share, _ in cases.values())
            elif any(m in group for m in spec.must_fail):
                caught[name][group] = fault_check.group_caught(spec, cases)
    return caught


def main():
    import torch
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if not torch.cuda.is_available():
        print("serve_fault_check.py: no CUDA device", file=sys.stderr)
        return 2
    if "--measure" in sys.argv[1:]:          # in a copy, fault planted
        sys.path.insert(0, root)
        print(json.dumps(measure()))
        return 0
    for fault in FAULTS.values():            # every anchor, before any run
        if fault is not None:
            with open(os.path.join(root, PACKAGE, fault[0])) as f:
                fault_check.plant(f.read(), fault[1])
    sys.path.insert(0, root)
    from paddle_tpu_torch.ops import _build
    _build.build_all(list(KERNELS))
    results = {}
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
        results[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        for group, cases in results[name].items():
            for case, (value, share, note) in cases.items():
                flag = "" if not fault_check._fails(share) else " FAILS"
                print(f"[{name}] {group} {case}: {value} ({share:.3g} of "
                      f"the bound{flag}; {note})", flush=True)
    caught = verdict(FAULTS, results)
    ok = not any(caught["none"].values()) and all(
        v and all(v.values()) for n, v in caught.items() if n != "none")
    print(json.dumps({"ok": ok, "catch_factor": fault_check.CATCH_FACTOR,
                      "caught": caught}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

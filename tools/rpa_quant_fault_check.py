#!/usr/bin/env python3
"""Planted-fault check of the ragged kernels' bounds (K3, K4; both
``rpa_kernel`` and the tile path's ``rpa_tile_kernel``), on one GPU.

    python3 tools/rpa_quant_fault_check.py

Through ``tools/fault_check.py``: plants one fault at a time in a
temporary copy of ``ops/csrc/ragged_paged_attention.cu`` (never in the
checkout), builds it with nvcc, and holds the kernels against their plain
version as phase 3 of ``chip_smoke.py`` does: int8 and fp8 pools (K4) and
bf16 pools (K3), f32 and bf16 models, decode rows (``rpa_kernel``) and
ragged prefill and suffix rows (in bf16 the tile path), groups 1 and 4,
head_dim 128, page size 16, dead rows poisoned; and decode at B=1 and
B=4 with long slots over a 1024-row table, where rpa_kernel splits the
keys (5 chunks of 208 rows at B=4 and groups 1, else 8 of 128, on 132
SMs). For every case it prints
max|kernel − plain| and that error's share of the bound
``ragged_attention.tolerance`` (per row in f32, per element in bf16). The
copies:

* ``none``            — the kernels as they are; must pass;
* ``row0_scale``      — rpa_kernel dequantizes every row of a page with
  the scale of the page's row 0 (must fail every int8/fp8 group);
* ``last_page``       — rpa_kernel skips each slot's last live page (every
  group);
* ``merge_last``      — rpa_kernel's merge of the chunks skips the last
  one (the decode cases of every group);
* ``chunk_gap``       — rpa_kernel leaves one page unread between every two
  chunks, the last of each chunk (the decode cases of every group);
* ``tile_last_page``  — rpa_tile_kernel skips each slot's last live page
  (the prefill or suffix cases of every bf16 group);
* ``tile_last_tile``  — rpa_tile_kernel skips the last key tile of every
  query tile that has more than one (the same);
* ``tile_row0_scale`` — rpa_tile_kernel's staging dequantizes every key
  row of a tile with the scale of the tile's row 0 (the prefill or suffix
  cases of the int8/fp8 bf16 groups).

Exits 0 when the unmutated kernels pass the bound in every case and each
planted fault fails it by at least ``fault_check.CATCH_FACTOR`` in some
case of every group it must fail.
"""
from __future__ import annotations

import sys

import fault_check
from fault_check import Fault

SEED = 11
SCALE_ROW = ("          const long long soff = page * p.s_sp + "
             "(j % p.ps) * p.s_sr + kvh;")
LIMIT = "      l = min(l, p.max_pages * p.ps);  // never read past the table row"
TILE_LIMIT = "    return max(l, 0);"
TILES = "  const int n_kv = (lmax + kTile - 1) / kTile;"
STAGED_SCALE = "        const float scale = sc[which * kTile + r];"
# the cases that run rpa_tile_kernel in a bf16 group (decode runs
# rpa_kernel): a tile fault must fail one of these
TILE_CASES = ("prefill", "suffix")
# rpa_kernel's merge of its chunks, and the end of a chunk
MERGE = "      for (int sp = 0; sp < splits; ++sp) {"
CHUNK_END = "  const int c1 = min(c0 + p.chunk, lmax);"
FAULTS = {
    "none": None,
    "row0_scale": Fault(sites=((SCALE_ROW, "          const long long soff ="
                                " page * p.s_sp + kvh;", 0),),
                        must_fail=("int8", "fp8")),
    "last_page": (LIMIT, LIMIT + "\n      l = min(l, (kv_len - 1) / p.ps * "
                  "p.ps);", 0),
    "merge_last": Fault(sites=((MERGE, MERGE.replace("splits", "splits - 1"),
                                0),), cases=("decode",)),
    "chunk_gap": Fault(sites=((CHUNK_END, CHUNK_END.replace(
        "p.chunk", "p.chunk - p.ps"), 0),), cases=("decode",)),
    "tile_last_page": Fault(sites=((TILE_LIMIT, "    return max(min(l, "
                                    "(kv_len - 1) / p.ps * p.ps), 0);", 0),),
                            must_fail=("bfloat16",), cases=TILE_CASES),
    "tile_last_tile": Fault(sites=((TILES, "  const int n_kv = (lmax + kTile "
                                    "- 1) / kTile - (lmax > kTile);", 0),),
                            must_fail=("bfloat16",), cases=TILE_CASES),
    "tile_row0_scale": Fault(sites=((STAGED_SCALE, "        const float scale"
                                     " = sc[which * kTile];", 0),),
                             must_fail=("int8 pages bfloat16",
                                        "fp8 pages bfloat16"),
                             cases=TILE_CASES),
}


def measure(device="cuda"):
    """The ragged kernels of the package beside this script's parent
    directory against their plain version: {"pages dtype": {"kind
    groups=g": [max_abs_err, share of the bound, note]}}; a non-finite
    output counts as an infinite share."""
    import numpy as np
    import torch
    import chip_smoke as cs
    rng = np.random.default_rng(SEED)
    ps, hd, max_pages = 16, 128, 64
    result = {}
    for groups, H, KV in ((1, 32, 32), (4, 32, 8)):
        for pages in ("bf16", "int8", "fp8"):
            for dtype in (torch.float32, torch.bfloat16):
                if pages == "bf16" and dtype == torch.float32:
                    continue
                kinds = {"decode": ([1] * 4, rng.integers(1, 1025, 4)),
                         "decode split B=1": ([1], [1000]),
                         "decode split B=4": ([1] * 4,
                                              [1024, 1000, 900, 1017]),
                         "prefill": ([512, 300, 0, 37], [512, 300, 77, 37]),
                         "suffix": ([130, 65, 7, 100], [1000, 65, 300, 613])}
                for kind, (ql, kl) in kinds.items():
                    args = cs.make_case(rng, ql, kl, H, KV, hd, ps,
                                        max_pages, dtype, device)
                    scales = ()
                    if pages != "bf16":
                        qa = cs.quantize_case(args, pages)
                        args, scales = qa[:6], qa[6:]
                    out, _, err, share = cs.rpa_compare(args, ps, scales)
                    finite = bool(torch.isfinite(out).all())
                    group = result.setdefault(
                        f"{pages} pages {str(dtype)[6:]}", {})
                    group[f"{kind} groups={groups}"] = [
                        err, share if finite else float("inf"),
                        "" if finite else "output not finite"]
    return result


if __name__ == "__main__":
    sys.exit(fault_check.main(__file__, "ragged_paged_attention.cu", FAULTS,
                              measure))

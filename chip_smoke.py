#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for sm_90a with nvcc) and
exits non-zero, printing no result, without one or outside a checkout of
the repository. Phases, each failing the run when its check fails:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — every kernel source, built with nvcc from the checkout (one
              nvcc per source, started together);
3. kernels  — first the Hopper tile core's launch check: one wgmma tile
              S = Q·Kᵀ and one P·V product against torch.matmul in f32,
              exact on integer inputs; then the ragged paged-attention
              kernel (K3) against its plain PyTorch version on the card:
              decode, ragged prefill, suffix and q_len=0 rows, groups 1
              and 4, f32 and bf16 pools, dead pool rows and the scratch
              page filled with NaN; the quantized kernel (K4) the same way
              over int8 and fp8 pools (head dims 128, 64 and 16), dead
              payload rows poisoned and dead scale rows NaN; then the
              tile path (``rpa_tile_kernel``, which bf16 prefill and
              suffix rows take) over bf16, int8 and fp8 pages at page
              sizes 4, 16, 32 and 64, groups 1 and 4, head dims 128 and 64,
              suffix rows from 2 rows up; every output
              element within its own bound
              (``ragged_attention.tolerance``);
4. serving  — greedy Llama-2-7B (full width, random weights from a seed,
              bf16) through ContinuousBatcher's ragged path: 8 requests, 4
              slots, admissions mid-flight. Checks K3's launch counts
              (rpa_kernel once per layer per decode step, rpa_tile_kernel
              once per layer per prefill-carrying burst), the drained pool, and every emitted token against a
              teacher-forced dense forward of the same weights (bf16, and
              again with the whole engine in f32; the dense forward runs
              the flash kernel K1); profiles one decode burst. Then the
              same 8 requests with int8 and then fp8 pages, sized by
              the bf16 pool's byte budget (``pool_hbm_bytes``): K4's
              launch counts (K3's are 0), the drained pool, every token
              against a teacher-forced dense forward whose K/V pass
              through the same codec (coarse), and the pages the budget
              buys; then the engine in f32 with int8 and fp8 pages, its
              pool read back and held against a dense f32 forward that
              attends over it: every token within 1e-3 of its best logit,
              every pool row and scale at the codec of the forward's own
              K/V (``f32_pool_check``);
5. times    — K3 and K4 (int8 and fp8) at the serving path's decode
              (rpa_kernel) and prefill (rpa_tile_kernel, and rpa_kernel at
              the same shape) shapes beside their byte bounds, their plain
              versions and scaled_dot_product_attention (a yardstick the
              port never calls; for K4 over K/V dequantized beforehand);
              both kernels at suffix rows of 2 to 128 rows, for the
              dispatch's crossover; CUDA events, median of 30 runs after
              warm-up;
6. flash    — the flash kernels (K1 forward; K2 as flash_bwd_dq and
              flash_bwd_dkv) against their plain versions: f32 and bf16,
              causal and not, at the training shape (B=1, L=S=2048, H=32,
              D=128), a ragged length, L<S, L>S and D=64 with a scale,
              each output row within its own bound; then each kernel's
              time at the training shape beside its bound, its plain
              version and SDPA's forward and backward, and K2's two
              kernels together beside the bound of the whole backward;
7. training — Llama-2-7B, bf16, B=1, T=2048, AdamW (lr 3e-4, weight
              decay 0.1, bf16 moments), remat: one full-width layer with
              K1/K2 against the plain versions (its attention output row
              by row, its nine weight gradients), the first loss in bf16
              against f32 weights, five steps with falling finite losses,
              the K1/K2 launch counts the path implies (2, 1 and 1 per
              layer per step), step time, tokens/s, peak memory, and one
              profiled step;
8. sparse   — the block-sparse kernels (K5 ``bsa_fwd``; K6 ``bsa_bwd_dq``
              and ``bsa_bwd_dkv``) against their plain versions on nine
              patterns (partial 16-blocks, tril, duplicates, a fully
              covered block, 70-wide blocks, T=127 padded, a ragged last
              tile, rows and keys outside the pattern, a row masked across
              a whole tile), f32 and bf16, D 128 and 64; then
              ``sparse.fused_attention`` forward and backward at B=1,
              H=32, T=8192, D=128, bf16, under a Longformer mask (window
              ±256, 64 global tokens) as a sparse CSR tensor, twice: 1/1/1
              launches a call, one compile, out/dq/dk/dv row by row
              against the plain versions; and the kernels' times beside
              their bounds, the plain versions and SDPA with the dense
              mask.

The last lines are the kernels' JSON record, the card line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def time_ms(fn, iters=30, warmup=5, device_only=True):
    """Median milliseconds of ``fn`` over ``iters`` runs, each bracketed by
    CUDA events, after ``warmup`` runs.

    ``device_only``: the card first spins on a ~3 ms sleep kernel while the
    host queues ``fn``'s launches behind the start event, so the events
    time the device work alone; without it the bracket also holds any host
    time the launches take beyond the device's (the wrapper's overhead)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(5_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end))
    return statistics.median(runs)


def ptxas_by_kernel(log):
    """(kernel, "Used N registers, ..." line) for each entry function in
    an nvcc -Xptxas -v log; the kernel is the function's name (the
    length-prefixed mangled name that ends in "kernel") and its mangled
    template arguments."""
    import re
    out, kernel = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = kernel = m.group(1)
            for d in re.finditer(r"\d+", fn):   # a hash may run into the
                for i in range(len(d.group())):  # length's digits
                    name = fn[d.end():d.end() + int(d.group()[i:])]
                    if name.endswith("kernel"):
                        rest = fn[d.end() + len(name):]
                        kernel = name + (rest[:rest.find("EEv") + 2]
                                         if rest.startswith("I") else "")
                        break
                if kernel != fn:
                    break
        elif "Used" in ln and "registers" in ln and kernel:
            out.append((kernel, ln.split(":", 1)[-1].strip()))
            kernel = None
    return out


# --------------------------------------------------------------- phase 3
def make_case(rng, q_lens, kv_lens, H, KV, hd, ps, max_pages, dtype,
              device="cuda"):
    """A pool whose live rows are N(0,1) and whose every dead row (the
    tail of each live page, spare pages, the scratch page 0) is NaN, with
    pages scattered by a random permutation through the block table."""
    import torch
    B = len(q_lens)
    need = [-(-int(k) // ps) for k in kv_lens]
    npool = 1 + sum(need) + 2
    phys = rng.permutation(np.arange(1, npool))
    kp = np.full((npool, ps, KV, hd), np.nan, np.float32)
    vp = np.full((npool, ps, KV, hd), np.nan, np.float32)
    bt = np.zeros((B, max_pages), np.int32)
    nxt = 0
    for b in range(B):
        for j in range(need[b]):
            page = phys[nxt]
            nxt += 1
            bt[b, j] = page
            live = min(ps, int(kv_lens[b]) - j * ps)
            kp[page, :live] = rng.standard_normal((live, KV, hd), np.float32)
            vp[page, :live] = rng.standard_normal((live, KV, hd), np.float32)
    q = rng.standard_normal((B, max(1, int(max(q_lens))), H, hd), np.float32)

    def dev(a, dt=dtype):
        return torch.from_numpy(a).to(device).to(dt)

    return (dev(q), dev(kp), dev(vp), dev(bt, torch.int32),
            dev(np.asarray(q_lens, np.int32), torch.int32),
            dev(np.asarray(kv_lens, np.int32), torch.int32))


def wgmma_unit_check(device="cuda"):
    """The tile core's first launch check (``hopper_wgmma_check``): one
    64-row tile S = Q·Kᵀ (wgmma m64n64k16, both operands from shared
    memory) and O = bf16(S)·V (wgmma m64n128k16, P from registers, V
    MN-major) against torch.matmul in f32. With Q, K, V in {-1, 0, 1}
    every value is an integer below 2^8 (S) or 2^13 (O), exact in bf16 and
    f32 on both sides, so any layout or descriptor fault shows as a
    nonzero error; then N(0,1) inputs, S within 1e-5 of its max (f32
    summation order) and O against bf16(S)·V of the kernel's own S."""
    import torch
    from paddle_tpu_torch.ops import _build
    lib = _build.load("ragged_paged_attention")
    rng = np.random.default_rng(SEED + 12)

    def run(q, k, v):
        s = torch.empty(64, 64, device=device)
        o = torch.empty(64, 128, device=device)
        err = lib.hopper_wgmma_check(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(),
            o.data_ptr(), torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"wgmma check launch: cudaError {err} "
              f"({_build.error_string(err)})")
        torch.cuda.synchronize()
        return s, o

    def ints(*shape):
        return torch.from_numpy(rng.integers(-1, 2, shape).astype(
            np.float32)).to(device, torch.bfloat16)

    q, k, v = ints(64, 128), ints(64, 128), ints(64, 128)
    s, o = run(q, k, v)
    s_ref = q.float() @ k.float().T
    o_ref = s_ref.bfloat16().float() @ v.float()
    s_err = float((s - s_ref).abs().max())
    o_err = float((o - o_ref).abs().max())
    check(s_err == 0 and o_err == 0, f"wgmma exact check: S error {s_err}, "
          f"O error {o_err}")
    q, k, v = (torch.from_numpy(rng.standard_normal((64, 128), np.float32))
               .to(device, torch.bfloat16) for _ in range(3))
    s, o = run(q, k, v)
    s_ref = q.float() @ k.float().T
    o_ref = s.bfloat16().float() @ v.float()
    s_rel = float((s - s_ref).abs().max() / s_ref.abs().max())
    o_rel = float((o - o_ref).abs().max() / o_ref.abs().max())
    print(f"  wgmma unit check: exact S and O errors {s_err} and {o_err}; "
          f"N(0,1) S {s_rel:.2e}, O {o_rel:.2e} of their max", flush=True)
    check(s_rel <= 1e-5 and o_rel <= 1e-5, f"wgmma N(0,1) check: S "
          f"{s_rel}, O {o_rel} of their max")
    return {"exact_s": s_err, "exact_o": o_err, "s_rel": s_rel,
            "o_rel": o_rel}


def rpa_compare(args, ps, scales=()):
    """K3 (or K4 with ``scales`` = (k_scale, v_scale)) and its plain
    version on one case: (kernel output, plain output, max_abs_err, worst
    share of the bound ``ra.tolerance``: per row in f32, per element in
    bf16)."""
    import torch
    from paddle_tpu_torch.ops import ragged_attention as ra
    kw = {"page_size": ps}
    if scales:
        kw.update(k_scale=scales[0], v_scale=scales[1])
    out = ra.ragged_paged_attention(*args, **kw)
    ref = ra.ragged_paged_attention_reference(*args, **kw)
    diff = (out.float() - ref.float()).abs()
    bound = ra.tolerance(*args, **kw)
    share = float(torch.where(diff > 0, diff / bound,
                              torch.zeros_like(diff)).max())
    return out, ref, float(diff.max()), share


def rpa_check(name, args, ps, scales=(), tag="K3"):
    """K3/K4 against its plain version on one case: finite outputs, q_len
    = 0 slots all zeros, and every output element within its bound.
    Returns (max_abs_err, worst share of the bound)."""
    import torch
    out, ref, err, share = rpa_compare(args, ps, scales)
    check(bool(torch.isfinite(out).all()), f"{name}: kernel output not "
          "finite")
    check(bool(torch.isfinite(ref).all()), f"{name}: plain output not finite")
    for b in torch.nonzero(args[4] == 0).flatten().tolist():
        check(bool((out[b] == 0).all()), f"{name}: q_len=0 slot {b} not "
              "zeros")
    print(f"  {tag}-vs-plain {name:<44} max_abs_err={err:.3e} "
          f"share of the bound {share:.3f}", flush=True)
    check(share <= 1.0, f"{name}: |kernel − plain| reaches {share:.3f} of "
          f"its bound (max_abs_err {err})")
    return err, share


def kernel_cases(device="cuda"):
    """K3 against its plain version: decode, ragged prefill, suffix and
    q_len=0 rows, groups 1 and 4, f32 and bf16 pools, each output element
    within ``ra.tolerance`` (per row in f32, per element in bf16), and
    f32 outputs also within ``ra.F32_TOL`` absolute, as K3's check held
    them before it went per element. Returns the worst share of the
    bound."""
    import torch
    from paddle_tpu_torch.ops import ragged_attention as ra
    rng = np.random.default_rng(SEED)
    ps, hd, max_pages = 16, 128, 64
    worst = 0.0
    for groups, (H, KV) in ((1, (32, 32)), (4, (32, 8))):
        for dtype in (torch.float32, torch.bfloat16):
            decode_kv = rng.integers(1, 1025, 4)
            kinds = {
                "decode": ([1, 1, 1, 1], decode_kv),
                "prefill": ([512, 300, 0, 37], [512, 300, 77, 37]),
            }
            sq = rng.integers(2, 65, 4)
            kinds["suffix"] = (sq, sq + rng.integers(1, 900, 4))
            for kind, (ql, kl) in kinds.items():
                args = make_case(rng, ql, kl, H, KV, hd, ps, max_pages,
                                 dtype, device)
                name = f"{kind} groups={groups} {str(dtype)[6:]}"
                err, share = rpa_check(name, args, ps)
                check(dtype != torch.float32 or err <= ra.F32_TOL,
                      f"{name}: max_abs_err {err} > {ra.F32_TOL}")
                worst = max(worst, share)
    print(f"  K3: worst share of the bound {worst:.3f}", flush=True)
    return worst


def tile_cases(device="cuda"):
    """The tile path (``rpa_tile_kernel``) against the plain version, each
    output element within ``ra.tolerance``: bf16 models at head dim 128
    (and 64), page sizes 4 (K3's cp.async gather), 16, 32 and 64 (its
    TMA gather), groups 1 and 4, ragged prefill
    with a q_len=0 slot, suffix rows of 2 to 64 rows (the smallest the
    dispatch sends) and of 65 to 520, over bf16 pages (K3) and int8 and
    fp8 pages (K4); every dead row NaN, dead payloads fp8 NaN / int8
    −128, dead scales NaN. Each case must launch the tile kernel.
    Returns the worst share of the bound."""
    import torch
    from paddle_tpu_torch.ops import ragged_attention as ra
    rng = np.random.default_rng(SEED + 13)
    worst = 0.0
    shapes = [(128, 1, 32, 32), (128, 4, 32, 8), (64, 4, 8, 2)]
    for ps in (4, 16, 32, 64):
        max_pages = 1024 // ps
        for hd, groups, H, KV in shapes:
            kinds = {"prefill": ([512, 300, 0, 37], [512, 300, 77, 37]),
                     "suffix short": ([2, 17, 2, 64 // groups],
                                      [700, 18, 90, 900]),
                     "suffix long": ([130, 65, 7, 100],
                                     [1000, 65, 300, 613])}
            if hd == 64 and ps != 32:
                kinds.pop("suffix long")
            for kind, (ql, kl) in kinds.items():
                args = make_case(rng, ql, kl, H, KV, hd, ps, max_pages,
                                 torch.bfloat16, device)
                check(ra._tile_path(max(ql), hd, torch.bfloat16),
                      f"{kind}: not on the tile path")
                for pages in ("bf16", "int8", "fp8"):
                    if pages == "bf16":
                        case, scales = args, ()
                    else:
                        qa = quantize_case(args, pages)
                        case, scales = qa[:6], qa[6:]
                    key = "ragged_paged_attention" + \
                        ("_quant" if scales else "") + "_tile"
                    before = ra.LAUNCHES[key]
                    name = (f"{kind} {pages} pages hd={hd} groups={groups} "
                            f"ps={ps}")
                    _, share = rpa_check(name, case, ps, scales, "tile")
                    check(ra.LAUNCHES[key] == before + 1,
                          f"{name}: {key} did not launch")
                    worst = max(worst, share)
    print(f"  tile path: worst share of the bound {worst:.3f}", flush=True)
    return worst


def quantize_case(args, mode):
    """``make_case``'s inputs with both pools quantized per (row, kv head)
    by the port's codec: (q, k payload, v payload, block table, q_lens,
    kv_lens, k scales, v scales). Every dead row (NaN in ``make_case``)
    gets a poisoned payload (fp8: NaN, 0x7F; int8: -128, off the grid)
    and a NaN scale."""
    import torch
    from paddle_tpu_torch.quant.codec import quantize_lastdim
    q, kp, vp, bt, ql, kl = args
    pools = []
    for pool in (kp, vp):
        dead = torch.isnan(pool).any(-1)                  # [pages, ps, KV]
        pay, sc = quantize_lastdim(torch.nan_to_num(pool.float()), mode)
        pay.view(torch.uint8)[dead] = 0x7F if mode == "fp8" else 0x80
        sc[dead] = float("nan")
        pools.append((pay, sc))
    (kq, ks), (vq, vs) = pools
    return q, kq, vq, bt, ql, kl, ks, vs


def quant_kernel_cases(device="cuda"):
    """K4 against its plain version: int8 and fp8 payloads, f32 and bf16
    models, decode, ragged prefill, suffix and q_len=0 rows, groups 1 and
    4, at the serving shape's head dim 128 and page size 16, then head
    dims 64 and 16. Returns the worst share of the bound."""
    import torch
    rng = np.random.default_rng(SEED + 7)
    ps, max_pages = 16, 64
    worst = 0.0
    shapes = [(128, 1, 32, 32), (128, 4, 32, 8), (64, 2, 8, 4),
              (16, 2, 4, 2)]
    for hd, groups, H, KV in shapes:
        for mode in ("int8", "fp8"):
            for dtype in (torch.float32, torch.bfloat16):
                kinds = {"decode": ([1, 1, 1, 1], rng.integers(1, 1025, 4)),
                         "prefill": ([512, 300, 0, 37], [512, 300, 77, 37])}
                sq = rng.integers(2, 65, 4)
                kinds["suffix"] = (sq, sq + rng.integers(1, 900, 4))
                if hd != 128:
                    kinds.pop("suffix")
                for kind, (ql, kl) in kinds.items():
                    args = make_case(rng, ql, kl, H, KV, hd, ps, max_pages,
                                     dtype, device)
                    name = (f"{kind} {mode} {str(dtype)[6:]} hd={hd} "
                            f"groups={groups}")
                    qa = quantize_case(args, mode)
                    _, share = rpa_check(name, qa[:6], ps, qa[6:], "K4")
                    worst = max(worst, share)
    print(f"  K4: worst share of the bound {worst:.3f}", flush=True)
    return worst


# --------------------------------------------------------------- phase 4
SERVE_GEOMETRY = dict(max_batch=4, max_len=1024, prompt_buckets=(512,),
                      burst=8, page_size=16)


def serve(cfg, params, device="cuda", kv_dtype=None, pool_hbm_bytes=None):
    """Serve 8 requests (with ``kv_dtype`` pages, in a pool of
    ``pool_hbm_bytes`` when given); returns (engine, requests, results,
    seconds, mid-flight admission bursts, launches of the path's kernels —
    K3, or K4 with kv_dtype, on rpa_kernel and rpa_tile_kernel together —,
    per-step host seconds by kind)."""
    import torch
    from paddle_tpu_torch.inference.serving import ContinuousBatcher
    from paddle_tpu_torch.ops import ragged_attention as ra
    rng = np.random.default_rng(SEED + 1)
    lens = rng.permutation(np.linspace(16, 500, 8).astype(int))
    news = rng.integers(16, 65, 8)
    reqs = [(rng.integers(1, cfg.vocab_size, int(n)).tolist(), int(m))
            for n, m in zip(lens, news)]
    engine = ContinuousBatcher(cfg, params, kv_dtype=kv_dtype,
                               pool_hbm_bytes=pool_hbm_bytes, device=device,
                               **SERVE_GEOMETRY)
    rids = [engine.add_request(p, m) for p, m in reqs]
    ra.LAUNCHES.clear()
    t0 = time.perf_counter()
    midflight = 0
    finished = {}
    step_s = {"prefill": [], "decode": []}
    while engine.pending:
        busy = engine.active
        prefills = engine.stats["prefill_bursts"]
        t_step = time.perf_counter()
        engine.step()        # ends in the burst's one blocking readback
        had_prefill = engine.stats["prefill_bursts"] > prefills
        step_s["prefill" if had_prefill else "decode"].append(
            time.perf_counter() - t_step)
        midflight += bool(busy and had_prefill)
        finished.update(engine.take_finished())
    seconds = time.perf_counter() - t0
    mine = "ragged_paged_attention" + ("_quant" if kv_dtype else "")
    launches = ra.LAUNCHES[mine] + ra.LAUNCHES[mine + "_tile"]
    return engine, reqs, [finished.get(r) for r in rids], seconds, \
        midflight, launches, step_s


def first_token_logits(cfg, params, prompts, device="cuda", kv_dtype=None):
    """Last-position logits of the serving path's prefill phase (paged
    pool, ragged kernel) for up to 4 prompts in one launch per layer."""
    import torch
    from paddle_tpu_torch.models.llama_paged import (_ragged_prefill_phase,
                                                     init_paged_kv_cache)
    ps, width, max_pages = 16, 512, 64
    B = 4
    cache = init_paged_kv_cache(cfg, 1 + B * width // ps, ps,
                                kv_dtype=kv_dtype, device=device)
    bt = torch.zeros((B, max_pages), dtype=torch.int32)
    toks = torch.zeros((B, width), dtype=torch.int32)
    lens = torch.zeros(B, dtype=torch.int32)
    for b, p in enumerate(prompts):
        n = -(-len(p) // ps)
        bt[b, :n] = torch.arange(1 + b * width // ps, 1 + b * width // ps + n)
        toks[b, :len(p)] = torch.tensor(p)
        lens[b] = len(p)
    with torch.no_grad():
        logits, _ = _ragged_prefill_phase(
            params, cache, bt.to(device), toks.to(device), lens.to(device),
            torch.zeros(B, dtype=torch.int32, device=device), cfg,
            kv_dtype=kv_dtype)
    return logits[:len(prompts)]


def codec_forward(params, tokens, cfg, kv_dtype):
    """``llama_forward`` (flash attention, K1 on the card) with every
    layer's K and V passed through the page codec — quantized per (row,
    kv head) and dequantized to the model dtype — before attention: the
    function the quantized serving path computes, in one dense pass."""
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.ops.flash_attention import flash_attention_raw
    from paddle_tpu_torch.quant.codec import (dequantize_lastdim,
                                              quantize_lastdim)

    def attend(q, k, v, causal):
        k = dequantize_lastdim(*quantize_lastdim(k, kv_dtype), k.dtype)
        v = dequantize_lastdim(*quantize_lastdim(v, kv_dtype), v.dtype)
        return flash_attention_raw(q, k, v, causal=causal)

    layer_p, other = L.split_layer_params(params)
    x = L._embed(other, tokens, cfg)
    pos = L._positions(*tokens.shape, x.device)
    for l in range(cfg.num_hidden_layers):
        x = L._decoder_layer(x, L.layer_slice(layer_p, l), cfg, pos,
                             flash=attend)[0]
    return L.lm_head_logits(x, other, cfg)


def teacher_forced(cfg, params, cfg32, params32, reqs, results,
                   device="cuda", kv_dtype=None):
    """Dense bf16 forward over prompt + emitted tokens for every request
    (with ``kv_dtype``, K/V through the page codec: ``codec_forward``).

    Calibration: the dense bf16 path's own distance from an f32 forward of
    the same weights, eps = max |logits_bf16 − logits_f32| over the
    request's generated positions, is the bf16 rounding noise of one
    valid evaluation. The serving path is another bf16 evaluation of the
    same arithmetic (other matmul shapes, the kernel's unrounded online
    softmax), so it too sits within ~eps of the f32 logits and the two
    bf16 paths within TOL = 2·eps of each other (checked directly on the
    first token). Greedy emits the engine's argmax, so the emitted token's
    dense logit is within DELTA = 2·TOL of the dense maximum.

    Quantized pages: the codec's payloads are a function of K and V, so a
    bf16 rounding of K or V can move a value onto the neighbouring grid
    point (an int8 step is absmax/127, an fp8 step up to 2^-3 relative).
    The f32 forward quantizes its own f32 K/V, so eps includes those
    flips as well as the bf16 rounding; the serving path flips codes
    against the dense bf16 path the same way, and TOL = 2·eps, DELTA =
    2·TOL hold as derived above. With eps of order 1 this is a coarse
    check: it passes any token near the top of the distribution. The
    discriminating check of quantized serving is ``f32_pool_check``."""
    import torch
    from paddle_tpu_torch.models.llama import llama_forward

    def forward(p, seq, c):
        if kv_dtype is None:
            return llama_forward(p, seq, c)
        return codec_forward(p, seq, c, kv_dtype)

    worst = {"eps": 0.0, "gap_over_delta": 0.0, "argmax_agree": 0,
             "tokens": 0, "first_err_over_tol": 0.0}
    for i in range(0, len(reqs), 4):
        chunk = list(range(i, min(i + 4, len(reqs))))
        firsts = first_token_logits(cfg, params,
                                    [reqs[k][0] for k in chunk], device,
                                    kv_dtype)
        for row, k in enumerate(chunk):
            prompt, _ = reqs[k]
            out = results[k].out
            seq = torch.tensor([prompt + out], device=device)
            with torch.no_grad():
                lb = forward(params, seq, cfg)[0]
                lf = forward(params32, seq, cfg32)[0]
            pos = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(out),
                               device=device)
            lb, lf = lb[pos], lf[pos]
            eps = float((lb - lf).abs().max())
            tol = 2 * eps
            delta = 2 * tol
            emitted = torch.tensor(out, device=device)
            gap = lb.max(dim=-1).values - lb.gather(1, emitted[:, None])[:, 0]
            first_err = float((firsts[row] - lb[0]).abs().max())
            print(f"  request {k}: prompt {len(prompt)} new {len(out)} "
                  f"eps={eps:.4f} max gap={float(gap.max()):.4f} "
                  f"delta={delta:.4f} first-token |engine-dense|="
                  f"{first_err:.4f} tol={tol:.4f} argmax agree "
                  f"{int((gap == 0).sum())}/{len(out)}", flush=True)
            check(eps > 0 and np.isfinite(eps), f"request {k}: eps {eps}")
            check(float(gap.max()) <= delta,
                  f"request {k}: emitted token {float(gap.max())} below the "
                  f"dense max logit (delta {delta})")
            check(first_err <= tol, f"request {k}: first-token logits differ "
                  f"by {first_err} (tol {tol})")
            worst["eps"] = max(worst["eps"], eps)
            worst["gap_over_delta"] = max(worst["gap_over_delta"],
                                          float(gap.max()) / delta)
            worst["first_err_over_tol"] = max(worst["first_err_over_tol"],
                                              first_err / tol)
            worst["argmax_agree"] += int((gap == 0).sum())
            worst["tokens"] += len(out)
    return worst


F32_DELTA = 1e-3


def f32_serving_check(cfg32, params32, reqs, device="cuda"):
    """The same engine in f32 (f32 weights, f32 pool, the kernel's f32
    instance) on the first four requests, each emitted token held to a
    teacher-forced dense f32 forward. In f32 the two paths differ by
    summation order only (~1e-5 on logits of order 5), so the emitted
    token's dense logit must be within F32_DELTA = 1e-3 of the maximum: a
    masking, paging or indexing fault moves logits by order 1."""
    import torch
    from paddle_tpu_torch.inference.serving import ContinuousBatcher
    from paddle_tpu_torch.models.llama import llama_forward
    engine = ContinuousBatcher(cfg32, params32, device=device,
                               **SERVE_GEOMETRY)
    rids = [engine.add_request(p, m) for p, m in reqs[:4]]
    out = engine.run()
    worst, agree, total = 0.0, 0, 0
    for rid, (prompt, m) in zip(rids, reqs):
        toks = out[rid]
        check(len(toks) == m, f"f32 request {rid}: {len(toks)} of {m} tokens")
        with torch.no_grad():
            lf = llama_forward(params32, torch.tensor([prompt + toks],
                                                      device=device),
                               cfg32)[0]
        lf = lf[len(prompt) - 1:len(prompt) - 1 + len(toks)]
        gap = lf.max(dim=-1).values - lf.gather(
            1, torch.tensor(toks, device=device)[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        agree += int((gap == 0).sum())
        total += len(toks)
    print(f"[serve] f32 engine vs dense f32: max gap {worst:.3e} (delta "
          f"{F32_DELTA}), argmax agree {agree}/{total}", flush=True)
    check(worst <= F32_DELTA, f"f32 serving: emitted token {worst} below "
          f"the dense max logit (delta {F32_DELTA})")
    check(engine.pages_in_use == 0, "f32 engine pool not drained")
    return worst


# f32_pool_check: four requests of POOL_CHECK_NEW tokens, POOL_CHECK_STEPS
# bursts (a prefill-carrying one, then decode-only ones), so that no
# request finishes and every page is still mapped when the pool is read
POOL_CHECK_NEW = 40
POOL_CHECK_STEPS = 4
# share of a (row, kv head)'s absmax the engine's f32 K/V may differ from
# the dense forward's (summation order: ≈ 1e-5 of it at most)
WRITE_SLACK = 2.0 ** -12


def pool_forward(params, tokens, cfg, pool_kv):
    """``llama_forward`` over tokens [1, T] with every layer attending,
    causally through the flash kernel (K1 on the card), over the given
    K/V rows ``pool_kv[l]`` = (k, v) [1, T, KV, hd] instead of its own: the
    teacher-forced forward over a given pool. Returns (logits [T, V], each
    layer's own (k, v) [T, KV, hd])."""
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.ops.flash_attention import flash_attention_raw
    layer_p, other = L.split_layer_params(params)
    x = L._embed(other, tokens, cfg)
    pos = L._positions(*tokens.shape, x.device)
    own = []
    for l in range(cfg.num_hidden_layers):
        kp, vp = L._expand_gqa(*pool_kv[l], cfg)
        x, k, v = L._decoder_layer(
            x, L.layer_slice(layer_p, l), cfg, pos,
            flash=lambda q, _k, _v, causal: flash_attention_raw(
                q, kp, vp, causal=causal))
        own.append((k[0], v[0]))
    return L.lm_head_logits(x, other, cfg)[0], own


def write_share(x, payload, scale, kv_dtype):
    """How far the pool's rows (``payload``, ``scale``) [T, KV, hd] / [T,
    KV] sit from the codec of the dense forward's f32 rows ``x``, as
    shares of their bounds: (worst element share, worst scale share, the
    fraction of payload codes that differ). Element bound: half a grid
    step at x (int8: scale/2; fp8: 2^-4·|x|, or 2^-10·scale below fp8's
    normal range) plus WRITE_SLACK of the (row, head)'s absmax; scale
    bound: WRITE_SLACK of the scale."""
    import torch
    from paddle_tpu_torch.quant.codec import (MODES, dequantize_lastdim,
                                              quantize_lastdim)
    ref_pay, ref_scale = quantize_lastdim(x, kv_dtype)
    qmax = MODES[kv_dtype][1]
    s = ref_scale[..., None]
    half = s / 2 if kv_dtype == "int8" else torch.maximum(
        x.abs() * 2.0 ** -4, s * 2.0 ** -10)
    bound = half + WRITE_SLACK * qmax * s
    deq = dequantize_lastdim(payload, scale, torch.float32)
    elem = float(((deq - x).abs() / bound).max())
    sc = float(((scale - ref_scale).abs() / (WRITE_SLACK * ref_scale)).max())
    flips = float((payload.view(torch.uint8) != ref_pay.view(torch.uint8))
                  .float().mean())
    return elem, sc, flips


def f32_pool_check(cfg32, params32, reqs, kv_dtype, device="cuda"):
    """The engine in f32 with ``kv_dtype`` pages (the kernel's f32
    instance): the first four prompts with POOL_CHECK_NEW new tokens each,
    POOL_CHECK_STEPS bursts, no request finished. Then, per request, a
    dense f32 forward over prompt + emitted tokens that attends over the
    rows the engine wrote (``pool_forward``, dequantized in f32 as K4
    does):

    * read: every emitted token's logit within F32_DELTA = 1e-3 of that
      forward's maximum. Both sides attend over the same payloads and
      scales, so they differ by f32 summation order only (≈ 1e-5 on
      logits of order 5), as the f32 check of bf16 pages does; no code
      flip enters, and a read of a wrong row, page or scale moves logits
      by order 1;
    * write: every pool row — written by the prefill's whole-page write
      and by the decode steps' row writes — within ``write_share``'s bound
      of the codec of the forward's own f32 K/V at that position, and its
      scale within WRITE_SLACK of theirs. The two K/V differ by summation
      order only, so the engine's payload sits within half a grid step of
      the forward's K/V; a payload or scale at a wrong index is off by
      order 1.

    Returns {"gap": worst gap, "write": worst element share, "scale":
    worst scale share, "flips": largest fraction of differing codes}."""
    import torch
    from paddle_tpu_torch.inference.serving import ContinuousBatcher
    from paddle_tpu_torch.quant.codec import dequantize_lastdim
    engine = ContinuousBatcher(cfg32, params32, kv_dtype=kv_dtype,
                               device=device, **SERVE_GEOMETRY)
    for prompt, _ in reqs[:4]:
        engine.add_request(prompt, POOL_CHECK_NEW)
    for _ in range(POOL_CHECK_STEPS):
        engine.step()
    check(engine.stats["prefill_bursts"] == 1 and engine.active == 4
          and not engine.take_finished(), f"{kv_dtype} f32 pool check: "
          f"the four requests are not all live ({engine.stats})")
    cache = engine._cache
    worst = {"gap": 0.0, "write": 0.0, "scale": 0.0, "flips": 0.0}
    agree = total = 0
    for slot, req in enumerate(engine._slot_req):
        P, out = len(req.prompt), req.out
        rows = int(engine._pos[slot])  # all but the last emitted token's
        check(rows == P + len(out) - 1, f"slot {slot}: {rows} rows written "
              f"for a prompt of {P} and {len(out)} tokens")
        pages = torch.tensor(engine._page_tbl[slot], device=device)

        def live(pool):
            return pool[pages].reshape(-1, *pool.shape[2:])[:rows]

        stored = [tuple(live(cache[n][l]) for n in ("k", "k_scale", "v",
                                                     "v_scale"))
                  for l in range(cfg32.num_hidden_layers)]
        pool_kv = [(dequantize_lastdim(kq, ks, torch.float32)[None],
                    dequantize_lastdim(vq, vs, torch.float32)[None])
                   for kq, ks, vq, vs in stored]
        seq = torch.tensor([req.prompt + out[:-1]], device=device)
        with torch.no_grad():
            logits, own = pool_forward(params32, seq, cfg32, pool_kv)
        logits = logits[P - 1:]
        emitted = torch.tensor(out, device=device)
        gap = logits.max(dim=-1).values \
            - logits.gather(1, emitted[:, None])[:, 0]
        worst["gap"] = max(worst["gap"], float(gap.max()))
        agree += int((gap == 0).sum())
        total += len(out)
        for (k, v), (kq, ks, vq, vs) in zip(own, stored):
            for x, pay, sc in ((k, kq, ks), (v, vq, vs)):
                elem, scale, flips = write_share(x, pay, sc, kv_dtype)
                worst["write"] = max(worst["write"], elem)
                worst["scale"] = max(worst["scale"], scale)
                worst["flips"] = max(worst["flips"], flips)
    print(f"[serve {kv_dtype}] f32 engine vs dense f32 over its own pool: "
          f"{total} tokens, max gap {worst['gap']:.3e} (delta {F32_DELTA}), "
          f"argmax agree {agree}/{total}; pool rows vs the codec of the "
          f"dense K/V: worst {worst['write']:.3f} of the element bound, "
          f"{worst['scale']:.3f} of the scale bound, codes differing in at "
          f"most {worst['flips']:.2e} of a layer's elements", flush=True)
    check(worst["gap"] <= F32_DELTA, f"{kv_dtype} f32 pool check: emitted "
          f"token {worst['gap']} below the dense max logit (delta "
          f"{F32_DELTA})")
    check(worst["write"] <= 1.0 and worst["scale"] <= 1.0,
          f"{kv_dtype} f32 pool check: pool rows off the codec of the dense "
          f"K/V ({worst['write']:.3f} of the element bound, "
          f"{worst['scale']:.3f} of the scale bound)")
    return worst


def profile_decode_burst(cfg, params, kv_dtype=None):
    """torch.profiler over one decode-only burst of a 4-slot engine whose
    slots hold 500-token prompts (``kv_dtype`` pages): host wall time,
    device busy time, the device kernels launched, the attention kernel's
    share (K3, or K4 with kv_dtype), and the kernels that took the most
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference.serving import ContinuousBatcher
    rng = np.random.default_rng(SEED + 3)
    engine = ContinuousBatcher(cfg, params, kv_dtype=kv_dtype, device="cuda",
                               **SERVE_GEOMETRY)
    for _ in range(4):
        engine.add_request(rng.integers(1, cfg.vocab_size, 500).tolist(), 40)
    engine.step()                       # prefill-carrying burst
    engine.step()                       # warm decode-only burst
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []                           # device kernels only: the host
    for e in prof.key_averages():       # ops that launch them also carry
        if e.device_type != DeviceType.CUDA:    # their device time
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    launched = sum(r[1] for r in rows)
    att_ms = sum(r[0] for r in rows if "rpa_kernel" in r[2])
    att_n = sum(r[1] for r in rows if "rpa_kernel" in r[2])
    att = "K4" if kv_dtype else "K3"
    pages = f"{kv_dtype} pages" if kv_dtype else "bf16 pages"
    print(f"[profile] one decode-only burst of {engine.burst} steps, "
          f"{pages}: host wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} "
          f"ms ({100 * busy_ms / wall_ms:.1f}%), {launched} device kernels, "
          f"{att} {att_ms:.3f} ms over {att_n} launches", flush=True)
    for ms, n, key in rows[:8]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "kernels": launched, "attention_ms": att_ms,
            "attention_launches": att_n}


# --------------------------------------------------------------- phase 5
def timed_shape(kind, B, q_len, kv_len, H, KV, hd, ps, max_pages,
                kv_dtype=None):
    """K3 (or K4 over ``kv_dtype`` pages) at one shape of the serving
    path, bf16: kernel, kernel with the wrapper's host time, plain
    version, and SDPA over the same rows gathered contiguous (for K4
    dequantized beforehand: no PyTorch call dequantizes and attends in
    one, so SDPA is a yardstick only and ``library_ms`` stays null).
    Bounds count each input read once and each output written once: q
    and out, the live K/V rows (payload and scales for K4), the block
    table and lengths; and 4·hd flops per attended (row, column) pair."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import ragged_attention as ra
    from paddle_tpu_torch.quant.codec import dequantize_lastdim
    rng = np.random.default_rng(SEED + 2)
    args = make_case(rng, [q_len] * B, [kv_len] * B, H, KV, hd, ps,
                     max_pages, torch.bfloat16)
    kw = {"page_size": ps}
    if kv_dtype:
        q, kp, vp, bt, ql, kl, ks, vs = quantize_case(args, kv_dtype)
        args = (q, kp, vp, bt, ql, kl)
        kw.update(k_scale=ks, v_scale=vs)
    q, kp, vp, bt = args[:4]
    out = ra.ragged_paged_attention(*args, **kw)
    ref = ra.ragged_paged_attention_reference(*args, **kw)
    err = float((out.float() - ref.float()).abs().max())
    ms = time_ms(lambda: ra.ragged_paged_attention(*args, **kw))
    host_ms = time_ms(lambda: ra.ragged_paged_attention(*args, **kw),
                      device_only=False)
    # the tile path's shapes: rpa_kernel at the same shape, for comparison
    tile = ra._tile_path(q_len, hd, q.dtype)
    old_ms = time_ms(lambda: ra._launch(
        *args, ps, kw.get("k_scale"), kw.get("v_scale"), tile=False)) \
        if tile else None
    plain_ms = time_ms(
        lambda: ra.ragged_paged_attention_reference(*args, **kw))
    # yardstick: the same rows gathered contiguous (gather not timed)
    rows = bt.long()[:, :-(-kv_len // ps)]
    kc = kp[rows].reshape(B, -1, KV, hd)[:, :kv_len]
    vc = vp[rows].reshape(B, -1, KV, hd)[:, :kv_len]
    if kv_dtype:
        kc = dequantize_lastdim(kc, ks[rows].reshape(B, -1, KV)[:, :kv_len],
                                q.dtype)
        vc = dequantize_lastdim(vc, vs[rows].reshape(B, -1, KV)[:, :kv_len],
                                q.dtype)
    kc, vc = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    qs = q.transpose(1, 2).contiguous()
    gqa = {"enable_gqa": True} if H != KV else {}
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qs, kc, vc, is_causal=q_len > 1, **gqa))
    item = 2
    row_head = kp.element_size() * hd + (4 if kv_dtype else 0)
    nbytes = item * 2 * B * q_len * H * hd + 2 * B * kv_len * KV * row_head \
        + 4 * (bt.numel() + 2 * B)
    pairs = B * H * sum(kv_len - q_len + r + 1 for r in range(q_len))
    flops = 4 * pairs * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    pages = f" {kv_dtype} pages" if kv_dtype else ""
    rec = {"shape": f"{kind}: B={B} q_len={q_len} kv_len={kv_len} H={H} "
                    f"KV={KV} hd={hd} page_size={ps} bf16{pages}",
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None if kv_dtype else sdpa_ms, "max_abs_err": err,
           "ms_with_host": host_ms, "bytes": nbytes, "flops": flops,
           "kernel": "rpa_tile_kernel" if tile else "rpa_kernel"}
    if tile:
        rec["rpa_kernel_ms"] = old_ms
    if kv_dtype:
        rec["sdpa_on_dequantized_ms"] = sdpa_ms
    label = "sdpa on dequantized K/V (yardstick)" if kv_dtype else "sdpa"
    other = f", rpa_kernel {old_ms:.4f} ms" if tile else ""
    print(f"  {rec['shape']}: {rec['kernel']} {ms:.4f} ms (with host "
          f"{host_ms:.4f} ms), bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}), plain {plain_ms:.4f} ms, {label} "
          f"{sdpa_ms:.4f} ms{other}, max_abs_err {err:.3e}", flush=True)
    return rec


CROSSOVER_Q = (2, 4, 8, 16, 32, 64, 128)
CROSSOVER_KV = (128, 1024)


def tile_crossover(H, KV, hd, B=4, ps=16):
    """Both kernels of K3 over bf16 pages at suffix rows of q_len in
    CROSSOVER_Q and kv_len in CROSSOVER_KV (B slots, the serving
    geometry), device time by CUDA events: {kv_len: {q_len·groups:
    [rpa_kernel ms, tile ms]}}, and the smallest q_len·groups from which
    the tile kernel is at least as fast at every measured size and kv_len
    (the dispatch, ``_tile_path``, sends it every call of q_max > 1: 2
    rows and up)."""
    import torch
    from paddle_tpu_torch.ops import ragged_attention as ra
    rng = np.random.default_rng(SEED + 14)
    table = {}
    for kv_len in CROSSOVER_KV:
        row = table[kv_len] = {}
        for ql in CROSSOVER_Q:
            args = make_case(rng, [ql] * B, [kv_len] * B, H, KV, hd, ps,
                             -(-kv_len // ps), torch.bfloat16)
            row[ql * H // KV] = [
                time_ms(lambda: ra._launch(*args, ps, tile=t), iters=20)
                for t in (False, True)]
        print(f"  crossover at kv_len {kv_len} (B={B}, bf16 pages; rows: "
              f"rpa_kernel ms / rpa_tile_kernel ms): " + ", ".join(
                  f"{n}: {a:.4f}/{b:.4f}" for n, (a, b) in row.items()),
              flush=True)
    rows = sorted(next(iter(table.values())))
    faster = [n for n in rows if all(t[m][1] <= t[m][0] for t in
                                     table.values() for m in rows if m >= n)]
    cross = min(faster) if faster else None
    print(f"  tile kernel as fast from {cross} rows at every kv_len "
          f"(dispatch: every call of q_max > 1)", flush=True)
    return {"ms": {str(kv): {str(n): v for n, v in row.items()}
                   for kv, row in table.items()},
            "from_rows": cross, "dispatch_rows": 2}


# --------------------------------------------------------------- phase 6
# (label, B, L, S, H, D, sm_scale): the training path's shape first
FLASH_CASES = (("path", 1, 2048, 2048, 32, 128, None),
               ("ragged", 1, 200, 200, 4, 128, None),
               ("L<S", 1, 128, 384, 4, 128, None),
               ("L>S", 1, 384, 128, 4, 128, None),
               ("D=64", 2, 256, 256, 4, 64, 0.2))


def flash_inputs(rng, B, L, S, H, D, dtype, device="cuda"):
    """q, k, v, dout filled with N(0,1) from a seeded numpy generator."""
    import torch

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)) \
            .to(device).to(dtype)

    return t(B, L, H, D), t(B, S, H, D), t(B, S, H, D), t(B, L, H, D)


def flash_err(name, out, ref, dtype):
    """(max |kernel − plain|, its worst share of the per-row bound
    ``fa.tolerance``, see ops/flash_attention.py); fails past the bound."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    share = float(torch.nan_to_num(diff / fa.tolerance(ref, dtype),
                                   nan=0.0).max())
    check(bool(torch.isfinite(out).all()), f"{name}: kernel output not "
          "finite")
    check(share <= 1.0, f"{name}: |kernel − plain| reaches {share:.3f} of "
          f"its per-row bound (max_abs_err {err})")
    return err, share


def flash_cases():
    """K1 and K2 against their plain versions: every case of FLASH_CASES
    in f32 and bf16, causal and not, each output held row by row. Returns
    {kernel: worst error at the path's bf16 causal shape}."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    rng = np.random.default_rng(SEED + 4)
    worst, shares = {}, {}
    for label, B, L, S, H, D, sm in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v, do = flash_inputs(rng, B, L, S, H, D, dtype)
                out, lse = fa.flash_forward(q, k, v, causal, sm)
                torch.cuda.synchronize()
                ref, ref_lse = fa.flash_attention_reference(q, k, v, causal,
                                                            sm)
                name = f"{label} {str(dtype)[6:]} causal={causal}"
                errs = {"out": flash_err(name + " out", out, ref, dtype)}
                dead = torch.isneginf(ref_lse)
                check(bool((torch.isneginf(lse) == dead).all()),
                      f"{name}: lse −inf rows differ")
                check(bool((out.transpose(1, 2)[dead] == 0).all()),
                      f"{name}: rows with no visible key are not 0")
                lerr = float((lse[~dead] - ref_lse[~dead]).abs().max()) \
                    if bool((~dead).any()) else 0.0
                check(lerr <= fa.LSE_TOL, f"{name}: lse err {lerr}")
                # K2 from the plain forward's out and lse, on both sides
                dq, dk, dv = fa.flash_backward(q, k, v, ref, ref_lse, do,
                                               causal, sm)
                torch.cuda.synchronize()
                rq, rk, rv = fa.flash_attention_bwd_reference(
                    q, k, v, ref, ref_lse, do, causal, sm)
                for gname, a, r in (("dq", dq, rq), ("dk", dk, rk),
                                    ("dv", dv, rv)):
                    errs[gname] = flash_err(f"{name} {gname}", a, r, dtype)
                print(f"  flash-vs-plain {name:<30} lse_err={lerr:.2e} " +
                      " ".join(f"{g}={e:.2e} ({r:.3f} of bound)"
                               for g, (e, r) in errs.items()), flush=True)
                for g, (_, r) in errs.items():
                    key = f"{str(dtype)[6:]} {g}"
                    shares[key] = max(shares.get(key, 0.0), r)
                if label == "path" and dtype == torch.bfloat16 and causal:
                    worst = {"flash_fwd": errs["out"][0],
                             "flash_bwd_dq": errs["dq"][0],
                             "flash_bwd_dkv": max(errs["dk"][0],
                                                  errs["dv"][0])}
    print("  worst share of the per-row bound over the cases: " +
          ", ".join(f"{k} {v:.3f}" for k, v in shares.items()), flush=True)
    return worst


def flash_times(errs):
    """K1 and both K2 kernels at the training path's shape (bf16, causal,
    B=1, L=S=2048, H=32, D=128) beside their bounds, the plain versions
    and scaled_dot_product_attention's forward and backward (a yardstick
    the port never calls). CUDA events, median of 30 after 5 warm-ups."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    _, B, L, S, H, D, _ = FLASH_CASES[0]
    rng = np.random.default_rng(SEED + 5)
    q, k, v, do = flash_inputs(rng, B, L, S, H, D, torch.bfloat16)
    scale = fa._scale(D, None)
    out, lse = fa._flash_fwd(q, k, v, True, scale)
    delta = fa._bwd_delta(out, do)
    fwd_ms = time_ms(lambda: fa._flash_fwd(q, k, v, True, scale))
    dq_ms = time_ms(lambda: fa._bwd_dq(q, k, v, do, lse, delta, True, scale))
    dkv_ms = time_ms(lambda: fa._bwd_dkv(q, k, v, do, lse, delta, True,
                                         scale))
    plain_fwd = time_ms(lambda: fa.flash_attention_reference(q, k, v, True))
    plain_bwd = time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, True))
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True))
    ref = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    dos = do.transpose(1, 2)
    lib_bwd = time_ms(lambda: torch.autograd.grad(ref, (qs, ks, vs), dos,
                                                  retain_graph=True))
    pairs = B * H * sum(min(S, r + S - L + 1) for r in range(L))
    item = 2
    qkv = item * B * (L + 2 * S) * H * D
    rows = 4 * B * H * L                          # one f32 per row
    work = {   # (flops, bytes): each input read once, each output written
        "flash_fwd": (4 * D * pairs, qkv + item * B * L * H * D + rows),
        "flash_bwd_dq": (6 * D * pairs,
                         qkv + 2 * item * B * L * H * D + 2 * rows),
        "flash_bwd_dkv": (8 * D * pairs,
                          qkv + item * B * L * H * D + 2 * rows
                          + 2 * item * B * S * H * D),
    }
    times = {"flash_fwd": (fwd_ms, plain_fwd, lib_fwd),
             "flash_bwd_dq": (dq_ms, plain_bwd, lib_bwd),
             "flash_bwd_dkv": (dkv_ms, plain_bwd, lib_bwd)}
    shape = f"B={B} L=S={L} H={H} D={D} bf16 causal"
    recs = {}
    for name, (flops, nbytes) in work.items():
        ms, plain_ms, lib_ms = times[name]
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        recs[name] = {"ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes",
                      "library_ms": lib_ms, "max_abs_err": errs.get(name),
                      "shape": shape, "flops": flops, "bytes": nbytes,
                      "tflops_per_s": flops / ms / 1e9}
        print(f"  {name} {shape}: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), bound "
              f"{recs[name]['bound_ms']:.4f} ms ({recs[name]['bound_by']}), "
              f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms", flush=True)
    # K2 as a whole needs 5 products per visible pair (s, dp, dv, ds·k,
    # dsᵀ·q); the dq/dkv split recomputes s and dp in both kernels (7)
    k2_ms = dq_ms + dkv_ms
    k2_split = recs["flash_bwd_dq"]["bound_ms"] \
        + recs["flash_bwd_dkv"]["bound_ms"]
    k2_bound = max(10 * D * pairs / PEAK_FLOPS["bfloat16"] * 1e3,
                   (qkv + 2 * item * B * L * H * D + 2 * rows
                    + item * B * (L + 2 * S) * H * D) / HBM_BYTES_PER_S * 1e3)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        recs[name].update(k2_ms=k2_ms, k2_bound_ms=k2_bound)
    print(f"  K2 whole (flash_bwd_dq + flash_bwd_dkv) {shape}: {k2_ms:.4f} "
          f"ms, bound of the whole backward {k2_bound:.4f} ms (5 products; "
          f"the split's 7 sum to {k2_split:.4f} ms in the two kernels' "
          f"bounds), plain {plain_bwd:.4f} ms, sdpa {lib_bwd:.4f} ms",
          flush=True)
    return recs


# --------------------------------------------------------------- phase 7
TRAIN_T = 2048
TRAIN_STEPS = 5
LAYER_TOL = 2.0 ** -5      # × max|ref| per weight gradient, see layer_check
# |bf16 loss − f32 loss| / f32 loss: about 6× the gap of 1.75e-4 that the
# first runs of this check read at these weights and batch
LOSS_REL_TOL = 1e-3


def layer_check(cfg, device="cuda"):
    """(a) One decoder layer at full width (D=4096, T=2048, bf16) through
    K1/K2 against the same layer through their plain versions
    (``flash_attention_plain``), from the same x and upstream gradient
    (N(0,1), seeded numpy). Compared: the attention output (before wo),
    row by row within ``fa.tolerance`` as in phase 6; the layer's output
    and the gradients of its nine weights, where the kernels' roundings
    of p and ds to bf16 and the bf16 roundings that follow give ≈ 2^-8 of
    each value: LAYER_TOL = 2^-5 of each tensor's max leaves a 4× margin
    over 2^-7. The layer's output is dominated by the residual x, so only
    the attention output and the gradients can see attention."""
    import torch
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.ops import flash_attention as fa
    cfg1 = dataclasses.replace(cfg, num_hidden_layers=1)
    layer_p, _ = L.split_layer_params(L.init_params(cfg1, seed=SEED + 6,
                                                    device=device))
    rng = np.random.default_rng(SEED + 6)
    shape = (1, TRAIN_T, cfg.hidden_size)
    x = torch.from_numpy(rng.standard_normal(shape, np.float32)) \
        .to(device, cfg.dtype)
    dy = torch.from_numpy(rng.standard_normal(shape, np.float32)) \
        .to(device, cfg.dtype)
    pos = L._positions(1, TRAIN_T, x.device)

    def run(flash):
        seen = []

        def attend(q, k, v, causal):
            seen.append(flash(q, k, v, causal))
            return seen[-1]

        lp = {k: v[0].detach().requires_grad_() for k, v in layer_p.items()}
        y = L._decoder_layer(x, lp, cfg, pos, flash=attend)[0]
        y.backward(dy)
        torch.cuda.synchronize()
        return seen[0].detach(), {"out": y.detach(),
                                  **{"d" + k: v.grad for k, v in lp.items()}}

    att, got = run(fa.flash_attention_raw)
    att_ref, ref = run(fa.flash_attention_plain)
    err, share = flash_err("layer attention output", att, att_ref, cfg.dtype)
    print(f"  layer attention max|kernel − plain| {err:.3e} ({share:.3f} of "
          f"its per-row bound)", flush=True)
    worst = share
    for name, r in ref.items():
        err = float((got[name].float() - r.float()).abs().max())
        tol = LAYER_TOL * float(r.float().abs().max())
        check(bool(torch.isfinite(got[name]).all()), f"layer {name} finite")
        check(err <= tol, f"layer check {name}: {err} > {tol}")
        worst = max(worst, err / tol)
        print(f"  layer {name:<8} max|kernel − plain| {err:.3e} (tol "
              f"{tol:.3e})", flush=True)
    return worst


def profile_train_step(step, toks, labels):
    """torch.profiler over one training step: host wall, device busy, and
    device time by kernel (flash kernels, GEMMs, the rest)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = step(toks, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)

    def share(*keys):
        return sum(r[0] for r in rows if any(k in r[2] for k in keys))

    flash = {k: share(k + "_kernel") for k in ("flash_fwd", "flash_bwd_dq",
                                               "flash_bwd_dkv")}
    gemm = share("nvjet", "gemm", "sm90_xmma", "cutlass")
    int64 = share("<long")        # the int64 passes of _sr_cast's hash
    print(f"[profile] one training step: host wall {wall_ms:.1f} ms, device "
          f"busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}%), flash "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in flash.items())
          + f", GEMMs {gemm:.1f} ms, int64 elementwise (the bf16 moments' "
          f"stochastic-rounding hash) {int64:.1f} ms", flush=True)
    for ms, n, key in rows[:12]:
        print(f"  {ms:9.3f} ms  x{n:<6d} {key[:90]}")
    return float(loss), {"wall_ms": wall_ms, "device_busy_ms": busy,
                         "gemm_ms": gemm, "int64_ms": int64,
                         **{k + "_ms": v for k, v in flash.items()}}


def training_phase(cfg, device="cuda"):
    """Phase 7: Llama-2-7B training, bf16, B=1, T=2048, AdamW(3e-4,
    weight_decay=0.1, bf16 moments), remat=True. Checks (a) one layer at
    full width against the plain attention, (b) the bf16 loss against the
    f32 one on the same weights (both before the optimizer state exists),
    (c) five steps of finite, falling loss on a repeated batch, (d) the
    flash launch counts the path implies. Returns K1/K2 launches."""
    import torch
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.models.trainer import LlamaTrainStep
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    torch.cuda.empty_cache()
    print(f"[train] (a) one decoder layer, D={cfg.hidden_size}, "
          f"T={TRAIN_T}, K1/K2 vs plain", flush=True)
    layer_check(cfg, device)
    torch.cuda.empty_cache()

    rng = np.random.RandomState(SEED)
    toks_np = rng.randint(0, cfg.vocab_size, (1, TRAIN_T)).astype(np.int32)
    toks = torch.from_numpy(toks_np).to(device)
    labels = torch.from_numpy(np.roll(toks_np, -1, axis=1)).to(device)

    # (b) the first loss in bf16 against the same weights widened to f32
    params = L.init_params(cfg, seed=SEED, device=device)
    with torch.no_grad():
        loss_b = float(L.llama_loss(params, toks, labels, cfg))
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        params32 = {k: v.float() for k, v in params.items()}
        del params
        loss_f = float(L.llama_loss(params32, toks, labels, cfg32))
    del params32
    torch.cuda.empty_cache()
    rel = abs(loss_b - loss_f) / abs(loss_f)
    print(f"[train] (b) first loss bf16 {loss_b:.6f}, f32 {loss_f:.6f}, "
          f"relative difference {rel:.2e} (tol {LOSS_REL_TOL})", flush=True)
    check(np.isfinite(loss_b), f"bf16 loss {loss_b} not finite")
    check(rel <= LOSS_REL_TOL, f"bf16 loss {loss_b} vs f32 {loss_f}")

    # (c) five steps on the repeated batch
    opt = AdamW(learning_rate=3e-4, weight_decay=0.1,
                moment_dtype=torch.bfloat16)
    step = LlamaTrainStep(cfg, optimizer=opt, remat=True, seed=SEED,
                          device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES.clear()
    losses, secs, peaks = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step(toks, labels))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        print(f"[train] step {i + 1}: loss {float(losses[-1]):.6f}, "
              f"{secs[-1] * 1e3:.1f} ms, peak allocated {peaks[-1]:.2f} GiB",
              flush=True)
    launches = {k: fa.LAUNCHES[k] for k in ("flash_fwd", "flash_bwd_dq",
                                            "flash_bwd_dkv")}
    vals = [float(x) for x in losses]
    n_layers = cfg.num_hidden_layers
    expect = {"flash_fwd": 2 * n_layers * TRAIN_STEPS,
              "flash_bwd_dq": n_layers * TRAIN_STEPS,
              "flash_bwd_dkv": n_layers * TRAIN_STEPS}
    med = statistics.median(secs[1:])
    print(f"[train] losses {vals}; median step (steps 2-{TRAIN_STEPS}) "
          f"{med * 1e3:.1f} ms = {TRAIN_T / med:.1f} tokens/s; peak "
          f"allocated {max(peaks):.2f} GiB; launches {launches} (expected "
          f"{expect})", flush=True)
    check(all(np.isfinite(v) for v in vals), f"non-finite loss in {vals}")
    check(vals[-1] < vals[0], f"loss did not fall: {vals}")
    check(launches == expect, f"flash launches {launches} != {expect}")
    after, _ = profile_train_step(step, toks, labels)
    print(f"[train] loss after {TRAIN_STEPS} steps {after:.6f} (first "
          f"{vals[0]:.6f})", flush=True)
    check(np.isfinite(after) and after < vals[0],
          f"loss after {TRAIN_STEPS} steps {after} not below {vals[0]}")
    del step
    torch.cuda.empty_cache()
    return launches


# the int8 pool must hold at least this many times the bf16 pool's usable
# pages at one byte budget: 2·hd/(hd+4) = 1.94 at head_dim 128, less the
# scratch page of each pool
CAPACITY_RATIO = 1.9


def checked_serve(cfg, params, device="cuda", kv_dtype=None,
                  pool_hbm_bytes=None):
    """``serve`` and the checks every serving run must pass: each request
    completes with its full budget, admissions land mid-flight, the pool
    drains, and the path's kernels launch once per layer per step: K3 (or
    K4 with ``kv_dtype``) on ``rpa_kernel`` for every decode step, on
    ``rpa_tile_kernel`` for every prefill-carrying burst's 512-row prefill,
    while the other pool type's kernels do not launch at all. Returns
    (engine, requests, results, seconds, {"rpa": decode launches, "tile":
    prefill launches}, tokens)."""
    from paddle_tpu_torch.ops import ragged_attention as ra
    engine, reqs, results, seconds, midflight, total, step_s = serve(
        cfg, params, device, kv_dtype=kv_dtype,
        pool_hbm_bytes=pool_hbm_bytes)
    kernel, other = ("K4", "K3") if kv_dtype else ("K3", "K4")
    mine = "ragged_paged_attention" + ("_quant" if kv_dtype else "")
    launches = {"rpa": ra.LAUNCHES[mine], "tile": ra.LAUNCHES[mine + "_tile"]}
    others = sum(n for k, n in ra.LAUNCHES.items()
                 if k not in (mine, mine + "_tile"))
    st = engine.stats
    expect = {"rpa": cfg.num_hidden_layers * st["decode_steps"],
              "tile": cfg.num_hidden_layers * st["prefill_bursts"]}
    n_tok = sum(len(r.out) for r in results if r is not None)
    tag = f"[serve {kv_dtype}]" if kv_dtype else "[serve]"
    print(f"{tag} {len(reqs)} requests, {n_tok} tokens in {seconds:.3f} s "
          f"= {n_tok / seconds:.2f} tokens/s; stats {st}; mid-flight "
          f"admission bursts {midflight}; {engine._alloc.usable} usable "
          f"pages; {kernel} launches: rpa_kernel {launches['rpa']}, "
          f"rpa_tile_kernel {launches['tile']} (expected {expect}), "
          f"{other} launches {others}", flush=True)
    for kind, runs in step_s.items():
        if runs:
            print(f"{tag} {kind} bursts: {len(runs)}, median "
                  f"{statistics.median(runs) * 1e3:.2f} ms per burst of "
                  f"{engine.burst} decode steps", flush=True)
    what = kv_dtype or "bf16 pages"
    check(total == sum(expect.values()), f"{what}: {kernel} launches "
          f"{total} != {sum(expect.values())}")
    check(launches == expect, f"{what}: {kernel} launches by kernel "
          f"{launches} != {expect}")
    check(launches["rpa"] > 0 and launches["tile"] > 0,
          f"{what}: serving launched no decode or no prefill kernel")
    check(others == 0, f"{what}: {other} launched {others} times")
    check(midflight >= 2, f"{what}: only {midflight} bursts admitted "
          "mid-flight")
    check(all(r is not None and r.done and r.reason == "complete"
              and len(r.out) == m for r, (_, m) in zip(results, reqs)),
          f"{what}: not every request finished with its full budget")
    check(engine.pages_in_use == 0, f"{what}: {engine.pages_in_use} pages "
          "in use after the drain")
    return engine, reqs, results, seconds, launches, n_tok


def quantized_serving(cfg, params, cfg32, params32, kv_dtype, budget,
                      device="cuda"):
    """The serving phase's 8 requests with ``kv_dtype`` pages in a pool of
    ``budget`` bytes, through ``checked_serve``, then every emitted token
    within DELTA of a teacher-forced dense forward whose K/V pass through
    the same codec (``teacher_forced``). Returns the run's numbers."""
    engine, reqs, results, seconds, launches, n_tok = checked_serve(
        cfg, params, device, kv_dtype=kv_dtype, pool_hbm_bytes=budget)
    usable = engine._alloc.usable
    del engine
    tf = teacher_forced(cfg, params, cfg32, params32, reqs, results,
                        device, kv_dtype=kv_dtype)
    print(f"[serve {kv_dtype}] teacher-forced through the codec: "
          f"{json.dumps(tf)}", flush=True)
    return {"launches": launches, "tokens": n_tok, "seconds": seconds,
            "tokens_per_s": n_tok / seconds, "usable_pages": usable,
            "teacher_forced": tf}


def serving_phases(cfg):
    """Phases 4 and 5: serve (bf16 pages, then int8 and fp8 pages), check,
    profile, then time K3 and K4. Returns their records for the kernels
    line."""
    import torch
    from paddle_tpu_torch.inference.serving import ContinuousBatcher
    from paddle_tpu_torch.models.llama import init_params
    from paddle_tpu_torch.models.llama_paged import page_bytes

    # 4. serving
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"[serve] Llama-2-7B init on device: "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{sum(v.numel() for v in params.values()) / 1e9:.3f} B params",
          flush=True)
    engine, reqs, results, seconds, launches, n_tok = \
        checked_serve(cfg, params)     # launches: {"rpa": n, "tile": n}
    # the byte budget of this engine's pool, for the quantized runs
    budget = engine._alloc.num_pages * page_bytes(cfg, engine._ps)
    del engine
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: v.float() for k, v in params.items()}
    tf = teacher_forced(cfg, params, cfg32, params32, reqs, results)
    print(f"[serve] teacher-forced: {json.dumps(tf)}", flush=True)
    f32_serving_check(cfg32, params32, reqs)
    quant = {kv: quantized_serving(cfg, params, cfg32, params32, kv, budget)
             for kv in ("int8", "fp8")}
    for kv, q in quant.items():
        q["f32_pool_check"] = f32_pool_check(cfg32, params32, reqs, kv)
    del params32
    torch.cuda.empty_cache()
    bf16_pool = ContinuousBatcher(cfg, params, pool_hbm_bytes=budget,
                                  device="cuda", **SERVE_GEOMETRY)
    bf16_usable = bf16_pool._alloc.usable
    del bf16_pool
    for kv, q in quant.items():
        ratio = q["usable_pages"] / bf16_usable
        print(f"[serve] {budget} bytes of pool: {kv} {q['usable_pages']} "
              f"usable pages, bf16 {bf16_usable}: {ratio:.3f}x (at least "
              f"{CAPACITY_RATIO})", flush=True)
        check(ratio >= CAPACITY_RATIO, f"{kv} pool holds {ratio:.3f}x the "
              f"bf16 pool's pages, below {CAPACITY_RATIO}")
    torch.cuda.empty_cache()
    profile_decode_burst(cfg, params)
    profile_decode_burst(cfg, params, kv_dtype="int8")
    del params
    torch.cuda.empty_cache()
    phase("serving", t0)

    # 5. times at the serving path's shapes
    t0 = time.perf_counter()
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    decode = timed_shape("decode", 4, 1, 1024, H, KV, hd, 16, 64)
    prefill = timed_shape("prefill", 4, 512, 512, H, KV, hd, 16, 64)
    qtimes = {kv: (timed_shape("decode", 4, 1, 1024, H, KV, hd, 16, 64, kv),
                   timed_shape("prefill", 4, 512, 512, H, KV, hd, 16, 64, kv))
              for kv in ("int8", "fp8")}
    cross = tile_crossover(H, KV, hd)
    k3_n = launches["rpa"] + launches["tile"]
    k4_n = {kv: q["launches"]["rpa"] + q["launches"]["tile"]
            for kv, q in quant.items()}
    k4_tokens = sum(q["tokens"] for q in quant.values())
    print(f"[times] launches per served token: K3 {k3_n / n_tok:.3f}, "
          f"K4 {sum(k4_n.values()) / k4_tokens:.3f}", flush=True)
    phase("times", t0)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "ms_with_host", "shape")
    src = "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu"
    k3 = {"name": "ragged_paged_attention", "route": "cuda", "source": src,
          "replaces": "paddle_tpu/ops/ragged_attention.py:97",
          "path": "rpa_kernel: decode rows (and f32, head dim 16)",
          "launches": launches["rpa"], **{k: decode[k] for k in keys},
          "launches_per_token": k3_n / n_tok,
          "tokens_per_s": n_tok / seconds}
    k3_tile = {"name": "ragged_paged_attention_tile", "route": "cuda",
               "source": src,
               "replaces": "paddle_tpu/ops/ragged_attention.py:97",
               "path": "rpa_tile_kernel: bf16 prefill and suffix rows",
               "launches": launches["tile"], **{k: prefill[k] for k in keys},
               "rpa_kernel_ms": prefill["rpa_kernel_ms"],
               "crossover": cross}
    dec8, pre8 = qtimes["int8"]
    k4 = {"name": "ragged_paged_attention_quant", "route": "cuda",
          "source": src, "replaces": "paddle_tpu/ops/ragged_attention.py:194",
          "path": "rpa_kernel: decode rows (and f32, head dim 16)",
          "launches": sum(q["launches"]["rpa"] for q in quant.values()),
          "launches_by_kv_dtype": {kv: q["launches"]["rpa"]
                                   for kv, q in quant.items()},
          **{k: dec8[k] for k in keys},
          "sdpa_on_dequantized_ms": dec8["sdpa_on_dequantized_ms"],
          "fp8": qtimes["fp8"][0],
          "launches_per_token": sum(k4_n.values()) / k4_tokens,
          "tokens_per_s": {kv: q["tokens_per_s"] for kv, q in quant.items()},
          "f32_pool_check": {kv: q["f32_pool_check"]
                             for kv, q in quant.items()},
          "usable_pages": {"bf16": bf16_usable,
                           **{kv: q["usable_pages"]
                              for kv, q in quant.items()}}}
    k4_tile = {"name": "ragged_paged_attention_quant_tile", "route": "cuda",
               "source": src,
               "replaces": "paddle_tpu/ops/ragged_attention.py:194",
               "path": "rpa_tile_kernel: bf16 prefill and suffix rows",
               "launches": sum(q["launches"]["tile"]
                               for q in quant.values()),
               "launches_by_kv_dtype": {kv: q["launches"]["tile"]
                                        for kv, q in quant.items()},
               **{k: pre8[k] for k in keys},
               "sdpa_on_dequantized_ms": pre8["sdpa_on_dequantized_ms"],
               "rpa_kernel_ms": pre8["rpa_kernel_ms"],
               "fp8": qtimes["fp8"][1]}
    return [k3, k3_tile, k4, k4_tile]


# --------------------------------------------------------------- phase 8
BSA_SHAPE = (1, 32, 8192, 128)            # B, H, T, D: Llama-2-7B's width
LONGFORMER = (256, 64)                    # window ±256, 64 global tokens
BSA_REPLACES = {
    "bsa_fwd": "paddle_tpu/ops/block_sparse_attention.py:73",
    "bsa_bwd_dq": "paddle_tpu/ops/block_sparse_attention.py:192",
    "bsa_bwd_dkv": "paddle_tpu/ops/block_sparse_attention.py:254",
}


def longformer_pattern(T, window, n_global):
    """Rows and columns (sorted by row, then column) of the Longformer
    pattern (arXiv 2004.05150 §3.1): key j is attended by query i when
    |i − j| <= window, and the first ``n_global`` tokens attend every key
    and are attended by every query."""
    i = np.arange(T)
    lo = np.where(i < n_global, 0, np.maximum(n_global, i - window))
    hi = np.where(i < n_global, T, np.minimum(T, i + window + 1))
    glob = np.where(i < n_global, 0, n_global)   # the global keys first
    per_row = glob + hi - lo
    rows = np.repeat(i, per_row)
    start = np.repeat(np.cumsum(per_row) - per_row, per_row)
    off = np.arange(rows.size) - start
    g = glob[rows]
    cols = np.where(off < g, off, lo[rows] + off - g)
    return rows, cols


def band(T, w):
    i, j = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
    keep = np.abs(i - j) <= w
    return i[keep], j[keep]


def bsa_patterns():
    """(label, T, rows, cols, block): the pattern shapes the kernels must
    handle, each small enough for the plain version to be quick."""
    rng = np.random.default_rng(SEED + 8)
    out = [("band, partial 16-blocks", 1024, *band(1024, 9), 16)]
    r, c = np.tril_indices(512)
    out.append(("causal tril", 512, r, c, 128))
    r = rng.integers(0, 384, 6000)
    c = rng.integers(0, 384, 6000)
    out.append(("random with duplicates", 384, np.concatenate([r, r[:2000]]),
                np.concatenate([c, c[:2000]]), 32))
    br, bc = band(512, 3)
    blk = np.arange(128)
    fr, fc = np.meshgrid(blk + 128, blk + 256, indexing="ij")  # map entry 1
    out.append(("fully covered block", 512, np.concatenate([br, fr.ravel()]),
                np.concatenate([bc, fc.ravel()]), 128))
    r, c = band(560, 40)
    out.append(("70-wide blocks", 560, r, c, 70))
    r, c = band(127, 7)                       # T=127 padded to 128
    out.append(("T=127 padded to 128", 128, r, c, 128))
    r, c = band(200, 5)
    out.append(("T=200, ragged last tile", 200, r, c, 8))
    r, c = band(256, 12)                      # rows >= 100, keys >= 60 out
    keep = (r < 100) & (c < 60)
    out.append(("rows and keys outside", 256, r[keep], c[keep], 32))
    # rows 5 and 6 attend nothing in k tile 0 (mixed for their q tile)
    # and only keys 150-160 of k tile 2
    r, c = band(256, 20)
    keep = (r != 5) & (r != 6)
    xr, xc = np.meshgrid(np.arange(64), np.arange(150, 161), indexing="ij")
    out.append(("row masked across a tile", 256,
                np.concatenate([r[keep], xr.ravel()]),
                np.concatenate([c[keep], xc.ravel()]), 64))
    return out


def bsa_cases(device="cuda"):
    """Phase 8 (a): K5 and K6 against their plain versions on every
    pattern of bsa_patterns, f32 and bf16, D=128 ([B, T, H, D] inputs)
    and D=64 (the [B, H, T, D] layout read through strides); each output
    row within ``tolerance``, lse within LSE_TOL where finite, and rows and
    keys outside the pattern exactly 0 (lse −inf)."""
    import torch
    from paddle_tpu_torch.ops import block_sparse_attention as bsa
    from paddle_tpu_torch.ops import flash_attention as fa
    rng = np.random.default_rng(SEED + 9)
    shares = {}
    for label, T, rows, cols, block in bsa_patterns():
        pat = bsa.compile_pattern(rows, cols, T, block, block, device)
        tm = pat.plan.tile_map
        row_any = np.zeros(T, bool)
        row_any[rows] = True
        key_any = np.zeros(T, bool)
        key_any[cols] = True
        row_out = torch.from_numpy(~row_any).to(device)
        key_out = torch.from_numpy(~key_any).to(device)
        for D in (128, 64):
            for dtype in (torch.float32, torch.bfloat16):
                B, H = 2, 2

                def t():
                    x = rng.standard_normal((B, H, T, D), np.float32)
                    x = torch.from_numpy(x).to(device, dtype)
                    return x.transpose(1, 2) if D == 64 else \
                        x.transpose(1, 2).contiguous()

                q, k, v, do = t(), t(), t(), t()
                name = f"{label} D={D} {str(dtype)[6:]}"
                out, lse = bsa.bsa_forward(q, k, v, pat)
                ref, ref_lse = bsa.bsa_fwd_reference(
                    q, k, v, pat.block_map, pat.masks, block, block)
                dq, dk, dv = bsa.bsa_backward(q, k, v, ref, ref_lse, do, pat)
                grads = bsa.bsa_bwd_reference(q, k, v, ref, ref_lse, do,
                                              pat.block_map, pat.masks,
                                              block, block)
                if device == "cuda":
                    torch.cuda.synchronize()
                errs = {"out": flash_err(name + " out", out, ref, dtype)}
                for g, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
                    errs[g] = flash_err(f"{name} {g}", a, r, dtype)
                dead = torch.isneginf(ref_lse)
                check(bool((dead == row_out[None, None]).all()),
                      f"{name}: the plain lse is −inf on other rows than "
                      "those outside the pattern")
                check(bool((torch.isneginf(lse) == dead).all()),
                      f"{name}: lse −inf rows differ")
                lerr = float((lse[~dead] - ref_lse[~dead]).abs().max())
                check(lerr <= fa.LSE_TOL, f"{name}: lse err {lerr}")
                check(bool((out[:, row_out] == 0).all())
                      and bool((dq[:, row_out] == 0).all()),
                      f"{name}: rows outside the pattern are not exactly 0")
                check(bool((dk[:, key_out] == 0).all())
                      and bool((dv[:, key_out] == 0).all()),
                      f"{name}: keys outside the pattern are not exactly 0")
                print(f"  bsa-vs-plain {name:<42} tiles "
                      f"{int((tm == 1).sum())} full / {int((tm == 2).sum())}"
                      f" mixed, lse_err={lerr:.2e} " + " ".join(
                          f"{g}={e:.2e} ({s:.3f})"
                          for g, (e, s) in errs.items()), flush=True)
                for g, (_, s) in errs.items():
                    key = f"{str(dtype)[6:]} {g}"
                    shares[key] = max(shares.get(key, 0.0), s)
    print("  worst share of the per-row bound over the cases: " +
          ", ".join(f"{k} {v:.3f}" for k, v in shares.items()), flush=True)
    return shares


def bsa_path(device="cuda"):
    """Phase 8 (b): ``sparse.fused_attention`` forward and backward at
    BSA_SHAPE in bf16 under the Longformer mask as a torch sparse CSR
    tensor on the card, twice. Checks K5/K6 launches (1/1/1 a call, no K1
    or K2), one compile for both calls, and out, dq, dk, dv row by row
    against ``block_sparse_attention_plain`` on the same inputs.
    Returns (launches, errors, the inputs, the pattern's rows and columns
    and the compiled pattern), for the timings."""
    import torch
    from paddle_tpu_torch import sparse
    from paddle_tpu_torch.ops import block_sparse_attention as bsa
    from paddle_tpu_torch.ops import flash_attention as fa
    B, H, T, D = BSA_SHAPE
    rows, cols = longformer_pattern(T, *LONGFORMER)
    crows = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=T))])
    mask = sparse.sparse_csr_tensor(crows, cols,
                                    np.ones(rows.size, np.float32), (T, T),
                                    device=device)
    rng = np.random.default_rng(SEED + 10)

    def t():
        return torch.from_numpy(rng.standard_normal((B, H, T, D),
                                                    np.float32)) \
            .to(device, torch.bfloat16)

    q, k, v = (t().requires_grad_() for _ in range(3))
    do = t()
    misses = bsa._get_pattern.cache_info().misses
    bsa.LAUNCHES.clear()
    fa.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = sparse.fused_attention(q, k, v, mask)
    out.backward(do)
    if device == "cuda":
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fn = mask._bsa_fn_memo[1]
    grads = [x.grad.clone() for x in (q, k, v)]
    t0 = time.perf_counter()
    out2 = sparse.fused_attention(q, k, v, mask)
    out2.backward(do)
    if device == "cuda":
        torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    launches = {n: bsa.LAUNCHES[n] for n in BSA_REPLACES}
    compiled = bsa._get_pattern.cache_info().misses - misses
    tm = fn.plan.tile_map
    print(f"[sparse] fused_attention B={B} H={H} T={T} D={D} bf16, "
          f"Longformer ±{LONGFORMER[0]} + {LONGFORMER[1]} global: "
          f"{rows.size} pairs, block {fn.block_q}, "
          f"{int((fn.block_map > 0).sum())} active blocks of "
          f"{fn.block_map.size}, masks {fn.masks.numel() / 2 ** 20:.2f} MiB; "
          f"{bsa.TILE}-tiles: {int((tm > 0).sum())} active, "
          f"{int((tm == 1).sum())} full, {int((tm == 2).sum())} mixed, "
          f"{(tm > 0).sum() * bsa.TILE ** 2 / T ** 2:.4f} of T²; two calls "
          f"{first_s:.3f} s (compile included) and {second_s:.3f} s; "
          f"launches {launches}, flash {dict(fa.LAUNCHES)}, patterns "
          f"compiled {compiled}", flush=True)
    check(launches == {n: 2 for n in BSA_REPLACES},
          f"launches {launches} over two calls, want 1/1/1 a call")
    check(not any(fa.LAUNCHES.values()), f"K1/K2 launched: "
          f"{dict(fa.LAUNCHES)}")
    check(compiled == 1 and mask._bsa_fn_memo[1] is fn,
          f"pattern compiled {compiled} times over two calls")
    check(bool((out == out2).all()), "the second call's out differs")
    # the plain versions on the same card, [B, T, H, D] as the kernels
    qs, ks, vs = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    ref = bsa.block_sparse_attention_plain(qs, ks, vs, rows, cols,
                                           fn.block_q, fn.block_k)
    ref.backward(do.transpose(1, 2))
    errs = {}
    for name, got, want in (("out", out.detach().transpose(1, 2),
                             ref.detach()),
                            ("dq", grads[0].transpose(1, 2), qs.grad),
                            ("dk", grads[1].transpose(1, 2), ks.grad),
                            ("dv", grads[2].transpose(1, 2), vs.grad)):
        errs[name] = flash_err(f"fused_attention {name}", got, want,
                               torch.bfloat16)
    print("[sparse] against block_sparse_attention_plain: " + ", ".join(
        f"{n} {e:.3e} ({s:.3f} of the per-row bound)"
        for n, (e, s) in errs.items()), flush=True)
    del ref, qs, ks, vs, out, out2
    return launches, errs, (q.detach(), k.detach(), v.detach(), do), \
        (rows, cols), fn


def bsa_times(inputs, pattern, fn, errs):
    """Phase 8 (c): bsa_fwd, bsa_bwd_dq and bsa_bwd_dkv at the path's shape
    beside their bounds, the plain versions, and SDPA with the dense
    boolean [T, T] mask (forward, backward, forward+backward), a yardstick
    the port never calls. CUDA events, median of 30 after 5 warm-ups."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import block_sparse_attention as bsa
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do = (x.transpose(1, 2) for x in inputs)   # [B, T, H, D] views
    B, T, H, D = q.shape
    scale = fa._scale(D, None)
    out, lse = bsa._bsa_fwd(q, k, v, fn, scale)
    delta = fa._bwd_delta(out, do)
    fwd_ms = time_ms(lambda: bsa._bsa_fwd(q, k, v, fn, scale))
    dq_ms = time_ms(lambda: bsa._bsa_bwd_dq(q, k, v, do, lse, delta, fn,
                                            scale))
    dkv_ms = time_ms(lambda: bsa._bsa_bwd_dkv(q, k, v, do, lse, delta, fn,
                                              scale))
    plain_fwd = time_ms(lambda: bsa.bsa_fwd_reference(
        q, k, v, fn.block_map, fn.masks, fn.block_q, fn.block_k))
    plain_bwd = time_ms(lambda: bsa.bsa_bwd_reference(
        q, k, v, out, lse, do, fn.block_map, fn.masks, fn.block_q,
        fn.block_k))
    # the yardstick: dense attention under the pattern as a [T, T] mask
    dense = torch.zeros((T, T), dtype=torch.bool, device=q.device)
    dense[tuple(torch.from_numpy(x).to(q.device) for x in pattern)] = True
    pairs = int(dense.sum())
    tm = fn.plan.tile_map
    qs, ks, vs = (x.detach().requires_grad_() for x in inputs[:3])
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=dense))
    ref = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=dense)
    lib_bwd = time_ms(lambda: torch.autograd.grad(ref, (qs, ks, vs),
                                                  inputs[3],
                                                  retain_graph=True))
    lib_both = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qs, ks, vs, attn_mask=dense),
        (qs, ks, vs), inputs[3]))
    del ref, dense
    item = 2
    act = B * T * H * D * item                    # one [B, T, H, D] tensor
    rows = 4 * B * H * T                          # one f32 per row
    plan_q = sum(x.numel() * x.element_size() for x in fn.q_plan)
    plan_k = sum(x.numel() * x.element_size() for x in fn.k_plan)
    bits = fn.bits.numel() * fn.bits.element_size()
    hp = B * H * pairs
    work = {   # (flops, bytes): each input read once, each output written
        "bsa_fwd": (4 * D * hp, 4 * act + rows + plan_q + bits),
        "bsa_bwd_dq": (6 * D * hp, 5 * act + 2 * rows + plan_q + bits),
        "bsa_bwd_dkv": (8 * D * hp, 6 * act + 2 * rows + plan_k + bits),
    }
    times = {"bsa_fwd": (fwd_ms, plain_fwd, lib_fwd),
             "bsa_bwd_dq": (dq_ms, plain_bwd, lib_bwd),
             "bsa_bwd_dkv": (dkv_ms, plain_bwd, lib_bwd)}
    shape = (f"B={B} T={T} H={H} D={D} bf16, Longformer ±{LONGFORMER[0]} + "
             f"{LONGFORMER[1]} global, block {fn.block_q}")
    recs = {}
    for name, (flops, nbytes) in work.items():
        ms, plain_ms, lib_ms = times[name]
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        recs[name] = {"ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes",
                      "library_ms": lib_ms, "max_abs_err": errs[name],
                      "shape": shape, "flops": flops, "bytes": nbytes,
                      "ops_ms": t_ops, "bytes_ms": t_bytes,
                      "tflops_per_s": flops / ms / 1e9,
                      "sdpa_fwd_bwd_ms": lib_both,
                      "tiles": {"active": int((tm > 0).sum()),
                                "full": int((tm == 1).sum()),
                                "mixed": int((tm == 2).sum())},
                      "pairs": pairs}
        print(f"  {name} {shape}: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), bound "
              f"{recs[name]['bound_ms']:.4f} ms ({recs[name]['bound_by']}; "
              f"operations {t_ops:.4f}, bytes {t_bytes:.4f}), plain "
              f"{plain_ms:.4f} ms, sdpa with the dense mask {lib_ms:.4f} ms",
              flush=True)
    whole = max(10 * D * hp / PEAK_FLOPS["bfloat16"] * 1e3,
                (7 * act + 2 * rows + plan_q + plan_k + bits)
                / HBM_BYTES_PER_S * 1e3)
    print(f"  K6 whole (bsa_bwd_dq + bsa_bwd_dkv): {dq_ms + dkv_ms:.4f} ms, "
          f"bound of the whole backward {whole:.4f} ms (5 products), plain "
          f"{plain_bwd:.4f} ms; sdpa with the dense mask: backward "
          f"{lib_bwd:.4f} ms, forward+backward {lib_both:.4f} ms; {pairs} "
          f"pairs", flush=True)
    return recs


def sparse_phase(device="cuda"):
    """Phase 8: K5/K6 cases, the path at full width, the times. Returns
    the kernels' records."""
    import torch
    torch.cuda.empty_cache()
    bsa_cases(device)
    launches, errs, inputs, pattern, fn = bsa_path(device=device)
    err = {"bsa_fwd": errs["out"][0], "bsa_bwd_dq": errs["dq"][0],
           "bsa_bwd_dkv": max(errs["dk"][0], errs["dv"][0])}
    recs = bsa_times(inputs, pattern, fn, err)
    del inputs, fn
    torch.cuda.empty_cache()
    return [{"name": name, "route": "cuda",
             "source": "paddle_tpu_torch/ops/csrc/block_sparse_attention.cu",
             "replaces": BSA_REPLACES[name], "path": PATHS[name],
             "launches": launches[name],
             "launches_per_call": launches[name] // 2, **rec}
            for name, rec in recs.items()]


FLASH_REPLACES = {
    "flash_fwd": "paddle_tpu/ops/flash_attention.py:316",
    "flash_bwd_dq": "paddle_tpu/ops/flash_attention.py:201",
    "flash_bwd_dkv": "paddle_tpu/ops/flash_attention.py:243",
}
# the kernel each record's bf16 times and launches come from
PATHS = {
    "flash_fwd": "flash_fwd_kernel: Hopper tile core (wgmma, TMA ring)",
    "flash_bwd_dq": "flash_bwd_dq_kernel: mma.sync tiles",
    "flash_bwd_dkv": "flash_bwd_dkv_kernel: mma.sync tiles",
    "bsa_fwd": "bsa_fwd_kernel: mma.sync tiles over the 64-tile plan",
    "bsa_bwd_dq": "bsa_bwd_dq_kernel: mma.sync tiles over the plan",
    "bsa_bwd_dkv": "bsa_bwd_dkv_kernel: mma.sync tiles over the plan",
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from paddle_tpu_torch.models.llama import LlamaConfig
        from paddle_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing ({e}); "
              "run from a checkout of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # 1. device
    t0 = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | {card}",
          flush=True)
    phase("device", t0)

    # 2. build
    t0 = time.perf_counter()
    report = _build.build_all()
    for name, r in report.items():
        regs = [ln.strip() for ln in r["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        spills = [ln for ln in regs if " 0 bytes spill" not in ln
                  and "spill" in ln]
        print(f"[build] {name}: {r['seconds']:.2f} s, "
              f"{len(regs)} ptxas lines, {len(spills)} with spills",
              flush=True)
        for kernel, line in ptxas_by_kernel(r["log"]):
            print(f"  ptxas: {kernel}: {line}")
    phase("build", t0)

    cfg = LlamaConfig.llama2_7b()
    # 3. the tile core's wgmma check, then K3 and K4 (both kernels of
    # each) against their plain versions
    t0 = time.perf_counter()
    wgmma_unit_check()
    kernel_cases()
    quant_kernel_cases()
    tile_cases()
    phase("kernels", t0)
    # 4-5. serving and K3's and K4's times
    records = serving_phases(cfg)
    # 6. K1 and K2 against their plain versions, and their times
    t0 = time.perf_counter()
    flash = flash_times(flash_cases())
    phase("flash", t0)
    # 7. training
    t0 = time.perf_counter()
    launches = training_phase(cfg)
    phase("training", t0)
    for name, rec in flash.items():
        records.append({"name": name, "route": "cuda",
                        "source": "paddle_tpu_torch/ops/csrc/"
                                  "flash_attention.cu",
                        "replaces": FLASH_REPLACES[name],
                        "path": PATHS[name], "launches": launches[name],
                        **rec})
    # 8. block-sparse attention: K5 and K6, sparse.fused_attention
    t0 = time.perf_counter()
    records += sparse_phase()
    phase("sparse", t0)
    phase("total", t_all)
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

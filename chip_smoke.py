#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for sm_90a with nvcc) and
exits non-zero, printing no result, without one or outside a checkout of
the repository. Phases, each failing the run when its check fails:

1. device  — the card's name and power limit (nvidia-smi);
2. build   — every kernel of the serving path, built with nvcc from the
             checkout's sources (one nvcc per source, started together);
3. kernels — the ragged paged-attention kernel against its plain PyTorch
             version on the card: decode, ragged prefill, suffix and
             q_len=0 rows, groups 1 and 4, f32 and bf16 pools, dead pool
             rows and the scratch page filled with NaN;
4. serving — greedy Llama-2-7B (full width, random weights from a seed,
             bf16) through ContinuousBatcher's ragged path: 8 requests, 4
             slots, admissions mid-flight. Checks the kernel's launch
             count, the drained pool, and every emitted token against a
             teacher-forced dense forward of the same weights (bf16, and
             again with the whole engine in f32); profiles one decode
             burst;
5. times   — the kernel at the serving path's decode and prefill shapes
             beside its byte bound, its plain version and
             scaled_dot_product_attention (a yardstick the port never
             calls); CUDA events, median of 30 runs after warm-up.

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


def kernel_cases(device="cuda"):
    import torch
    from paddle_tpu_torch.ops import ragged_attention as ra
    rng = np.random.default_rng(SEED)
    ps, hd, max_pages = 16, 128, 64
    results = []
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
                out = ra.ragged_paged_attention(*args, page_size=ps)
                ref = ra.ragged_paged_attention_reference(*args,
                                                          page_size=ps)
                check(bool(torch.isfinite(out).all()),
                      f"{kind} g{groups} {dtype}: kernel output not finite")
                check(bool(torch.isfinite(ref).all()),
                      f"{kind} g{groups} {dtype}: plain output not finite")
                err = float((out.float() - ref.float()).abs().max())
                vmax = float(torch.nan_to_num(args[2].float()).abs().max())
                tol = ra.F32_TOL if dtype == torch.float32 \
                    else ra.BF16_TOL_PER_MAX_V * vmax
                zero_slots = [b for b, n in enumerate(ql) if n == 0]
                for b in zero_slots:
                    check(bool((out[b] == 0).all()), f"{kind}: q_len=0 slot "
                          f"{b} not zeros")
                name = f"{kind} groups={groups} {str(dtype)[6:]}"
                print(f"  kernel-vs-plain {name:<28} max_abs_err={err:.3e} "
                      f"tol={tol:.3e}", flush=True)
                check(err <= tol, f"{name}: max_abs_err {err} > tol {tol}")
                results.append(err)
    return results


# --------------------------------------------------------------- phase 4
def serve(cfg, params, device="cuda"):
    """Serve 8 requests; returns (engine, requests, results, seconds,
    mid-flight admission bursts, K3 launches, per-step host seconds by
    kind)."""
    import torch
    from paddle_tpu_torch.inference.serving import ContinuousBatcher
    from paddle_tpu_torch.ops import ragged_attention as ra
    rng = np.random.default_rng(SEED + 1)
    lens = rng.permutation(np.linspace(16, 500, 8).astype(int))
    news = rng.integers(16, 65, 8)
    reqs = [(rng.integers(1, cfg.vocab_size, int(n)).tolist(), int(m))
            for n, m in zip(lens, news)]
    engine = ContinuousBatcher(cfg, params, max_batch=4, max_len=1024,
                               prompt_buckets=(512,), burst=8, page_size=16,
                               device=device)
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
    launches = ra.LAUNCHES["ragged_paged_attention"]
    return engine, reqs, [finished.get(r) for r in rids], seconds, \
        midflight, launches, step_s


def first_token_logits(cfg, params, prompts, device="cuda"):
    """Last-position logits of the serving path's prefill phase (paged
    pool, ragged kernel) for up to 4 prompts in one launch per layer."""
    import torch
    from paddle_tpu_torch.models.llama_paged import (_ragged_prefill_phase,
                                                     init_paged_kv_cache)
    ps, width, max_pages = 16, 512, 64
    B = 4
    cache = init_paged_kv_cache(cfg, 1 + B * width // ps, ps, device=device)
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
            torch.zeros(B, dtype=torch.int32, device=device), cfg)
    return logits[:len(prompts)]


def teacher_forced(cfg, params, cfg32, params32, reqs, results,
                   device="cuda"):
    """Dense bf16 forward over prompt + emitted tokens for every request.

    Calibration: the dense bf16 path's own distance from an f32 forward of
    the same weights, eps = max |logits_bf16 − logits_f32| over the
    request's generated positions, is the bf16 rounding noise of one
    valid evaluation. The serving path is another bf16 evaluation of the
    same arithmetic (other matmul shapes, the kernel's unrounded online
    softmax), so it too sits within ~eps of the f32 logits and the two
    bf16 paths within TOL = 2·eps of each other (checked directly on the
    first token). Greedy emits the engine's argmax, so the emitted token's
    dense logit is within DELTA = 2·TOL of the dense maximum."""
    import torch
    from paddle_tpu_torch.models.llama import llama_forward
    worst = {"eps": 0.0, "gap_over_delta": 0.0, "argmax_agree": 0,
             "tokens": 0, "first_err_over_tol": 0.0}
    for i in range(0, len(reqs), 4):
        chunk = list(range(i, min(i + 4, len(reqs))))
        firsts = first_token_logits(cfg, params,
                                    [reqs[k][0] for k in chunk], device)
        for row, k in enumerate(chunk):
            prompt, _ = reqs[k]
            out = results[k].out
            seq = torch.tensor([prompt + out], device=device)
            with torch.no_grad():
                lb = llama_forward(params, seq, cfg)[0]
                lf = llama_forward(params32, seq, cfg32)[0]
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
    engine = ContinuousBatcher(cfg32, params32, max_batch=4, max_len=1024,
                               prompt_buckets=(512,), burst=8, page_size=16,
                               device=device)
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


def profile_decode_burst(cfg, params):
    """torch.profiler over one decode-only burst of a 4-slot engine whose
    slots hold 500-token prompts: host wall time, device busy time, K3's
    share, and the kernels that took the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference.serving import ContinuousBatcher
    rng = np.random.default_rng(SEED + 3)
    engine = ContinuousBatcher(cfg, params, max_batch=4, max_len=1024,
                               prompt_buckets=(512,), burst=8, page_size=16,
                               device="cuda")
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
    k3_ms = sum(r[0] for r in rows if "rpa_kernel" in r[2])
    k3_n = sum(r[1] for r in rows if "rpa_kernel" in r[2])
    print(f"[profile] one decode-only burst of {engine.burst} steps: host "
          f"wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), K3 {k3_ms:.3f} ms over "
          f"{k3_n} launches", flush=True)
    for ms, n, key in rows[:8]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "k3_ms": k3_ms,
            "k3_launches": k3_n}


# --------------------------------------------------------------- phase 5
def timed_shape(kind, B, q_len, kv_len, H, KV, hd, ps, max_pages):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import ragged_attention as ra
    rng = np.random.default_rng(SEED + 2)
    args = make_case(rng, [q_len] * B, [kv_len] * B, H, KV, hd, ps,
                     max_pages, torch.bfloat16)
    q, kp, vp, bt = args[:4]
    out = ra.ragged_paged_attention(*args, page_size=ps)
    ref = ra.ragged_paged_attention_reference(*args, page_size=ps)
    err = float((out.float() - ref.float()).abs().max())
    ms = time_ms(lambda: ra.ragged_paged_attention(*args, page_size=ps))
    host_ms = time_ms(lambda: ra.ragged_paged_attention(*args, page_size=ps),
                      device_only=False)
    plain_ms = time_ms(
        lambda: ra.ragged_paged_attention_reference(*args, page_size=ps))
    # yardstick: the same rows gathered contiguous (gather not timed)
    rows = bt.long()[:, :-(-kv_len // ps)]
    kc = kp[rows].reshape(B, -1, KV, hd)[:, :kv_len].transpose(1, 2)
    vc = vp[rows].reshape(B, -1, KV, hd)[:, :kv_len].transpose(1, 2)
    kc, vc = kc.contiguous(), vc.contiguous()
    qs = q.transpose(1, 2).contiguous()
    gqa = {"enable_gqa": True} if H != KV else {}
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qs, kc, vc, is_causal=q_len > 1, **gqa))
    item = 2
    nbytes = item * (2 * B * q_len * H * hd + 2 * B * kv_len * KV * hd) \
        + 4 * (bt.numel() + 2 * B)
    pairs = B * H * sum(kv_len - q_len + r + 1 for r in range(q_len))
    flops = 4 * pairs * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    rec = {"shape": f"{kind}: B={B} q_len={q_len} kv_len={kv_len} H={H} "
                    f"KV={KV} hd={hd} page_size={ps} bf16",
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib_ms, "max_abs_err": err,
           "ms_with_host": host_ms, "bytes": nbytes,
           "flops": flops}
    print(f"  {rec['shape']}: kernel {ms:.4f} ms (with host {host_ms:.4f}"
          f" ms), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, max_abs_err "
          f"{err:.3e}", flush=True)
    return rec


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
        from paddle_tpu_torch.models.llama import LlamaConfig, init_params
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
        for ln in regs:
            print(f"  ptxas: {ln}")
    phase("build", t0)

    # 3. kernel against its plain version
    t0 = time.perf_counter()
    kernel_cases()
    phase("kernels", t0)

    # 4. serving
    t0 = time.perf_counter()
    cfg = LlamaConfig.llama2_7b()
    params = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"[serve] Llama-2-7B init on device: "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{sum(v.numel() for v in params.values()) / 1e9:.3f} B params",
          flush=True)
    engine, reqs, results, seconds, midflight, launches, step_s = \
        serve(cfg, params)
    st = engine.stats
    expect = cfg.num_hidden_layers * (st["decode_steps"]
                                      + st["prefill_bursts"])
    n_tok = sum(len(r.out) for r in results if r is not None)
    print(f"[serve] {len(reqs)} requests, {n_tok} tokens in {seconds:.3f} s "
          f"= {n_tok / seconds:.2f} tokens/s; stats {st}; mid-flight "
          f"admission bursts {midflight}; K3 launches {launches} "
          f"(expected {expect})", flush=True)
    for kind, runs in step_s.items():
        if runs:
            print(f"[serve] {kind} bursts: {len(runs)}, median "
                  f"{statistics.median(runs) * 1e3:.2f} ms per burst of "
                  f"{engine.burst} decode steps", flush=True)
    check(launches == expect, f"K3 launches {launches} != {expect}")
    check(launches > 0, "serving launched no kernel")
    check(midflight >= 2, f"only {midflight} bursts admitted mid-flight")
    check(all(r is not None and r.done and r.reason == "complete"
              and len(r.out) == m for r, (_, m) in zip(results, reqs)),
          "not every request finished with its full budget")
    check(engine.pages_in_use == 0,
          f"{engine.pages_in_use} pages in use after the drain")
    del engine
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: v.float() for k, v in params.items()}
    tf = teacher_forced(cfg, params, cfg32, params32, reqs, results)
    print(f"[serve] teacher-forced: {json.dumps(tf)}", flush=True)
    f32_serving_check(cfg32, params32, reqs)
    del params32
    torch.cuda.empty_cache()
    profile_decode_burst(cfg, params)
    phase("serving", t0)

    # 5. times at the serving path's shapes
    t0 = time.perf_counter()
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    decode = timed_shape("decode", 4, 1, 1024, H, KV, hd, 16, 64)
    prefill = timed_shape("prefill", 4, 512, 512, H, KV, hd, 16, 64)
    launches_per_token = launches / n_tok
    print(f"[times] K3 launches per served token: {launches_per_token:.3f}",
          flush=True)
    phase("times", t0)
    phase("total", t_all)

    record = {"name": "ragged_paged_attention", "route": "cuda",
              "source": "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
              "replaces": "paddle_tpu/ops/ragged_attention.py:97",
              "launches": launches, "max_abs_err": decode["max_abs_err"],
              "ms": decode["ms"], "plain_ms": decode["plain_ms"],
              "bound_ms": decode["bound_ms"],
              "bound_by": decode["bound_by"],
              "library_ms": decode["library_ms"],
              "ms_with_host": decode["ms_with_host"],
              "shape": decode["shape"], "prefill": prefill,
              "launches_per_token": launches_per_token,
              "tokens_per_s": n_tok / seconds}
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The PyTorch port's ``ContinuousBatcher`` on the JAX package's default
serving layout, ``kv_layout="paged"`` (the gather read), and on
``"dense"``, against the JAX engine on the same weights, at the engine
geometry of ``tests/test_serving_paged.py`` (3 slots, ``max_len=96``,
prompt buckets 8/16/32, burst 4, page size 8).

* Greedy tokens identical to the JAX engine's for staggered mixed-length
  requests: ``"paged"`` and ``"dense"`` in f32 and bf16, ``"paged"`` over
  int8 and fp8 pages, ``precision="int8"`` (weight-only) and
  ``"bfloat16"``, prefix sharing and speculative decoding on ``"paged"``,
  a pool small enough to preempt mid-flight (JAX's
  ``test_midflight_preemption_is_exact``), and an MoE config; the page
  buckets used and the prefix and speculation counters equal JAX's.
* ``"paged"``, ``"dense"`` and ``"ragged"`` give the same tokens in f32.
* A NaN-poisoned pool serves the tokens of a clean one (the gather read
  zeroes V rows a slot may not see).
* The engine with no ``kv_layout`` serves through the gather path; the
  dense layout refuses the paged pool's options, as in JAX; weight-only
  int8 keeps the weights quantized and dequantizes one layer at a time.

Tolerance: greedy tokens identical. The bf16 cases hold for these
requests (the probabilities of the JAX package's CPU prefill are rounded
to bf16, the port's plain flash version keeps them in f32; see
``tests/test_torch_serving.py`` for the near-tie caveat).
"""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ContinuousBatcher as JaxBatcher
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import llama_init_params
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.inference.serving import ContinuousBatcher
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import llama_paged as tp
from paddle_tpu_torch.models.llama_decode import llama_generate

PS = 8
GEOMETRY = dict(max_batch=3, max_len=96, prompt_buckets=(8, 16, 32),
                burst=4, page_size=PS)
COUNTERS = ("prefills", "preemptions", "admission_stalls", "bursts",
            "decode_steps", "page_buckets_used", "prefix_hits",
            "prefix_tokens_shared", "prefix_pages_shared", "prefix_resumes",
            "prefix_marginal_pages", "cow_copies", "spec_steps",
            "spec_slot_launches", "spec_proposed", "spec_accepted",
            "spec_emitted")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dtype="float32", **kw):
    jcfg = JaxConfig.tiny(num_hidden_layers=2, max_position_embeddings=128,
                          dtype=getattr(jax.numpy, dtype), **kw)
    jparams = llama_init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = tl.LlamaConfig.tiny(num_hidden_layers=2,
                               max_position_embeddings=128,
                               dtype=getattr(torch, dtype), **kw)
    tparams = tl.params_from_jax({k: np.asarray(v)
                                  for k, v in jparams.items()}, tcfg,
                                 device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def f32():
    return _pair()


@pytest.fixture(scope="module")
def bf16():
    return _pair("bfloat16")


def _requests(seed, spec):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 256, n).tolist(), m) for n, m in spec]


WAVES = [_requests(11, [(5, 9), (19, 6), (12, 14)]),
         _requests(12, [(30, 5), (3, 11)]),
         _requests(13, [(8, 7)])]


def _serve(engine, waves):
    """Each wave added after one more scheduler step; returns the outputs
    in request order."""
    rids = []
    for i, wave in enumerate(waves):
        if i:
            engine.step()
        rids += [engine.add_request(p, m) for p, m in wave]
    out = {}
    while engine.pending:
        engine.step()
        out.update({r: q.out for r, q in engine.take_finished().items()})
    out.update({r: q.out for r, q in engine.take_finished().items()})
    return [out[r] for r in rids]


def _counters(eng):
    return {k: eng.stats.get(k, 0) for k in COUNTERS}


def _both(models, waves=WAVES, **kw):
    """The same traffic through the JAX engine and the port's with the
    same arguments: (JAX outputs, port outputs, JAX engine, port
    engine)."""
    jcfg, jparams, tcfg, tparams = models
    geo = {**GEOMETRY, **kw}
    jeng = JaxBatcher(jcfg, jparams, **geo)
    teng = ContinuousBatcher(tcfg, tparams, device="cpu", **geo)
    return _serve(jeng, waves), _serve(teng, waves), jeng, teng


def _generate(models, prompt, n):
    _, _, tcfg, tparams = models
    return llama_generate(tparams, torch.tensor([prompt]), tcfg, n,
                          device="cpu")[0].tolist()


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layout_tokens_identical_to_jax(f32, bf16, layout, dtype):
    """Staggered mixed-length requests: the JAX engine's tokens, its page
    buckets, its counters; the pool drained."""
    models = f32 if dtype == "float32" else bf16
    ref, out, jeng, teng = _both(models, kv_layout=layout)
    assert out == ref
    assert _counters(teng) == _counters(jeng)
    assert teng.pages_in_use == 0
    if layout == "paged":
        assert teng.stats["page_buckets_used"] == [2, 4, 8]
    if dtype == "float32":
        for (prompt, m), toks in zip([r for w in WAVES for r in w], out):
            assert toks == _generate(models, prompt, m)


def test_default_layout_is_the_gather_path(f32, monkeypatch):
    """No ``kv_layout``: the gather burst serves (the ragged burst never
    runs), as the JAX engine's default does."""
    jcfg, jparams, tcfg, tparams = f32

    def no_ragged(*a, **k):
        raise AssertionError("the ragged burst ran")

    monkeypatch.setattr(tp, "llama_ragged_burst", no_ragged)
    eng = ContinuousBatcher(tcfg, tparams, device="cpu", **GEOMETRY)
    assert eng._layout == "paged" and not eng._ragged
    out = _serve(eng, WAVES[:1])
    assert out == _serve(JaxBatcher(jcfg, jparams, **GEOMETRY), WAVES[:1])
    assert eng.stats["page_buckets_used"]


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_pages_tokens_identical_to_jax(f32, kv_dtype):
    ref, out, jeng, teng = _both(f32, kv_layout="paged", kv_dtype=kv_dtype)
    assert out == ref
    assert _counters(teng) == _counters(jeng)
    assert teng.pages_in_use == 0
    assert teng._cache["k"][0].dtype == tp.wire_dtype(kv_dtype)


@pytest.mark.parametrize("precision,layout", [
    ("int8", "paged"), ("int8", "dense"), ("int8", "ragged"),
    ("bfloat16", "paged"), ("weight_only_int8", "paged")])
def test_precision_tokens_identical_to_jax(f32, precision, layout):
    """Weight-only int8 (every layout) and the bf16 cast: the JAX
    engine's tokens."""
    ref, out, jeng, teng = _both(f32, kv_layout=layout, precision=precision)
    assert out == ref
    assert _counters(teng) == _counters(jeng)
    if precision == "bfloat16":
        assert teng._cfg.dtype == torch.bfloat16
        assert all(v.dtype == torch.bfloat16
                   for v in teng._params.values())
    else:
        assert isinstance(teng._params["wq"], tq.QuantizedWeight)


def test_midflight_preemption_is_exact(f32):
    """JAX's recipe: two short prompts that grow to 35 positions in a pool
    of 7 usable pages; the youngest slot is preempted mid-flight and its
    regenerated output is still exact, on both engines."""
    waves = [_requests(37, [(5, 30), (5, 30)])]
    ref, out, jeng, teng = _both(f32, waves, num_pages=8, burst=8)
    assert teng.stats["preemptions"] >= 1
    assert _counters(teng) == _counters(jeng)
    assert out == ref
    for (prompt, m), toks in zip(waves[0], out):
        assert toks == _generate(f32, prompt, m)
    assert teng.pages_in_use == 0


def _sys_reqs(seed=11, sys_pages=2, tails=(5, 3, 0, 9, 1)):
    """A system prompt of ``sys_pages`` full pages plus per-request tails
    (tail 0: the full-prefix duplicate, which resumes without a
    prefill)."""
    rng = np.random.RandomState(seed)
    sysp = rng.randint(1, 256, sys_pages * PS).tolist()
    return [(sysp + rng.randint(1, 256, n).tolist(), 6 + n % 5)
            for n in tails]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_prefix_sharing_tokens_and_counters_match_jax(f32, kv_dtype):
    """Shared-prompt traffic on ``"paged"`` (suffix prefills through
    ``llama_paged_prefill_suffix``, a full-prefix resume and its
    copy-on-write), one request joining per wave: the JAX engine's
    tokens and counters, and the unshared serve's tokens."""
    reqs = _sys_reqs()
    waves = [[r] for r in reqs]
    ref, out, jeng, teng = _both(f32, waves, kv_layout="paged",
                                 kv_dtype=kv_dtype, prefix_cache_pages=16)
    assert out == ref
    st = teng.stats
    assert st["prefix_hits"] >= 3 and st["prefix_resumes"] >= 1
    assert st["cow_copies"] >= 1
    assert _counters(teng) == _counters(jeng)
    _, tcfg, tparams = f32[1:]
    plain = ContinuousBatcher(tcfg, tparams, device="cpu",
                              kv_layout="paged", kv_dtype=kv_dtype,
                              **GEOMETRY)
    assert _serve(plain, waves) == out
    assert teng.pages_in_use == len(teng._prefix.cached_page_ids())


@pytest.mark.parametrize("draft_layers", [1, 2])
def test_speculation_tokens_and_counters_match_jax(f32, draft_layers):
    """``spec_decode=True, spec_k=3`` on ``"paged"`` (the gather verify):
    with a one-layer draft (rejections) and the self-draft (every
    proposal accepted), the JAX engine's tokens and counters, which equal
    plain greedy decode's."""
    reqs = _requests(15, [(6, 20), (13, 17), (3, 24)])
    ref, out, jeng, teng = _both(f32, [reqs], kv_layout="paged",
                                 spec_decode=True, spec_k=3,
                                 spec_draft_layers=draft_layers)
    assert out == ref
    st = teng.stats
    assert st["spec_steps"] >= 1
    if draft_layers == 2:
        assert st["spec_accepted"] == st["spec_proposed"] > 0
    assert _counters(teng) == _counters(jeng)
    for (prompt, m), toks in zip(reqs, out):
        assert toks == _generate(f32, prompt, m)
    assert teng.pages_in_use == 0


def test_moe_paged_tokens_identical_to_jax():
    """``LlamaConfig.tiny(num_experts=4)`` on ``"paged"``: every row the
    JAX engine routes (the prefill's pad rows, the free slots' decode
    rows) is routed the same, so the tokens are identical."""
    models = _pair(num_experts=4, num_experts_per_tok=2)
    ref, out, jeng, teng = _both(models, kv_layout="paged")
    assert out == ref
    assert _counters(teng) == _counters(jeng)


def test_three_layouts_agree_in_f32(f32):
    """The same traffic through ``"paged"``, ``"dense"`` and ``"ragged"``
    of the port: identical tokens."""
    _, _, tcfg, tparams = f32
    outs = {layout: _serve(ContinuousBatcher(tcfg, tparams, device="cpu",
                                             kv_layout=layout, **GEOMETRY),
                           WAVES)
            for layout in ("paged", "dense", "ragged")}
    assert outs["paged"] == outs["dense"] == outs["ragged"]


def _poison(engine):
    for bufs in engine._cache.values():
        for buf in bufs:
            if buf.dtype == torch.int8:
                buf.fill_(-128)
            else:
                buf.fill_(float("nan"))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_nan_pool_serves_the_clean_tokens(f32, kv_dtype):
    """Every page (scratch included) filled with NaN (int8 payloads with
    -128 beside NaN scales) before serving: the tokens equal the clean
    pool's, so no unwritten row reaches an output."""
    _, _, tcfg, tparams = f32
    outs = []
    for poison in (False, True):
        eng = ContinuousBatcher(tcfg, tparams, device="cpu",
                                kv_dtype=kv_dtype, **GEOMETRY)
        if poison:
            _poison(eng)
        outs.append(_serve(eng, WAVES))
        assert eng.pages_in_use == 0
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"),
                                dict(pool_hbm_bytes=1 << 20),
                                dict(prefix_cache_pages=8)])
def test_dense_layout_refuses_pool_options(f32, kw):
    _, _, tcfg, tparams = f32
    with pytest.raises(ValueError, match="paged|pool"):
        ContinuousBatcher(tcfg, tparams, device="cpu", kv_layout="dense",
                          **{**GEOMETRY, **kw})


def test_dense_layout_gates_speculation_and_has_no_pages(f32):
    _, _, tcfg, tparams = f32
    eng = ContinuousBatcher(tcfg, tparams, device="cpu", kv_layout="dense",
                            spec_decode=True, **GEOMETRY)
    assert eng._spec is None
    assert "dense" in eng.stats["spec_disabled"]
    assert eng.pages_in_use == 0
    with pytest.raises(ValueError, match="no pages"):
        eng.page_size


def test_page_buckets_argument_matches_jax(f32):
    """``page_buckets=(3, 5)`` (the slot's full width always joins): the
    JAX engine's bucket table and the buckets the traffic uses."""
    ref, out, jeng, teng = _both(f32, kv_layout="paged", page_buckets=(3, 5))
    assert teng._page_buckets == jeng._page_buckets == (3, 5, 12)
    assert out == ref
    assert teng.stats["page_buckets_used"] == jeng.stats["page_buckets_used"]


def test_weight_only_int8_dequantizes_one_layer_at_a_time(f32, monkeypatch):
    """``precision="int8"``: the engine keeps the quantized tree (about a
    quarter of the f32 bytes), and each dequantization it runs covers
    one layer's weights or the embeddings and head, never the whole
    model."""
    from paddle_tpu_torch.inference import serving
    _, _, tcfg, tparams = f32
    seen = []

    def spy(tree):
        seen.append(set(tree))
        return tq.weight_only_dequantize(tree)

    monkeypatch.setattr(serving, "weight_only_dequantize", spy)
    eng = ContinuousBatcher(tcfg, tparams, device="cpu", precision="int8",
                            **GEOMETRY)
    assert tq.tree_nbytes(eng._params) < 0.3 * tq.tree_nbytes(tparams)
    _serve(eng, WAVES[:1])
    layer_keys = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "ln1", "ln2"}
    assert seen and all(keys <= layer_keys or not keys & layer_keys
                        for keys in seen)
    assert any(keys == layer_keys for keys in seen)
    layer_calls = [k for k in seen if k == layer_keys]
    assert len(layer_calls) % tcfg.num_hidden_layers == 0


def test_chip_smoke_phase11_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's phase-11 runs (``paged_runs``: the gather layout
    over bf16, int8 and fp8 pages, the three layouts in f32, the dense
    layout in bf16, the prefix and speculative traffic on the gather
    layout, weight-only int8 on the gather and ragged layouts) on a tiny
    bf16 model on the CPU, every pool NaN-poisoned, with K1's plain
    version counted as a launch: every check passes but the ragged
    layout's K3/K4 counts, which count none here (the wrappers take their
    plain versions); the prefix counters equal phase 9's ragged run's;
    the f32 layouts give the same tokens; the weight-only tree holds
    about half bf16's bytes."""
    import dataclasses
    import importlib.util
    import pathlib
    from paddle_tpu_torch.ops import flash_attention as fa
    plain_fwd = fa.flash_forward

    def counted(*a, **k):
        fa.LAUNCHES["flash_fwd"] += 1
        return plain_fwd(*a, **k)

    monkeypatch.setattr(fa, "flash_forward", counted)
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = tl.LlamaConfig.tiny(num_hidden_layers=1, hidden_size=128,
                              num_attention_heads=1, num_key_value_heads=1,
                              dtype=torch.bfloat16)
    params = tl.init_params(cfg, seed=0, device="cpu")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: v.float() for k, v in params.items()}
    budget = 257 * tp.page_bytes(cfg, 16)
    runs = dict(cs.paged_runs(cfg, params, cfg32, params32, budget,
                              device="cpu"))
    assert len(runs) == 11
    for group, (cases, nums, _) in runs.items():
        if "ragged" in group:
            assert cases.pop("launches")[0] == 0, group
        bad = {c: v for c, v in cases.items()
               if not (np.isfinite(v[1]) and v[1] <= 1)}
        assert not bad, (group, bad)
    assert runs["paged bf16"][0]["launches"][0] == 8       # 1 layer
    assert runs["spec paged f32 self-draft"][0]["draft prefill"][0] == 8
    toks = {g: runs[f"{g} f32"][2] for g in ("paged", "dense", "ragged")}
    assert toks["paged"] == toks["dense"] == toks["ragged"]
    assert runs["paged bf16"][1]["page_buckets_used"]
    assert runs["dense bf16"][1]["page_buckets_used"] == []
    ragged = cs.prefix_leg(cfg, params, cfg32, params32, device="cpu")[1]
    got = runs["prefix paged bf16"][1]["stats"]
    assert {k: got.get(k, 0) for k in cs.PREFIX_COUNTERS} == \
        {k: ragged["stats"].get(k, 0) for k in cs.PREFIX_COUNTERS}
    assert runs["spec paged f32 self-draft"][1]["stats"]["acceptance"] == 1.0
    ratio = runs["precision int8 paged"][1]["weight_bytes"] \
        / tq.tree_nbytes(params)
    assert cs.WEIGHT_RATIO[0] <= ratio <= cs.WEIGHT_RATIO[1]

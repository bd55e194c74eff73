"""Speculative decoding on the PyTorch port's ragged engine against the
JAX package's (``ContinuousBatcher(kv_layout="ragged", spec_decode=True)``,
whose ragged Pallas kernel runs in interpret mode on the CPU), on the same
weights, at the engine geometry of ``tests/test_speculative.py``.

* ``accept_prefix``: the JAX package's six cases, each equal to the JAX
  function's result.
* ``draft_from_target``: the draft's layer tensors are views of the
  target's; ``draft_spec_burst`` proposes the JAX draft's tokens.
* Engine parity: spec == plain greedy == JAX spec == ``llama_generate``
  with a real (1-layer) draft, across rejections, a mid-flight
  preemption, a prefix-shared page and int8/fp8 pages; the self-draft
  accepts every proposal in f32; the ``spec_*`` counters equal the JAX
  engine's.
* Gates: temperature > 0 and k < 1 turn speculation off with the reason
  in ``stats["spec_disabled"]``; ``spec_decode=None`` means off (no
  environment knob yet); a draft that fails to build raises, and a draft
  precision is not ported.

Tolerance: greedy tokens identical (temperature 0, f32 model).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ContinuousBatcher as JaxBatcher
from paddle_tpu.inference import speculative as js
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import llama_init_params
from paddle_tpu_torch.inference import speculative as ts
from paddle_tpu_torch.inference.serving import ContinuousBatcher
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import llama_decode as td

GEOMETRY = dict(max_batch=3, max_len=96, prompt_buckets=(8, 16, 32),
                burst=4, page_size=8)
SPEC_STATS = ("spec_steps", "spec_slot_launches", "spec_proposed",
              "spec_accepted", "spec_emitted", "bursts", "preemptions",
              "prefix_hits", "prefix_resumes", "cow_copies")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig.tiny(num_hidden_layers=2, max_position_embeddings=128)
    jparams = llama_init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = tl.LlamaConfig.tiny(num_hidden_layers=2,
                               max_position_embeddings=128)
    tparams = tl.params_from_jax({k: np.asarray(v)
                                  for k, v in jparams.items()}, tcfg,
                                 device="cpu")
    return jcfg, jparams, tcfg, tparams


def _engines(models, **kw):
    jcfg, jparams, tcfg, tparams = models
    geo = {**GEOMETRY, **kw}
    return (JaxBatcher(jcfg, jparams, kv_layout="ragged", **geo),
            ContinuousBatcher(tcfg, tparams, device="cpu", **geo))


def _requests(seed, spec):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 256, n).tolist(), m) for n, m in spec]


def _serve(eng, reqs):
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in reqs]
    out = eng.run()
    return [out[r] for r in rids]


def _generate(models, prompt, n):
    _, _, tcfg, tparams = models
    return td.llama_generate(tparams, torch.tensor([prompt]), tcfg, n,
                             device="cpu")[0].tolist()


def _stats(eng):
    return {k: eng.stats.get(k, 0) for k in SPEC_STATS}


# ------------------------------------------------------------ accept walk
ACCEPT_CASES = {
    "full accept emits the bonus": (([5, 6, 7], [5, 6, 7, 9], 10, 100, -1),
                                    ([5, 6, 7, 9], 3, False)),
    "full reject emits the correction": (([5, 6, 7], [8, 1, 2, 3], 10, 100,
                                          -1), ([8], 0, False)),
    "mid reject": (([5, 6, 7], [5, 9, 1, 2], 10, 100, -1),
                   ([5, 9], 1, False)),
    "eos freezes mid segment": (([5, 2, 7], [5, 2, 7, 9], 10, 100, 2),
                                ([5, 2], 1, True)),
    "limit is plain decode's": (([5, 6, 7], [5, 6, 7, 9], 10, 12, -1),
                                ([5, 6], 1, True)),
    "no proposals is a decode step": (([], [4], 3, 100, -1),
                                      ([4], 0, False)),
}


@pytest.mark.parametrize("case", sorted(ACCEPT_CASES))
def test_accept_prefix(case):
    (props, targets, pos, limit, eos), want = ACCEPT_CASES[case]
    got = ts.accept_prefix(props, targets, pos=pos, limit=limit,
                           eos_id=eos)
    assert got == want
    assert got == js.accept_prefix(props, targets, pos=pos, limit=limit,
                                   eos_id=eos)


def test_seq_slice_matches_jax():
    parts = ([1, 2, 3, 4], [5, 6, 7])
    for a, b in ((0, 2), (1, 6), (4, 7), (3, 4), (5, 7)):
        assert ts._seq_slice(parts, a, b) == js._seq_slice(parts, a, b) \
            == ([1, 2, 3, 4] + [5, 6, 7])[a:b]


# ------------------------------------------------------------- draft model
def test_draft_from_target_returns_views(models):
    _, _, tcfg, tparams = models
    dparams, dcfg = ts.draft_from_target(tparams, tcfg, 1)
    assert dcfg.num_hidden_layers == 1 and tcfg.num_hidden_layers == 2
    assert dparams["wq"].shape[0] == 1
    for name in ("wq", "wk", "w_down", "ln1"):
        assert dparams[name].data_ptr() == tparams[name].data_ptr()
        assert dparams[name]._base is tparams[name]
    assert dparams["embed_tokens"] is tparams["embed_tokens"]
    sparams, scfg = ts.draft_from_target(tparams, tcfg, 2)
    assert sparams is tparams and scfg.num_hidden_layers == 2


def test_draft_spec_burst_matches_jax(models):
    """The draft's propose call over a dense cache: forced inputs first,
    then its own samples, one slot clamped at the overflow row."""
    jcfg, jparams, tcfg, tparams = models
    B, S1, n = 3, 21, 4
    rng = np.random.RandomState(5)
    rows = [rng.standard_normal((B, S1, tcfg.num_key_value_heads,
                                 tcfg.head_dim)).astype(np.float32)
            for _ in range(2 * tcfg.num_hidden_layers)]
    L = tcfg.num_hidden_layers
    jc = {"k": tuple(jnp.asarray(r) for r in rows[:L]),
          "v": tuple(jnp.asarray(r) for r in rows[L:])}
    tc = {"k": tuple(torch.from_numpy(r) for r in rows[:L]),
          "v": tuple(torch.from_numpy(r) for r in rows[L:])}
    pos = np.array([3, 0, 19], np.int32)
    inputs = rng.randint(1, 256, (B, n)).astype(np.int32)
    n_forced = np.array([2, 4, 1], np.int32)
    jc, jsamp = js.draft_spec_burst(jparams, jc, jnp.asarray(pos),
                                    jnp.asarray(inputs),
                                    jnp.asarray(n_forced), config=jcfg, n=n)
    tc, tsamp = ts.draft_spec_burst(tparams, tc, torch.from_numpy(pos),
                                    torch.from_numpy(inputs),
                                    torch.from_numpy(n_forced), tcfg, n)
    np.testing.assert_array_equal(tsamp.numpy(), np.asarray(jsamp))
    np.testing.assert_allclose(tc["v"][1].numpy(), np.asarray(jc["v"][1]),
                               rtol=0, atol=1e-4)


# ----------------------------------------------------------------- parity
SPEC = [(5, 7), (13, 3), (29, 12), (8, 1), (20, 6), (11, 9), (4, 8)]


def test_spec_matches_plain_jax_and_generate(models):
    """7 mixed requests through 3 slots with a real 1-layer draft: tokens
    do not change, and the counters equal the JAX engine's."""
    reqs = _requests(11, SPEC)
    kw = dict(spec_decode=True, spec_k=3, spec_draft_layers=1)
    jeng, eng = _engines(models, **kw)
    out = _serve(eng, reqs)
    assert out == _serve(jeng, reqs)
    _, plain = _engines(models)
    assert out == _serve(plain, reqs)
    for toks, (p, m) in zip(out, reqs):
        assert toks == _generate(models, p, m)
    st = eng.stats
    assert st["spec_steps"] >= 1
    assert _stats(eng) == _stats(jeng)
    assert eng.pages_in_use == 0
    assert eng._spec.summary()["k"] == 3


def test_self_draft_accepts_everything(models):
    """draft == target in f32 proposes exactly the target's continuation:
    every proposal is accepted and a verify launch emits more than one
    token per slot."""
    _, _, tcfg, _ = models
    reqs = _requests(23, [(6, 12), (9, 16), (14, 10)])
    jeng, eng = _engines(models, spec_decode=True, spec_k=3,
                         spec_draft_layers=tcfg.num_hidden_layers)
    out = _serve(eng, reqs)
    assert out == _serve(jeng, reqs)
    st = eng.stats
    assert st["spec_proposed"] > 0
    assert st["spec_accepted"] == st["spec_proposed"]
    assert st["spec_emitted"] / st["spec_slot_launches"] > 1.0
    assert _stats(eng) == _stats(jeng)
    for toks, (p, m) in zip(out, reqs):
        assert toks == _generate(models, p, m)


def test_midflight_preemption_is_exact(models):
    reqs = _requests(37, [(5, 30), (5, 30)])
    jeng, eng = _engines(models, num_pages=8, burst=8, spec_decode=True,
                         spec_k=3, spec_draft_layers=1)
    out = _serve(eng, reqs)
    assert out == _serve(jeng, reqs)
    assert eng.stats["preemptions"] >= 1 and eng.stats["spec_steps"] >= 1
    assert eng.stats["spec_accepted"] < eng.stats["spec_proposed"]
    for toks, (p, m) in zip(out, reqs):
        assert toks == _generate(models, p, m)
    assert eng.pages_in_use == 0
    assert _stats(eng) == _stats(jeng)


def test_cow_on_prefix_shared_page(models):
    """A full-prefix hit resumes inside a shared tail page, so the
    verify's first write would land in a page the index maps: the sweep
    copies it private first, the entry survives, a third serve still
    hits; tokens exact throughout."""
    rng = np.random.RandomState(61)
    prompt = rng.randint(1, 256, 16).tolist()             # 2 pages
    ref = _generate(models, prompt, 8)
    jeng, eng = _engines(models, spec_decode=True, spec_k=3,
                         spec_draft_layers=1, prefix_cache_pages=16)
    for e in (jeng, eng):
        for _ in range(3):
            assert _serve(e, [(prompt, 8)]) == [ref]
    assert eng.stats["prefix_resumes"] >= 1
    assert eng.stats["cow_copies"] >= 1
    assert eng.stats["prefix_hits"] >= 2
    assert eng.pages_in_use == eng._prefix.cached_pages
    assert _stats(eng) == _stats(jeng)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_pages_compose(models, kv_dtype):
    """Speculation over int8 / fp8 pages: verify writes and reads go
    through the quantized pool; spec == plain quantized serve == the JAX
    spec engine, token for token."""
    reqs = _requests(43, [(6, 8), (12, 6), (9, 10)])
    kw = dict(kv_dtype=kv_dtype, spec_decode=True, spec_k=3,
              spec_draft_layers=1)
    jeng, eng = _engines(models, **kw)
    out = _serve(eng, reqs)
    assert eng.stats["spec_steps"] >= 1
    assert out == _serve(jeng, reqs)
    _, plain = _engines(models, kv_dtype=kv_dtype)
    assert out == _serve(plain, reqs)
    assert _stats(eng) == _stats(jeng)


# ----------------------------------------------------------------- gating
@pytest.mark.parametrize("kw,why", [
    (dict(temperature=0.7), "temperature"),
    (dict(spec_k=0), "k=0"),
])
def test_gates_turn_speculation_off_with_a_reason(models, kw, why):
    jeng, eng = _engines(models, spec_decode=True, **kw)
    assert eng._spec is None and jeng._spec is None
    assert why in eng.stats["spec_disabled"]


def test_spec_off_unless_asked(models):
    """``spec_decode`` None or False: no draft, no reason; k and depth
    default to the JAX package's (4, half the layers)."""
    _, _, tcfg, tparams = models
    for flag in (None, False):
        _, eng = _engines(models, spec_decode=flag)
        assert eng._spec is None and "spec_disabled" not in eng.stats
    _, eng = _engines(models, spec_decode=True)
    assert eng._spec.k == ts.DEFAULT_K == 4
    assert eng._spec.draft_layers == 1


def test_draft_build_failure_raises(models, monkeypatch):
    """No catch-all around the draft build: a draft that cannot be built
    fails the engine's construction (the JAX engine serves on without a
    draft)."""
    def broken(*a, **k):
        raise RuntimeError("draft cache allocation failed")

    monkeypatch.setattr(td, "init_kv_cache", broken)
    with pytest.raises(RuntimeError, match="draft cache"):
        _engines(models, spec_decode=True, spec_k=2)[1]
    with pytest.raises(NotImplementedError, match="item 9"):
        ts.spec_from_env(models[2], models[3], max_batch=2, max_len=32,
                         prompt_buckets=(8,), temperature=0.0, paged=True,
                         spec_decode=True, precision="int8", device="cpu")


def test_chip_smoke_phase9_rehearses_on_cpu():
    """chip_smoke.py's phase-9 runs (the prefix traffic shared and not,
    over bf16 and int8 pages; the speculative traffic plain, with the
    self-draft and over int8 pages) on a tiny bf16 model on the CPU: every
    check passes except those that count kernel launches, which count
    none here (the wrappers take their plain versions), and sharing runs
    fewer prefill rows."""
    import dataclasses
    import importlib.util
    import pathlib
    from paddle_tpu_torch.models.llama_paged import page_bytes
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
    budget = 257 * page_bytes(cfg, 16)
    args = (cfg, params, cfg32, params32)
    runs = {"prefix bf16": cs.prefix_leg(*args, device="cpu"),
            "prefix unshared": cs.prefix_leg(*args, shared=False,
                                             device="cpu"),
            "prefix int8": cs.prefix_leg(*args, "int8", budget,
                                         device="cpu"),
            "spec plain": cs.spec_leg(*args, device="cpu"),
            "spec self-draft": cs.spec_leg(*args, 1, device="cpu"),
            "spec int8": cs.spec_leg(*args, 1, "int8", budget,
                                     device="cpu")}
    for group, (cases, nums) in runs.items():
        for case in ("launches", "verify launches", "draft prefill",
                     "suffix tile launch"):
            if case in cases:
                assert cases.pop(case)[0] == 0, (group, case)
        bad = {c: v for c, v in cases.items()
               if not (np.isfinite(v[1]) and v[1] <= 1)}
        assert not bad, (group, bad)
    assert runs["spec self-draft"][1]["stats"]["acceptance"] == 1.0
    assert runs["prefix bf16"][1]["prefill_rows"] \
        < runs["prefix unshared"][1]["prefill_rows"]
    assert runs["prefix int8"][1]["stats"]["prefix_hits"] >= 7

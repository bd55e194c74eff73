"""The PyTorch port's ContinuousBatcher (ragged paged path) against the
JAX package's ``ContinuousBatcher(kv_layout="ragged")`` on the same
weights, at the engine geometry of tests/test_ragged_attention.py: greedy
tokens must be identical for staggered mixed-length requests, and still
be under a mid-flight preemption forced by a small pool — with pages in
the model dtype and with int8 and fp8 pages (``kv_dtype``). Also the
port's device rules: with no GPU, every entry point raises unless the
caller passes ``device="cpu"``.

Quantized pages in a bf16 model: XLA and PyTorch round some bf16
products differently on the CPU (one bf16 ulp in a layer's K, even with
unquantized pages), and an int8 or fp8 code can flip on such an ulp. The
two engines then agree token for token wherever the top two logits are
further apart than that noise, as for every token of these requests;
other prompts on the same weights can meet a near-tie (one was found at a
top-two gap of 5.5e-5 on logits near 0.42) and part there.
"""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ContinuousBatcher as JaxBatcher
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import llama_init_params
from paddle_tpu_torch.inference.serving import ContinuousBatcher
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.llama_decode import llama_generate
from paddle_tpu_torch.models import llama_paged as tp
from paddle_tpu_torch.models.llama_paged import init_paged_kv_cache

GEOMETRY = dict(max_batch=3, max_len=96, prompt_buckets=(8, 16, 32),
                burst=4, page_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs tiny tensors here: intra-op threads cost more than
    they save and contend with the other test workers."""
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


def _requests(seed, spec):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 256, n).tolist(), m) for n, m in spec]


def _serve(engine, waves):
    """Add each wave of requests after one more scheduler step (staggered
    admission: later waves join bursts already decoding)."""
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


WAVES = [_requests(11, [(5, 9), (19, 6), (12, 14)]),
         _requests(12, [(30, 5), (3, 11)]),
         _requests(13, [(8, 7)])]


def test_staggered_tokens_identical_to_jax(models):
    jcfg, jparams, tcfg, tparams = models
    ref = _serve(JaxBatcher(jcfg, jparams, kv_layout="ragged", **GEOMETRY),
                 WAVES)
    eng = ContinuousBatcher(tcfg, tparams, device="cpu", **GEOMETRY)
    out = _serve(eng, WAVES)
    assert out == ref
    assert eng.pages_in_use == 0
    assert eng.stats["prefill_bursts"] >= 2
    # and each equals the dense single-stream oracle
    for (prompt, m), toks in zip([r for w in WAVES for r in w], out):
        alone = llama_generate(tparams, torch.tensor([prompt]), tcfg, m,
                               device="cpu")
        assert toks == alone[0].tolist()


def test_preemption_tokens_identical_to_jax(models):
    """A 9-page pool (8 usable pages of 8 rows) cannot hold three slots
    growing to ~40 positions each: the youngest is preempted mid-flight
    and regenerated, token-identically on both sides."""
    jcfg, jparams, tcfg, tparams = models
    waves = [_requests(21, [(14, 26), (20, 20), (9, 30)])]
    jeng = JaxBatcher(jcfg, jparams, kv_layout="ragged", num_pages=9,
                      **GEOMETRY)
    ref = _serve(jeng, waves)
    eng = ContinuousBatcher(tcfg, tparams, num_pages=9, device="cpu",
                            **GEOMETRY)
    out = _serve(eng, waves)
    assert eng.stats["preemptions"] > 0
    assert jeng.stats["preemptions"] > 0
    assert out == ref
    assert eng.pages_in_use == 0


def test_eos_retires_slot_early(models):
    _, _, tcfg, tparams = models
    (prompt, _), = _requests(31, [(6, 1)])
    full = llama_generate(tparams, torch.tensor([prompt]), tcfg, 12,
                          device="cpu")[0].tolist()
    eos = full[3]
    eng = ContinuousBatcher(tcfg, tparams, eos_id=eos, device="cpu",
                            **GEOMETRY)
    rid = eng.add_request(prompt, 12)
    out = eng.run()[rid]
    assert out == full[:full.index(eos) + 1]
    assert eng.pages_in_use == 0


def test_sampling_engine_is_seeded(models):
    """Temperature/top-k serving draws from the engine's own seeded
    torch.Generator: the same seed gives the same tokens."""
    _, _, tcfg, tparams = models

    def serve(seed):
        eng = ContinuousBatcher(tcfg, tparams, temperature=0.8, top_k=8,
                                seed=seed, device="cpu", **GEOMETRY)
        return _serve(eng, WAVES[:1])

    first = serve(5)
    assert first == serve(5)
    assert all(0 <= t < tcfg.vocab_size for toks in first for t in toks)


@pytest.mark.parametrize("live", [None, 0, 1, 8, 9, 95])
def test_page_accounting_matches_jax(models, live):
    from paddle_tpu.models import llama_paged as jp
    jcfg, _, tcfg, _ = models
    assert tp.page_bytes(tcfg, 8) == jp.page_bytes(jcfg, 8)
    assert tp.paged_kv_bytes_per_token(tcfg, 5, 8, live_tokens=live) == \
        jp.paged_kv_bytes_per_token(jcfg, 5, 8, live_tokens=live)
    for kv_dtype in ("int8", "fp8"):
        assert tp.page_bytes(tcfg, 8, kv_dtype) \
            == jp.page_bytes(jcfg, 8, kv_dtype=kv_dtype)


@pytest.mark.parametrize("kw,exc", [
    (dict(kv_layout="paged"), NotImplementedError),
    (dict(kv_layout="dense"), NotImplementedError),
    (dict(kv_layout="bogus"), ValueError),
    (dict(precision="int8"), NotImplementedError),
    (dict(precision="bfloat16"), NotImplementedError),
    (dict(admission=object()), NotImplementedError),
])
def test_unported_options_raise(models, kw, exc):
    _, _, tcfg, tparams = models
    with pytest.raises(exc):
        ContinuousBatcher(tcfg, tparams, device="cpu", **{**GEOMETRY, **kw})


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_staggered_tokens_identical_to_jax(models, kv_dtype):
    """int8 / fp8 pages, f32 model: the port's engine (K4's plain version
    on the CPU) emits the JAX engine's greedy tokens exactly, across
    staggered admissions, and drains its pool."""
    jcfg, jparams, tcfg, tparams = models
    ref = _serve(JaxBatcher(jcfg, jparams, kv_layout="ragged",
                            kv_dtype=kv_dtype, **GEOMETRY), WAVES)
    eng = ContinuousBatcher(tcfg, tparams, kv_dtype=kv_dtype, device="cpu",
                            **GEOMETRY)
    out = _serve(eng, WAVES)
    assert out == ref
    assert eng.pages_in_use == 0
    assert eng.stats["prefill_bursts"] >= 2
    assert eng._cache["k_scale"][0].dtype == torch.float32


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_preemption_tokens_identical_to_jax(models, kv_dtype):
    """The JAX package's quantized preemption recipe: two 30-token budgets
    over 7 usable pages with burst 8 force a mid-flight preemption on
    both sides; requantized restarts stay token-identical."""
    jcfg, jparams, tcfg, tparams = models
    geo = {**GEOMETRY, "burst": 8}
    waves = [_requests(41, [(5, 30), (5, 30)])]
    jeng = JaxBatcher(jcfg, jparams, kv_layout="ragged", kv_dtype=kv_dtype,
                      num_pages=8, **geo)
    ref = _serve(jeng, waves)
    eng = ContinuousBatcher(tcfg, tparams, kv_dtype=kv_dtype, num_pages=8,
                            device="cpu", **geo)
    out = _serve(eng, waves)
    assert eng.stats["preemptions"] >= 1 and jeng.stats["preemptions"] >= 1
    assert out == ref
    assert eng.pages_in_use == 0


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_bf16_tokens_identical_to_jax(kv_dtype):
    """A bf16 tiny model with int8 / fp8 pages: the staggered requests get
    the JAX engine's greedy tokens exactly (see the module docstring for
    why bf16 identity holds only where no two logits nearly tie)."""
    jcfg = JaxConfig.tiny(num_hidden_layers=2, max_position_embeddings=128,
                          dtype=jax.numpy.bfloat16)
    jparams = llama_init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = tl.LlamaConfig.tiny(num_hidden_layers=2,
                               max_position_embeddings=128,
                               dtype=torch.bfloat16)
    tparams = tl.params_from_jax({k: np.asarray(v)
                                  for k, v in jparams.items()}, tcfg,
                                 device="cpu")
    ref = _serve(JaxBatcher(jcfg, jparams, kv_layout="ragged",
                            kv_dtype=kv_dtype, **GEOMETRY), WAVES)
    eng = ContinuousBatcher(tcfg, tparams, kv_dtype=kv_dtype, device="cpu",
                            **GEOMETRY)
    assert _serve(eng, WAVES) == ref
    assert eng._cache["k"][0].dtype != torch.bfloat16


@pytest.mark.parametrize("spelling", [None, "", "off", "bf16", "native"])
def test_unquantized_spellings_have_no_scale_pools(models, spelling):
    _, _, tcfg, tparams = models
    eng = ContinuousBatcher(tcfg, tparams, kv_dtype=spelling, device="cpu",
                            **GEOMETRY)
    assert eng._kv_dtype is None
    assert set(eng._cache) == {"k", "v"}
    assert eng._cache["k"][0].dtype == tcfg.dtype


def test_kv_dtype_typo_raises(models):
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match="int9"):
        ContinuousBatcher(tcfg, tparams, kv_dtype="int9", device="cpu",
                          **GEOMETRY)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_pool_hbm_bytes_page_count_matches_jax(models, kv_dtype):
    """A byte budget buys the JAX engine's page count at each kv_dtype
    (this f32 model at head_dim 16: a row and kv head costs 64 bytes
    unquantized, 16 + 4 in int8 or fp8); passing num_pages too raises."""
    jcfg, jparams, tcfg, tparams = models
    budget = 37 * tp.page_bytes(tcfg, 8) + 5
    jeng = JaxBatcher(jcfg, jparams, kv_layout="ragged", kv_dtype=kv_dtype,
                      pool_hbm_bytes=budget, **GEOMETRY)
    eng = ContinuousBatcher(tcfg, tparams, kv_dtype=kv_dtype,
                            pool_hbm_bytes=budget, device="cpu", **GEOMETRY)
    assert eng._alloc.num_pages == jeng._alloc.num_pages
    assert eng._cache["k"][0].shape[0] == eng._alloc.num_pages
    with pytest.raises(ValueError, match="not both"):
        ContinuousBatcher(tcfg, tparams, kv_dtype=kv_dtype,
                          pool_hbm_bytes=budget, num_pages=8, device="cpu",
                          **GEOMETRY)


def test_impossible_requests_rejected_at_enqueue(models):
    _, _, tcfg, tparams = models
    eng = ContinuousBatcher(tcfg, tparams, device="cpu", **GEOMETRY)
    with pytest.raises(ValueError):
        eng.add_request([], 4)
    with pytest.raises(ValueError):
        eng.add_request(list(range(1, 40)), 4)     # over the largest bucket
    with pytest.raises(ValueError):
        eng.add_request([1, 2, 3], 95)             # over max_len
    with pytest.raises(ValueError):
        eng.add_request([1, 2, 3], 0)


def test_entry_points_need_cuda_unless_cpu_is_asked(models):
    """Without a GPU the default device (cuda) raises; nothing carries on
    on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    _, jparams, tcfg, tparams = models
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    toks = torch.tensor([[1, 2, 3]])
    with pytest.raises(RuntimeError, match="cuda"):
        tl.init_params(tcfg, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        tl.params_from_jax(np_params, tcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        llama_generate(tparams, toks, tcfg, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousBatcher(tcfg, tparams, **GEOMETRY)
    with pytest.raises(RuntimeError, match="cuda"):
        init_paged_kv_cache(tcfg, 4, 8)


def test_chip_smoke_serving_checks_rehearse_on_cpu():
    """chip_smoke.py's serving-phase checks (mid-flight admission, drained
    pool, bf16 teacher-forced tokens, the f32 engine against dense f32,
    the int8-page run with its codec-forced teacher and launch checks, and
    the f32 engine's int8 and fp8 pools read back against a dense f32
    forward) run end to end on a tiny bf16 model on the CPU, where the
    ragged wrapper takes its plain version and so counts no kernel
    launch — which the quantized run's check of K4's count must then
    refuse."""
    import dataclasses
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = tl.LlamaConfig.tiny(num_hidden_layers=1, hidden_size=128,
                              num_attention_heads=1, num_key_value_heads=1,
                              dtype=torch.bfloat16)
    params = tl.init_params(cfg, seed=0, device="cpu")
    engine, reqs, results, _, midflight, launches, _ = cs.serve(
        cfg, params, device="cpu")
    assert launches == 0 and midflight >= 2
    assert engine.pages_in_use == 0
    assert [len(r.out) for r in results] == [m for _, m in reqs]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: v.float() for k, v in params.items()}
    worst = cs.teacher_forced(cfg, params, cfg32, params32, reqs, results,
                              device="cpu")
    assert worst["gap_over_delta"] <= 1 and worst["first_err_over_tol"] <= 1
    assert cs.f32_serving_check(cfg32, params32, reqs, device="cpu") \
        <= cs.F32_DELTA
    budget = 40 * tp.page_bytes(cfg, 16)
    with pytest.raises(RuntimeError, match="K4 launches 0"):
        cs.quantized_serving(cfg, params, cfg32, params32, "int8", budget,
                             device="cpu")
    engine, reqs, results, _, _, launches, _ = cs.serve(
        cfg, params, device="cpu", kv_dtype="int8", pool_hbm_bytes=budget)
    assert launches == 0 and engine.pages_in_use == 0
    # head_dim 128: an int8 page costs (128 + 4) / (2·128) of a bf16 one
    assert engine._alloc.num_pages == 40 * 2 * 128 // 132
    worst = cs.teacher_forced(cfg, params, cfg32, params32, reqs, results,
                              device="cpu", kv_dtype="int8")
    assert worst["gap_over_delta"] <= 1 and worst["first_err_over_tol"] <= 1
    for kv_dtype in ("int8", "fp8"):
        worst = cs.f32_pool_check(cfg32, params32, reqs, kv_dtype,
                                  device="cpu")
        assert worst["gap"] <= cs.F32_DELTA
        assert worst["write"] <= 1 and worst["scale"] <= 1

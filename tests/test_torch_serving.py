"""The PyTorch port's ContinuousBatcher (ragged paged path) against the
JAX package's ``ContinuousBatcher(kv_layout="ragged")`` on the same
weights, at the engine geometry of tests/test_ragged_attention.py: greedy
tokens must be identical for staggered mixed-length requests, and still
be under a mid-flight preemption forced by a small pool. Also the port's
device rules: with no GPU, every entry point raises unless the caller
passes ``device="cpu"``.
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
    with pytest.raises(NotImplementedError, match="K4"):
        tp.page_bytes(tcfg, 8, kv_dtype="int8")


@pytest.mark.parametrize("kw,exc", [
    (dict(kv_layout="paged"), NotImplementedError),
    (dict(kv_layout="dense"), NotImplementedError),
    (dict(kv_layout="bogus"), ValueError),
    (dict(kv_dtype="int8"), NotImplementedError),
    (dict(precision="int8"), NotImplementedError),
    (dict(prefix_cache_pages=4), NotImplementedError),
    (dict(spec_decode=True), NotImplementedError),
])
def test_unported_options_raise(models, kw, exc):
    _, _, tcfg, tparams = models
    with pytest.raises(exc):
        ContinuousBatcher(tcfg, tparams, device="cpu", **{**GEOMETRY, **kw})


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
    pool, bf16 teacher-forced tokens, the f32 engine against dense f32)
    run end to end on a tiny bf16 model on the CPU, where the ragged
    wrapper takes its plain version and so counts no kernel launch."""
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

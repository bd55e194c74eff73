"""The MoE Llama family of the PyTorch port against the JAX package, on the
same weights (``params_from_jax``) and the same numpy-made inputs, at
``LlamaConfig.tiny(num_experts=4, num_experts_per_tok=2)`` in f32:
``_moe_block``, ``llama_forward``/``llama_loss`` and their gradients,
three ``LlamaTrainStep`` steps under a warmup-cosine schedule,
``llama_generate``, and the ragged ``ContinuousBatcher`` plain, with
speculative decoding and with prefix sharing. Also the ragged attention
rows of a prefill burst (every one of them reaches the router), three
planted faults in a copy of the port's routing that the parity check must
catch, and the rest of the training path: the learning-rate schedulers,
``remat="dots_noffn"`` and the ``llama2_13b`` preset.

Tolerances, each with its reason:

* ``_moe_block`` out: 1e-5 of the largest |out|: the same f32
  arithmetic, summed in another order, through products of length up to
  F = 128, whose f32 error is at most F·2^-24 ≈ 7.6e-6 of the sum of
  |terms|. aux: 1e-5 of |aux| (aux lies in [1, E]): a sum of means over
  n ≤ 120 rows, error at most n·2^-24 ≈ 7e-6 relative. A planted fault
  moves a token's output by its whole expert row.
* logits 1e-4 absolute, loss 1e-5, gradients 1e-4 of each tensor's
  max|g| (as ``test_torch_train_step.py``); trainer losses 1e-4 and
  parameters within 2·lr per element (Adam near eps, see that file).
* tokens and the burst's attention rows: identical tokens; rows within
  1e-5 (f32 attention of order-1 values).

Routing can flip where two router probabilities are within summation
noise of each other (~1e-7 here). Every routed comparison records the
smallest top-k margin it met — the gap between the k-th and (k+1)-th
probability, and between consecutive choices — and prints it, so that a
mismatch at a near-tie can be told apart from a fault.
"""
import dataclasses
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ContinuousBatcher as JaxBatcher
from paddle_tpu.models import llama as jl
from paddle_tpu.models import llama_decode as jd
from paddle_tpu.models import llama_paged as jp
from paddle_tpu.models.trainer import LlamaTrainStep as JStep
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.inference.serving import ContinuousBatcher
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import llama_decode as td
from paddle_tpu_torch.models import llama_paged as tp
from paddle_tpu_torch.models.trainer import (LlamaTrainStep,
                                             opt_state_from_jax)
from paddle_tpu_torch.optimizer import AdamW, Optimizer
from paddle_tpu_torch.optimizer import lr as tlr

MOE = dict(num_experts=4, num_experts_per_tok=2)
GEOMETRY = dict(max_batch=3, max_len=96, prompt_buckets=(8, 16, 32),
                burst=4, page_size=8)
LR = 3e-4
OUT_TOL = 1e-5          # of max|out|; see the module docstring
AUX_TOL = 1e-5          # of |aux|
MOE_KEYS = ("gate_w", "moe_w_gate", "moe_w_up", "moe_w_down")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: intra-op threads cost more than they save and
    contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    jcfg = jl.LlamaConfig.tiny(num_hidden_layers=2, **MOE, **kw)
    jparams = jl.llama_init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = tl.LlamaConfig.tiny(num_hidden_layers=2, **MOE, **kw)
    tparams = tl.params_from_jax({k: np.asarray(v)
                                  for k, v in jparams.items()}, tcfg,
                                 device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def models():
    return _pair()


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(1, 256, shape).astype(np.int32)


def _margin(probs, k):
    """The smallest gap among a row's k+1 largest probabilities: between
    consecutive choices (their order sets the first choice and the
    position order) and between the k-th and the first one left out."""
    top = torch.sort(probs.detach(), dim=-1,
                     descending=True).values[:, :k + 1]
    return float((top[:, :-1] - top[:, 1:]).min()) if len(top) else math.inf


class RouteSpy:
    """Wraps the port's ``_route``: counts the dropped assignments and the
    calls, and keeps the smallest top-k margin met."""

    def __init__(self, monkeypatch):
        self.dropped, self.calls, self.margin = 0, 0, math.inf
        self._route = tl._route
        monkeypatch.setattr(tl, "_route", self)

    def __call__(self, tokens, gate_w, config):
        out = self._route(tokens, gate_w, config)
        probs, keep = out[0], out[4]
        self.calls += 1
        self.dropped += int((~keep).sum())
        self.margin = min(self.margin,
                          _margin(probs, config.num_experts_per_tok))
        return out


# ------------------------------------------------------------- parameters
def test_moe_params_match_jax_layout(models):
    jcfg, jparams, tcfg, tparams = models
    assert set(tparams) == set(jparams)
    assert not {"w_gate", "w_up", "w_down"} & set(tparams)
    mine = tl.init_params(tcfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in jparams.items()}
    assert mine["gate_w"].dtype == torch.float32
    assert set(tl.split_layer_params(mine)[0]) >= set(MOE_KEYS)


def test_bf16_router_is_drawn_in_bf16_then_widened():
    cfg = tl.LlamaConfig.tiny(num_hidden_layers=1, dtype=torch.bfloat16,
                              moe_intermediate_size=32, **MOE)
    p = tl.init_params(cfg, seed=1, device="cpu")
    g = p["gate_w"]
    assert g.dtype == torch.float32
    assert torch.equal(g, g.to(torch.bfloat16).to(torch.float32))
    assert p["moe_w_down"].shape == (1, 4, 32, cfg.hidden_size)
    assert p["moe_w_gate"].dtype == torch.bfloat16


# ------------------------------------------------------------ _moe_block
def _block_case(name):
    """(x [B, T, D], router [D, E]) of one routing regime, made from
    numpy seeds: "spread" — the model's own std-0.02 router; "skewed" —
    every token picks experts 0 and 1, in either order, so both loads pass
    capacity, each expert holds first and second choices, and the
    choice-major order decides who is dropped; "floor" — 4 tokens,
    where the capacity is the floor of 4 (1.25·4·2/4 = 2.5)."""
    rng = np.random.RandomState({"spread": 1, "skewed": 2, "floor": 3}[name])
    B, T = {"spread": (3, 40), "skewed": (2, 24), "floor": (1, 4)}[name]
    D, E = 64, 4
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    gate = (rng.standard_normal((D, E)) * 0.02).astype(np.float32)
    if name != "spread":
        # a shared direction b draws every token to experts 0 and 1; the
        # token's own component along u (u ⟂ b) picks which comes first
        b = rng.standard_normal(D)
        u = rng.standard_normal(D)
        u -= (u @ b) / (b @ b) * b
        x += (2 * b).astype(np.float32)
        gate[:, 0] += (0.05 * (b + u)).astype(np.float32)
        gate[:, 1] += (0.05 * (b - u)).astype(np.float32)
    return x, gate


def _block_weights(models):
    _, jparams, _, _ = models
    return [np.array(jparams[k][0]) for k in MOE_KEYS[1:]]


def _block_parity(models, name, block=None):
    """(max |out − JAX| over max|JAX out|, |aux − JAX aux| over |JAX aux|,
    smallest top-k margin, dropped assignments) of ``block`` (the port's
    ``_moe_block`` by default) against the JAX package's on one case."""
    jcfg, _, tcfg, _ = models
    x, gate = _block_case(name)
    ws = _block_weights(models)
    ref, ref_aux = jl._moe_block(jnp.asarray(x), jnp.asarray(gate),
                                 *map(jnp.asarray, ws), jcfg)
    tx, tg = torch.from_numpy(x), torch.from_numpy(gate)
    out, aux = (block or tl._moe_block)(tx, tg, *map(torch.from_numpy, ws),
                                        tcfg)
    probs, _, _, _, keep, _ = tl._route(tx.reshape(-1, x.shape[-1]), tg,
                                        tcfg)
    ref = np.asarray(ref)
    err = float(np.abs(out.numpy() - ref).max() / np.abs(ref).max())
    return (err, abs(float(aux) - float(ref_aux)) / abs(float(ref_aux)),
            _margin(probs, tcfg.num_experts_per_tok), int((~keep).sum()))


@pytest.mark.parametrize("name", ["spread", "skewed", "floor"])
def test_moe_block_matches_jax(models, name):
    err, aux_err, margin, dropped = _block_parity(models, name)
    print(f"{name}: out err {err:.2e}, aux err {aux_err:.2e}, smallest "
          f"top-k margin {margin:.3e}, dropped {dropped}")
    assert err <= OUT_TOL, (err, margin)
    assert aux_err <= AUX_TOL, (aux_err, margin)
    if name == "skewed":
        assert dropped > 0          # capacity binds: order decides


def test_topk_breaks_ties_to_the_lower_expert():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.3, 0.3, 0.3]])
    vals, idx = tl._topk(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 2]]
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert np.asarray(ji).tolist() == idx.tolist()


# The faults a copy of the port's routing is given: (what, [(anchor,
# replacement)]); each anchor must occur in ``_route`` exactly once.
FAULTS = {
    "token-major positions": [
        ("experts.T.reshape(-1)", "experts.reshape(-1)"),
        ("pos.reshape(k, n).T", "pos.reshape(n, k)")],
    "capacity without its floor": [
        ("max(int(CAPACITY_FACTOR * n * k / E), 4)",
         "int(CAPACITY_FACTOR * n * k / E)")],
    "gates not renormalised": [
        ("gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), "
         "1e-9)", "gates = gates")],
}


def _faulty_block(fault):
    """A copy of the port's ``_moe_block`` whose ``_route`` carries
    ``fault``: both functions' source compiled into a copy of the module's
    namespace, so the module itself stays as it is."""
    src = inspect.getsource(tl._route)
    for anchor, repl in FAULTS[fault]:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, repl)
    ns = dict(vars(tl))
    exec(compile(src + "\n" + inspect.getsource(tl._moe_block),
                 "<faulty _moe_block>", "exec"), ns)
    return ns["_moe_block"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_parity_check_catches_planted_fault(models, fault):
    """The parity check of ``test_moe_block_matches_jax`` fails on each
    planted fault, on at least one of its cases."""
    block = _faulty_block(fault)
    errs = {name: _block_parity(models, name, block)[:2]
            for name in ("spread", "skewed", "floor")}
    assert any(e > OUT_TOL or a > AUX_TOL for e, a in errs.values()), errs


# --------------------------------------------------- forward, loss, grads
def test_forward_logits_and_aux_match_jax(models, monkeypatch):
    jcfg, jparams, tcfg, tparams = models
    spy = RouteSpy(monkeypatch)
    toks = _tokens(0, (2, 12))
    ref, ref_aux = jl.llama_forward(jparams, jnp.asarray(toks), jcfg,
                                    remat=False)
    out, aux = tl.llama_forward(tparams, torch.from_numpy(toks), tcfg)
    print(f"smallest top-k margin {spy.margin:.3e}")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-4)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert abs(float(aux) - float(ref_aux)) <= 1e-5
    assert 1.0 <= float(aux) <= 2 * tcfg.num_experts     # one per layer


@pytest.fixture(scope="module")
def loss_case(models):
    jcfg, jparams, tcfg, _ = models
    rng = np.random.RandomState(4)
    toks = rng.randint(0, 256, (2, 32)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    ref = {}
    for chunk in (None, 16):
        loss, grads = jax.value_and_grad(jl.llama_loss)(
            jparams, jnp.asarray(toks), jnp.asarray(labels), jcfg,
            remat=False, loss_chunk=chunk)
        ref[chunk] = (float(loss), {k: np.array(v) for k, v in grads.items()})
    return toks, labels, ref


@pytest.mark.parametrize("remat", [False, True, "dots_noffn"])
@pytest.mark.parametrize("chunk", [None, 16])
def test_loss_and_grads_match_jax(models, loss_case, remat, chunk,
                                  monkeypatch):
    _, jparams, tcfg, _ = models
    toks, labels, ref = loss_case
    spy = RouteSpy(monkeypatch)
    params = {k: v.requires_grad_() for k, v in tl.params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, tcfg,
        device="cpu").items()}
    loss = tl.llama_loss(params, torch.from_numpy(toks),
                         torch.from_numpy(labels), tcfg, remat=remat,
                         loss_chunk=chunk)
    loss.backward()
    ref_loss, ref_grads = ref[chunk]
    print(f"smallest top-k margin {spy.margin:.3e}")
    assert abs(loss.item() - ref_loss) < 1e-5
    assert set(ref_grads) == set(params)
    for k, g in ref_grads.items():
        np.testing.assert_allclose(params[k].grad.numpy(), g, rtol=0,
                                   atol=1e-4 * float(np.abs(g).max()),
                                   err_msg=k)
    # the router learns through the gates and the aux loss
    assert float(params["gate_w"].grad.abs().max()) > 0


# -------------------------------------------------------- LlamaTrainStep
def _warmup_cosine(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(LR, T_max=4),
                            warmup_steps=2, start_lr=LR / 10, end_lr=LR)


def test_train_steps_with_warmup_cosine_match_jax():
    jcfg = jl.LlamaConfig.tiny(num_hidden_layers=2, **MOE)
    tcfg = tl.LlamaConfig.tiny(num_hidden_layers=2, **MOE)
    jsched, tsched = _warmup_cosine(jlr), _warmup_cosine(tlr)
    jstep = JStep(jcfg, mesh=None, remat=True, seed=5, optimizer=JAdamW(
        learning_rate=jsched, weight_decay=0.1, moment_dtype=jnp.bfloat16))
    start = jax.tree.map(np.array, jstep.resilience_state())
    step = LlamaTrainStep(tcfg, remat=True, device="cpu", optimizer=AdamW(
        learning_rate=tsched, weight_decay=0.1, moment_dtype=torch.bfloat16))
    step.load_resilience_state({
        "params": tl.params_from_jax(start["params"], tcfg, device="cpu"),
        "opt_state": opt_state_from_jax(start["opt_state"], device="cpu"),
        "step": start["step"]})
    rng = np.random.RandomState(9)
    ref, got, lrs = [], [], []
    for _ in range(3):
        toks = rng.randint(0, 256, (2, 32)).astype(np.int32)
        labels = np.roll(toks, -1, axis=1)
        ref.append(float(jstep(toks, labels)))
        got.append(float(step(toks, labels)))
        lrs.append(step.optimizer.get_lr())
        assert lrs[-1] == jstep.optimizer.get_lr()
        jsched.step()
        tsched.step()
    assert len(set(lrs)) == 3                        # the rate moved
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    end = jax.tree.map(np.array, jstep.resilience_state())
    for k, want in end["params"].items():
        have = step.params[k].detach().to(torch.float32).numpy()
        diff = np.abs(have - np.asarray(want).astype(np.float32))
        assert diff.max() <= 2 * LR, k


# ------------------------------------------------------------- generate
@pytest.mark.parametrize("batch,prompt_len", [(1, 5), (3, 11)])
def test_generate_greedy_tokens_identical(models, batch, prompt_len,
                                          monkeypatch):
    jcfg, jparams, tcfg, tparams = models
    spy = RouteSpy(monkeypatch)
    toks = _tokens(prompt_len, (batch, prompt_len))
    ref = np.asarray(jd.llama_generate(jparams, jnp.asarray(toks), jcfg, 10,
                                       temperature=0.0))
    out = td.llama_generate(tparams, torch.from_numpy(toks), tcfg, 10,
                            device="cpu")
    print(f"smallest top-k margin {spy.margin:.3e}")
    np.testing.assert_array_equal(out.numpy(), ref)


# --------------------------------------------------------------- serving
def _requests(seed, spec):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 256, n).tolist(), m) for n, m in spec]


def _serve(engine, waves):
    """Add each wave of requests after one more scheduler step."""
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


def _engines(models, **kw):
    jcfg, jparams, tcfg, tparams = models
    geo = {**GEOMETRY, **kw}
    return (JaxBatcher(jcfg, jparams, kv_layout="ragged", **geo),
            ContinuousBatcher(tcfg, tparams, kv_layout="ragged", device="cpu",
                              **geo))


# staggered waves: later admissions prefill beside decoding slots, whose
# 32 lanes of the burst are q_len = 0 rows — identical rows that all pick
# the same two experts, so capacity binds in the prefill bursts
WAVES = [_requests(41, [(5, 9), (19, 6), (12, 14)]),
         _requests(42, [(30, 5), (3, 11)]),
         _requests(43, [(8, 7)])]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_ragged_engine_tokens_identical_when_capacity_binds(
        models, kv_dtype, monkeypatch):
    jeng, eng = _engines(models, kv_dtype=kv_dtype)
    ref = _serve(jeng, WAVES)
    spy = RouteSpy(monkeypatch)
    out = _serve(eng, WAVES)
    print(f"dropped assignments {spy.dropped} over {spy.calls} routed "
          f"calls; smallest top-k margin {spy.margin:.3e}")
    assert spy.dropped > 0
    assert out == ref
    assert eng.pages_in_use == 0
    assert eng.stats["prefill_bursts"] >= 2


SPEC = [(5, 7), (13, 3), (29, 12), (8, 1), (20, 6), (11, 9), (4, 8)]


def test_spec_decode_tokens_identical(models, monkeypatch):
    reqs = _requests(11, SPEC)
    kw = dict(spec_decode=True, spec_k=3, spec_draft_layers=1)
    jeng, eng = _engines(models, **kw)
    ref = _serve(jeng, [reqs])
    spy = RouteSpy(monkeypatch)
    out = _serve(eng, [reqs])
    print(f"smallest top-k margin {spy.margin:.3e}")
    assert out == ref
    assert eng.stats["spec_steps"] >= 1
    assert {k: v for k, v in eng.stats.items() if k.startswith("spec")} \
        == {k: v for k, v in jeng.stats.items() if k.startswith("spec")}
    assert eng.pages_in_use == 0


def test_prefix_sharing_tokens_identical(models, monkeypatch):
    rng = np.random.RandomState(12)
    sysp = rng.randint(1, 256, 16).tolist()         # two full pages
    reqs = [(sysp + rng.randint(1, 256, n).tolist(), 5 + n % 4)
            for n in (5, 3, 0, 9)]
    jeng, eng = _engines(models, prefix_cache_pages=16)
    ref = _serve(jeng, [reqs[:1], reqs[1:]])
    spy = RouteSpy(monkeypatch)
    out = _serve(eng, [reqs[:1], reqs[1:]])
    print(f"smallest top-k margin {spy.margin:.3e}")
    assert out == ref
    assert eng.stats["prefix_hits"] == jeng.stats["prefix_hits"] >= 2
    assert eng.stats["prefix_resumes"] >= 1


def test_draft_from_target_slices_the_moe_stacks(models):
    from paddle_tpu_torch.inference.speculative import draft_from_target
    _, _, tcfg, tparams = models
    draft, dcfg = draft_from_target(tparams, tcfg, 1)
    assert dcfg.num_hidden_layers == 1 and dcfg.num_experts == 4
    for k in MOE_KEYS:
        assert draft[k].shape == (1,) + tparams[k].shape[1:], k
        assert draft[k].data_ptr() == tparams[k].data_ptr(), k


@pytest.mark.parametrize("heads", [(4, 2), (8, 2)])
def test_prefill_burst_attention_rows_match_jax(heads):
    """``_ragged_attn`` as the prefill phase calls it — B=4 slots of
    Tmax=32 rows: a short prompt, a q_len=0 slot (kv_len 0: a decoding
    neighbour), a suffix after a shared prefix, a full-width prompt —
    every output row against the JAX package's kernel in interpret mode:
    rows past q_len attend every live key on both sides, and q_len=0
    slots are zeros. All of them reach the MoE router."""
    H, KV = heads
    hd, ps, P, Tmax = 16, 8, 12, 32
    rng = np.random.RandomState(H)
    q_lens = np.array([13, 0, 11, 32], np.int32)
    starts = np.array([0, 0, 16, 0], np.int32)
    kv_lens = starts + q_lens
    q = rng.standard_normal((4, Tmax, H, hd)).astype(np.float32)
    kp = rng.standard_normal((1 + 4 * P, ps, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((1 + 4 * P, ps, KV, hd)).astype(np.float32)
    bt = np.zeros((4, P), np.int32)
    for b in range(4):
        n = -(-int(kv_lens[b]) // ps)
        bt[b, :n] = 1 + b * P + np.arange(n)
    ref = np.asarray(jp._ragged_attn(
        *map(jnp.asarray, (q, kp, vp, bt, q_lens, kv_lens)), page_size=ps,
        interpret=True, mesh=None))
    out = tp._ragged_attn(*map(torch.from_numpy, (q, kp, vp, bt, q_lens,
                                                  kv_lens)), page_size=ps)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    assert not out[1].any() and out[0, 13:].abs().sum() > 0


# ------------------------------------------------------- learning rates
def _lambda(e):
    return 0.9 ** e


SCHEDULES = {
    "NoamDecay": lambda m: m.NoamDecay(64, 4, learning_rate=0.5),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 6], [0.1, 0.05, 0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, 0.3),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, 0.5),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, 5, power=2.0),
    "PolynomialDecay cycle": lambda m: m.PolynomialDecay(0.1, 4, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, 4, 0.0, 0.1),
    "LinearWarmup of a scheduler": _warmup_cosine,
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, 0.8),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [2, 5, 7], 0.5),
    "StepDecay": lambda m: m.StepDecay(0.1, 3, 0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, _lambda),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(0.1, _lambda),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.1, 6, 0.01),
    "CosineAnnealingWarmRestarts":
        lambda m: m.CosineAnnealingWarmRestarts(0.1, 3, T_mult=2),
    "LinearLR": lambda m: m.LinearLR(0.1, 6),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, 10),
    "OneCycleLR linear": lambda m: m.OneCycleLR(0.1, 10,
                                                anneal_strategy="linear"),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, 3),
    "CyclicLR triangular2": lambda m: m.CyclicLR(0.01, 0.1, 2, 3,
                                                 mode="triangular2"),
    "CyclicLR exp_range": lambda m: m.CyclicLR(0.01, 0.1, 2,
                                               mode="exp_range",
                                               exp_gamma=0.9),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_scheduler_sequence_matches_jax(name):
    ref, mine = SCHEDULES[name](jlr), SCHEDULES[name](tlr)
    assert type(mine).__name__ == type(ref).__name__
    seq, want = [], []
    for _ in range(14):
        seq.append(mine())
        want.append(ref())
        mine.step()
        ref.step()
    assert seq == want
    assert mine.state_dict() == ref.state_dict()


def test_reduce_on_plateau_matches_jax():
    ref = jlr.ReduceOnPlateau(0.1, patience=1, factor=0.5, cooldown=1)
    mine = tlr.ReduceOnPlateau(0.1, patience=1, factor=0.5, cooldown=1)
    for m in (1.0, 0.9, 0.95, 0.97, 0.99, 0.5, 0.6, 0.7, 0.8, None, 0.9):
        ref.step(m)
        mine.step(m)
        assert mine() == ref()
    assert mine() < 0.1


def test_every_scheduler_is_ported():
    assert sorted(tlr.__all__) == sorted(jlr.__all__)
    for name in jlr.__all__:
        assert issubclass(getattr(tlr, name), tlr.LRScheduler), name


def test_optimizer_reads_its_scheduler():
    sched = tlr.StepDecay(0.1, 1, 0.5)
    opt = AdamW(learning_rate=sched)
    assert opt.get_lr() == 0.1
    sched.step()
    assert opt.get_lr() == 0.05
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.2)
    plain = Optimizer(learning_rate=0.1)
    plain.set_lr(0.2)
    assert plain.get_lr() == 0.2
    with pytest.raises(TypeError, match="LRScheduler"):
        AdamW(learning_rate="0.1")


# -------------------------------------------------------- dots_noffn
@pytest.mark.parametrize("moe", [False, True])
def test_dots_noffn_same_loss_and_grads_saves_no_ffn_product(moe,
                                                             monkeypatch):
    """remat="dots_noffn" computes what remat=True computes, and its policy
    saves no product whose right operand's last dim is intermediate_size
    (the FFN's gate and up projections; for MoE the experts', at
    moe_intermediate_size = intermediate_size) while it saves the others."""
    cfg = tl.LlamaConfig.tiny(num_hidden_layers=2,
                              **(MOE if moe else {}))
    F = cfg.intermediate_size
    params = tl.init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(_tokens(5, (2, 16)))
    labels = torch.roll(toks, -1, 1)
    decisions = []
    save_dots = tl._save_dots

    def spy(no_save, ctx, op, *args, **kw):
        got = save_dots(no_save, ctx, op, *args, **kw)
        if op in tl._SAVED_OPS:
            decisions.append((no_save, tuple(args[-1].shape), got))
        return got

    monkeypatch.setattr(tl, "_save_dots", spy)
    results = {}
    for remat in (True, "dots_noffn"):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = tl.llama_loss(leaves, toks, labels, cfg, remat=remat)
        loss.backward()
        results[remat] = (loss.item(), {k: v.grad for k, v in leaves.items()})
    (l1, g1), (l2, g2) = results[True], results["dots_noffn"]
    assert l1 == l2
    for k in g1:
        torch.testing.assert_close(g1[k], g2[k], rtol=0, atol=1e-7)
    from torch.utils.checkpoint import CheckpointPolicy as CP
    noffn = [(s, d) for n, s, d in decisions if n == F]
    assert any(s[-1] == F for s, _ in noffn)
    assert all(d != CP.MUST_SAVE for s, d in noffn if s[-1] == F)
    assert any(d == CP.MUST_SAVE for s, d in noffn if s[-1] != F)
    assert any(d == CP.MUST_SAVE and s[-1] == F
               for n, s, d in decisions if n is None)


# ------------------------------------------------------------ presets
def test_llama2_13b_fields_equal_jax():
    def fields(cfg):
        return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                if f.name != "dtype"}

    assert fields(tl.LlamaConfig.llama2_13b()) == \
        fields(jl.LlamaConfig.llama2_13b())
    assert fields(tl.LlamaConfig.llama2_13b(num_hidden_layers=2)) == \
        fields(jl.LlamaConfig.llama2_13b(num_hidden_layers=2))
    assert fields(tl.LlamaConfig()) == fields(jl.LlamaConfig())


# ------------------------------------------------------- chip_smoke.py
def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_phase10_rehearses_on_cpu():
    """chip_smoke.py's phase-10 checks on a tiny bf16 MoE model at group 4
    on the CPU, where the ragged wrapper takes its plain version: the
    burst oracle holds (kernel and plain are one function here) with
    drops in the burst; the f32 engine and its plain-attention replay
    agree token for token, and then the launch check refuses, since no
    kernel launched; the routing replay flips nothing on equal inputs."""
    cs = _chip_smoke()
    cfg = tl.LlamaConfig.tiny(num_hidden_layers=1, hidden_size=128,
                              num_attention_heads=4, num_key_value_heads=1,
                              intermediate_size=64, dtype=torch.bfloat16,
                              **MOE)
    params = tl.init_params(cfg, seed=0, device="cpu")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: v.float() for k, v in params.items()}
    worst, drops = cs.moe_burst_oracle(cfg, params, cfg32, params32,
                                       device="cpu")
    assert worst == 0 and drops > 0
    with pytest.raises(RuntimeError, match="K3 launches 0"):
        cs.moe_engine_identity(cfg32, params32, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (1, 16, 128)).astype(np.float32))
    replay = cs.RouteReplay()
    lp = {k: v[0] for k, v in tl.split_layer_params(params32)[0].items()}
    with replay.record():
        a = tl._ffn(x, lp, cfg32)[0]
    for _ in range(2):
        with replay.replay() as flips:
            b = tl._ffn(x, lp, cfg32)[0]
        assert torch.equal(a, b)
        assert flips["flipped"] == 0 and flips["choices"] == 32
        cs.check_flips(flips, "rehearsal")


def test_chip_smoke_moe_block_share_attribution():
    """phase 10's attribution of a profiled step's device time to
    ``_moe_block``, on a hand-made event tree: the forward's kernels under
    "moe_block", the backward nodes that carry those ops' sequence numbers
    (and their children), the recompute's MoE part; not the layer's other
    forward ops, nor the recompute's attention, nor other backward nodes,
    nor the device-side copies of the kernels."""
    from torch.autograd import DeviceType
    cs = _chip_smoke()

    class Ev:
        def __init__(self, name, parent=None, seq=-1, dev=0.0,
                     device=DeviceType.CPU):
            self.name, self.cpu_parent, self.sequence_nr = name, parent, seq
            self.self_device_time_total, self.device_type = dev, device

    layer = Ev("decoder_layer")
    moe = Ev("moe_block", layer)
    fwd = [Ev("aten::bmm", moe, seq=7, dev=3000.0),
           Ev("aten::sort", moe, seq=8, dev=1000.0),
           Ev("aten::mm", layer, seq=5, dev=500.0)]         # attention
    ev = Ev("autograd::engine::evaluate_function: BmmBackward0")
    node = Ev("BmmBackward0", ev, seq=7)
    other = Ev("MmBackward0", Ev("autograd::engine::evaluate_function: "
                                  "MmBackward0"), seq=5)
    re_layer = Ev("decoder_layer", node)
    re_moe = Ev("moe_block", re_layer)
    bwd = [Ev("aten::bmm", node, seq=99, dev=6000.0),
           Ev("aten::mm", other, dev=800.0),
           Ev("aten::silu", re_moe, seq=3, dev=200.0),       # recompute
           Ev("flash_fwd", re_layer, dev=400.0),              # recompute
           Ev("kernel", dev=12000.0, device=DeviceType.CUDA)]
    ms, share = cs.moe_block_share(fwd + bwd, 12.0)
    assert ms == pytest.approx(10.2)          # 3 + 1 + 6 + 0.2 ms
    assert share == pytest.approx(10.2 / 12.0)

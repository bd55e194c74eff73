"""The training path of the PyTorch port against the JAX package:
``llama_loss`` and its gradients, ``_sr_cast``, ``AdamW.apply_gradients``
and ``LlamaTrainStep``, on the same weights (``params_from_jax``,
``opt_state_from_jax``) and the same numpy-made batches, at
``LlamaConfig.tiny(num_hidden_layers=2)`` in f32, B=2, T=32.

Tolerances, each with its reason:

* loss: 1e-5 absolute on a loss of ~5.5; gradients: 1e-4 × max|g| per
  tensor. Both packages run the same f32 arithmetic and differ in
  summation order and in the last ulp of sin/cos/rsqrt/exp (~1e-6 of
  the values after two layers); a wrong mask, remat or label moves them
  by order 1e-2 relative.
* ``_sr_cast``: bit-identical — it is a deterministic hash.
* ``apply_gradients``: f32 values within 1e-6 relative (+1e-9); bf16
  values within one bf16 ulp (2^-7 relative), because an f32 value one
  ulp off on one side (another summation or fused-multiply order) can
  round or dither to the neighbouring bf16 value.
* the five-step trajectory: losses within 1e-4; parameters within 2·lr
  per element and 0.02·lr on average per tensor. Adam's step is
  ≈ lr·g/(|g| + eps): where a gradient element is of the order of eps
  (a near-cancelling sum, or a rare token's embedding row) summation
  order alone can move it by up to lr per step. Elsewhere a moment one
  f32 ulp apart dithers to a bf16 value one ulp (0.4%) apart, which
  moves that element's step by ~0.4% of lr (measured: 0.4% of lr on
  average); a missing or doubled step would be off by lr everywhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as jl
from paddle_tpu.models.trainer import LlamaTrainStep as JStep
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu.optimizer import Adam as JAdam, AdamW as JAdamW
from paddle_tpu.optimizer.optimizers import _sr_cast as j_sr_cast
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.trainer import (LlamaTrainStep,
                                             opt_state_from_jax)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer.optimizers import _sr_cast

LR = 3e-4
B, T = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads cost more than they save and
    contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    return (jl.LlamaConfig.tiny(num_hidden_layers=2),
            tl.LlamaConfig.tiny(num_hidden_layers=2))


def _batch(seed):
    """tokens and next-token labels, a few of them −100 (ignored)."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 256, (B, T)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    labels[rng.rand(B, T) < 0.1] = -100
    return toks, labels


def _np(tree):
    return {k: np.array(v) for k, v in tree.items()}


def _bf16_np(t):
    return t.detach().to(torch.float32).numpy()


# ------------------------------------------------------------ loss, grads
@pytest.fixture(scope="module")
def loss_case():
    jcfg, tcfg = _configs()
    jparams = jl.llama_init_params(jcfg, jax.random.PRNGKey(7))
    toks, labels = _batch(0)
    ref = {}
    for chunk in (None, 16):
        loss, grads = jax.value_and_grad(jl.llama_loss)(
            jparams, jnp.asarray(toks), jnp.asarray(labels), jcfg,
            remat=False, loss_chunk=chunk)
        ref[chunk] = (float(loss), _np(grads))
    return tcfg, _np(jparams), toks, labels, ref


@pytest.mark.parametrize("remat", [False, True, "full"])
@pytest.mark.parametrize("chunk", [None, 16])
def test_loss_and_grads_match_jax(loss_case, remat, chunk):
    tcfg, np_params, toks, labels, ref = loss_case
    params = {k: v.requires_grad_() for k, v in
              tl.params_from_jax(np_params, tcfg, device="cpu").items()}
    loss = tl.llama_loss(params, torch.from_numpy(toks),
                         torch.from_numpy(labels), tcfg, remat=remat,
                         loss_chunk=chunk)
    loss.backward()
    ref_loss, ref_grads = ref[chunk]
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(loss.item() - ref_loss) < 1e-5
    assert set(ref_grads) == set(params)
    for k, g in ref_grads.items():
        np.testing.assert_allclose(params[k].grad.numpy(), g, rtol=0,
                                   atol=1e-4 * float(np.abs(g).max()),
                                   err_msg=k)


def test_chunked_loss_rejects_a_ragged_chunk(loss_case):
    tcfg, np_params, toks, labels, _ = loss_case
    params = tl.params_from_jax(np_params, tcfg, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        tl.llama_loss(params, torch.from_numpy(toks),
                      torch.from_numpy(labels), tcfg, loss_chunk=12)


# ---------------------------------------------------------------- _sr_cast
def _sr_inputs():
    rng = np.random.default_rng(11)
    tiny = np.finfo(np.float32).tiny
    parts = [rng.standard_normal(512).astype(np.float32),
             (rng.standard_normal(256) * 1e-3).astype(np.float32),
             np.array([0.0, -0.0, 1.0, -1.0], np.float32),
             # the bf16 overflow edge: bf16 max is 3.3895e38
             np.float32(3.39e38) * rng.uniform(0.99, 1.0, 64)
             .astype(np.float32),
             -np.float32(3.39e38) * rng.uniform(0.99, 1.0, 64)
             .astype(np.float32),
             # normals near the bottom, and f32 denormals
             (tiny * rng.uniform(0.0, 4.0, 64)).astype(np.float32),
             -(tiny * rng.uniform(0.0, 1.0, 64)).astype(np.float32),
             np.array([1e-45, -1e-45, 1e-40], np.float32)]
    return np.concatenate(parts)


@pytest.mark.parametrize("salt", [1, 2, 3])
@pytest.mark.parametrize("step", [1, 7, 2 ** 31 + 3])
def test_sr_cast_bit_identical_to_jax(step, salt):
    x = _sr_inputs()
    ref = np.array(j_sr_cast(jnp.asarray(x), jnp.bfloat16, step, salt))
    out = _sr_cast(torch.from_numpy(x), torch.bfloat16, step, salt)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.view(torch.int16).numpy()
                                  .view(np.uint16), ref.view(np.uint16))


def test_sr_cast_is_unbiased_on_average():
    """The point of the dither: over many steps the mean of the stored
    value tracks the f32 value, where round-to-nearest would not."""
    # values 1/8 of the way between the bf16 neighbours 1 and 1 + 2^-7,
    # each with other low bits (so other dithers)
    x = 1.0 + 2.0 ** -10 + torch.arange(4096) * 2.0 ** -23
    out = _sr_cast(x, torch.bfloat16, 1, 1).float()
    assert set(out.unique().tolist()) == {1.0, 1.0 + 2.0 ** -7}
    # round-to-nearest would give a mean 2^-10 low; the dither's mean
    # error is ~2^-7·0.33/64 ≈ 2^-14 (one standard deviation)
    assert abs(float((out - x).mean())) < 2.0 ** -12


# ------------------------------------------------------ apply_gradients
def _opt_case(pdtype, seed=3):
    rng = np.random.default_rng(seed)
    shapes = {"wq": (2, 16, 8), "norm": (8,), "embed_tokens": (10, 4)}
    params = {k: (rng.standard_normal(s) * 0.02).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    if pdtype == "bfloat16":      # values exactly representable in bf16
        cast = jnp.bfloat16
        params = {k: np.asarray(jnp.asarray(v, cast)) for k, v in
                  params.items()}
        grads = [{k: np.asarray(jnp.asarray(v, cast)) for k, v in
                  g.items()} for g in grads]
    return params, grads


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("mdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decoupled", [True, False], ids=["AdamW", "Adam"])
def test_adam_apply_gradients_matches_jax(decoupled, pdtype, mdtype, clip):
    """AdamW's decoupled decay, and Adam's L2 decay folded into the
    gradient, against the JAX package's update over two steps."""
    np_params, np_grads = _opt_case(pdtype)
    jcls, tcls = (JAdamW, AdamW) if decoupled else (JAdam, Adam)
    jopt = jcls(learning_rate=LR, weight_decay=0.1,
                moment_dtype=getattr(jnp, mdtype),
                grad_clip=JClip(clip) if clip else None)
    topt = tcls(learning_rate=LR, weight_decay=0.1,
                moment_dtype=getattr(torch, mdtype),
                grad_clip=ClipGradByGlobalNorm(clip) if clip else None)
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    js = jopt.init_state(jp)
    tp = {k: tl._to_torch(v) for k, v in np_params.items()}
    ts = topt.init_state(tp)
    for step, g in enumerate(np_grads, start=1):
        jp, js = jopt.apply_gradients({k: jnp.asarray(v) for k, v in
                                       g.items()}, jp, js,
                                      lr=jnp.float32(LR),
                                      step=jnp.int32(step))
        out_p, out_s = topt.apply_gradients(
            {k: tl._to_torch(v) for k, v in g.items()}, tp, ts, lr=LR,
            step=step)
        assert out_p is tp and out_s is ts          # updated in place
    for k in np_params:
        pairs = [("param", tp[k], jp[k])] + [
            (m, ts[k][m], js[k][m]) for m in ("moment1", "moment2")]
        for what, t, j in pairs:
            j = np.asarray(j)
            assert str(t.dtype)[6:] == j.dtype.name, (k, what)
            ref = j.astype(np.float32)
            rel = 2.0 ** -7 if j.dtype.name == "bfloat16" else 1e-6
            np.testing.assert_allclose(
                t.detach().to(torch.float32).numpy(), ref, rtol=rel,
                atol=1e-9, err_msg=f"{k} {what}")
    moved = np.abs(np.asarray(jp["wq"]).astype(np.float32)
                   - np_params["wq"].astype(np.float32))
    assert moved.mean() > LR                        # two real steps


def test_clip_by_global_norm_matches_jax():
    _, grads = _opt_case("float32")
    ref = JClip(1.0).clip_tree({k: jnp.asarray(v)
                                for k, v in grads[0].items()})
    out = ClipGradByGlobalNorm(1.0).clip_tree(
        {k: torch.from_numpy(v) for k, v in grads[0].items()})
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-9)


# -------------------------------------------------------- LlamaTrainStep
@pytest.fixture(scope="module")
def trajectory():
    """The JAX package's LlamaTrainStep: its initial weights and state,
    its state after step 3, and its five losses, on batches 0..4."""
    jcfg, tcfg = _configs()
    jopt = JAdamW(learning_rate=LR, weight_decay=0.1,
                  moment_dtype=jnp.bfloat16)
    jstep = JStep(jcfg, mesh=None, optimizer=jopt, remat=True, seed=5)
    start = jax.tree.map(np.array, jstep.resilience_state())
    batches = [_batch(10 + i) for i in range(5)]
    losses, at3 = [], None
    for i, (toks, labels) in enumerate(batches):
        losses.append(float(jstep(toks, labels)))
        if i == 2:
            at3 = jax.tree.map(np.array, jstep.resilience_state())
    end = jax.tree.map(np.array, jstep.resilience_state())
    return tcfg, start, at3, end, batches, losses


def _port_step(tcfg, state):
    step = LlamaTrainStep(tcfg, optimizer=AdamW(
        learning_rate=LR, weight_decay=0.1, moment_dtype=torch.bfloat16),
        remat=True, device="cpu")
    step.load_resilience_state({
        "params": tl.params_from_jax(state["params"], tcfg, device="cpu"),
        "opt_state": opt_state_from_jax(state["opt_state"], device="cpu"),
        "step": state["step"]})
    return step


def _params_close(step, ref_params):
    for k, ref in ref_params.items():
        diff = np.abs(_bf16_np(step.params[k])
                      - np.asarray(ref).astype(np.float32))
        assert diff.max() <= 2 * LR, k
        assert diff.mean() <= 0.02 * LR, k


def test_train_step_trajectory_matches_jax(trajectory):
    tcfg, start, _, end, batches, ref = trajectory
    step = _port_step(tcfg, start)
    losses = [step(toks, labels) for toks, labels in batches]
    assert all(isinstance(x, torch.Tensor) and x.dim() == 0 for x in losses)
    np.testing.assert_allclose([float(x) for x in losses], ref, rtol=0,
                               atol=1e-4)
    assert losses[-1] < losses[0]
    _params_close(step, end["params"])
    assert int(step.resilience_state()["step"]) == 5


def test_train_step_resumes_from_a_jax_state(trajectory):
    tcfg, _, at3, end, batches, ref = trajectory
    assert int(at3["step"]) == 3
    assert float(np.abs(at3["opt_state"]["wq"]["moment1"]
                        .astype(np.float32)).max()) > 0
    step = _port_step(tcfg, at3)
    losses = [float(step(toks, labels)) for toks, labels in batches[3:]]
    np.testing.assert_allclose(losses, ref[3:], rtol=0, atol=1e-4)
    _params_close(step, end["params"])


def test_train_step_rejects_what_is_not_ported():
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        LlamaTrainStep(tcfg, num_microbatches=2, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        AdamW(amsgrad=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        AdamW(multi_precision=True)
    # what is left of the training path's refusals: pipeline schedules,
    # the eager step() over a parameters list, an unknown remat schedule
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        LlamaTrainStep(tcfg, pp_schedule="1f1b", device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        AdamW(parameters=[torch.zeros(2)])
    with pytest.raises(ValueError, match="remat"):
        tl.llama_trunk(torch.zeros((1, 4, tcfg.hidden_size)), {}, tcfg,
                       remat="dots")

"""Llama forward, prefill/decode and greedy generate of the PyTorch port
against the JAX package, on the same weights (``params_from_jax``) and
the same numpy-made tokens, at ``LlamaConfig.tiny(num_hidden_layers=2)``
in f32.

Tolerance: 1e-4 absolute on logits of order 1. Both packages run the same
f32 arithmetic; they differ in summation order and in the last ulp of
sin/cos/rsqrt, ~1e-6 after two layers. Greedy tokens must be identical.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as jl
from paddle_tpu.models import llama_decode as jd
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import llama_decode as td

TOL = 1e-4
ROOT = pathlib.Path(__file__).resolve().parents[1]


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
    jcfg = jl.LlamaConfig.tiny(num_hidden_layers=2,
                               max_position_embeddings=128)
    jparams = jl.llama_init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = tl.LlamaConfig.tiny(num_hidden_layers=2,
                               max_position_embeddings=128)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    tparams = tl.params_from_jax(np_params, tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(1, 256, shape).astype(np.int32)


def test_params_from_jax_keeps_layout(models):
    jcfg, jparams, tcfg, tparams = models
    assert set(tparams) == set(jparams)
    for k, v in jparams.items():
        assert tuple(tparams[k].shape) == v.shape, k
        np.testing.assert_array_equal(tparams[k].numpy(), np.asarray(v))


def test_init_params_names_shapes_and_std(models):
    _, jparams, tcfg, _ = models
    p = tl.init_params(tcfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in jparams.items()}
    assert abs(float(p["wq"].std()) - 0.02) < 2e-3
    assert (p["ln1"] == 1).all() and p["norm"].dtype == torch.float32
    again = tl.init_params(tcfg, seed=0, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_forward_logits_match(models):
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(0, (2, 12))
    ref, _ = jl.llama_forward(jparams, jnp.asarray(toks), jcfg, remat=False)
    out = tl.llama_forward(tparams, torch.from_numpy(toks), tcfg)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


def test_prefill_then_decode_step_match(models):
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(1, (2, 9))
    jlog, jcache = jd.llama_prefill(jparams, jnp.asarray(toks), jcfg, 16)
    tlog, tcache = td.llama_prefill(tparams, torch.from_numpy(toks), tcfg,
                                    16)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=TOL)
    for l in range(tcfg.num_hidden_layers):
        np.testing.assert_allclose(tcache["k"][l].numpy(),
                                   np.asarray(jcache["k"][l]), rtol=0,
                                   atol=TOL)
    nxt = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)
    jlog2, jcache2 = jd.llama_decode_step(jparams, jcache, 9,
                                          jnp.asarray(nxt), jcfg)
    tlog2, tcache2 = td.llama_decode_step(tparams, tcache, 9,
                                          torch.from_numpy(nxt), tcfg)
    np.testing.assert_allclose(tlog2.numpy(), np.asarray(jlog2), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tcache2["v"][1].numpy(),
                               np.asarray(jcache2["v"][1]), rtol=0, atol=TOL)


@pytest.mark.parametrize("batch,prompt_len", [(1, 5), (2, 11)])
def test_generate_greedy_tokens_identical(models, batch, prompt_len):
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(prompt_len, (batch, prompt_len))
    ref = np.asarray(jd.llama_generate(jparams, jnp.asarray(toks), jcfg, 10,
                                       temperature=0.0))
    out = td.llama_generate(tparams, torch.from_numpy(toks), tcfg, 10,
                            device="cpu")
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_sampling_uses_the_given_generator(models):
    _, _, tcfg, tparams = models
    toks = torch.from_numpy(_tokens(2, (1, 6)))

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return td.llama_generate(tparams, toks, tcfg, 6, temperature=1.0,
                                 top_k=8, generator=g, device="cpu")

    assert torch.equal(draw(5), draw(5))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_paddle_tpu():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 8
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "paddle_tpu"), (f, mod)

"""The dense slot primitives (``llama_decode_step_slots``,
``llama_prefill_slot``, ``llama_decode_burst``) and the paged pool's
``copy_pages`` and ``llama_paged_verify`` (ragged read) of the PyTorch port
against the JAX package's, on the same weights (``params_from_jax``) and
the same numpy-made tokens and pools, at ``LlamaConfig.tiny
(num_hidden_layers=2)``.

Tolerances (logits of order 1, K/V rows of order 1):

* f32: 1e-4 absolute, as ``tests/test_torch_llama.py``: the same f32
  arithmetic in another summation order and the last ulp of sin/cos/rsqrt
  (~1e-6 after two layers). Greedy tokens identical.
* bf16 model: ``BF16_TOL`` = 2^-4 absolute. XLA and PyTorch round some
  bf16 products differently on the CPU (one bf16 ulp, 2^-8 relative, in a
  hidden state or a K/V row); two layers and the f32 lm head carry a few
  such ulps into logits of order 1. Tokens are compared only in f32.
* Quantized pools (int8, fp8): the verify's payloads are held as
  dequantized rows within one code step of each other (a K/V value that
  differs by f32 noise can round to the neighbouring code), scales to
  1e-4 relative in f32 and ``BF16_SCALE_RTOL`` = 2^-6 in bf16 (the scale
  is a row's absmax, which moves with its bf16 ulps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as jl
from paddle_tpu.models import llama_decode as jd
from paddle_tpu.models import llama_paged as jp
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import llama_decode as td
from paddle_tpu_torch.models import llama_paged as tp
from paddle_tpu_torch.quant.codec import dequantize_lastdim

TOL = 1e-4
BF16_TOL = 2.0 ** -4
BF16_SCALE_RTOL = 2.0 ** -6
PS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dtype):
    jcfg = jl.LlamaConfig.tiny(num_hidden_layers=2,
                               max_position_embeddings=128,
                               dtype=getattr(jnp, dtype))
    jparams = jl.llama_init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = tl.LlamaConfig.tiny(num_hidden_layers=2,
                               max_position_embeddings=128,
                               dtype=getattr(torch, dtype))
    tparams = tl.params_from_jax({k: np.asarray(v)
                                  for k, v in jparams.items()}, tcfg,
                                 device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    return _pair(request.param)


def _tol(cfg):
    return TOL if cfg.dtype == torch.float32 else BF16_TOL


def _np(t):
    return t.float().numpy()


def _close(t, j, tol):
    np.testing.assert_allclose(_np(t), np.asarray(j, np.float32), rtol=0,
                               atol=tol)


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(1, 256, shape).astype(np.int32)


def _dense_caches(jcfg, tcfg, B, S, seed):
    """The same dense slot cache on both sides, filled with N(0,1) rows."""
    rng = np.random.RandomState(seed)
    shape = (B, S, tcfg.num_key_value_heads, tcfg.head_dim)
    rows = [[rng.standard_normal(shape).astype(np.float32) for _ in "kv"]
            for _ in range(tcfg.num_hidden_layers)]
    jc = {n: tuple(jnp.asarray(r[i], jcfg.dtype) for r in rows)
          for i, n in enumerate("kv")}
    tc = {n: tuple(torch.from_numpy(r[i]).to(tcfg.dtype) for r in rows)
          for i, n in enumerate("kv")}
    return jc, tc


def test_init_kv_cache_matches(models):
    jcfg, _, tcfg, _ = models
    j = jd.init_kv_cache(jcfg, 3, 10)
    t = td.init_kv_cache(tcfg, 3, 10, device="cpu")
    assert [tuple(b.shape) for b in t["k"]] == [b.shape for b in j["k"]]
    assert t["v"][0].dtype == tcfg.dtype and not t["v"][1].any()


def test_decode_step_slots_match(models):
    """Per-slot positions (one of them 0, one the last row): logits and
    the written rows; rows the step does not write stay as they were."""
    jcfg, jparams, tcfg, tparams = models
    jc, tc = _dense_caches(jcfg, tcfg, 3, 12, seed=1)
    keep = tc["k"][0].clone()
    pos = np.array([5, 0, 11], np.int32)
    tok = _tokens(2, (3,))
    jlog, jc = jd.llama_decode_step_slots(jparams, jc, jnp.asarray(pos),
                                          jnp.asarray(tok), jcfg)
    tlog, tc = td.llama_decode_step_slots(tparams, tc,
                                          torch.from_numpy(pos),
                                          torch.from_numpy(tok), tcfg)
    assert tlog.dtype == torch.float32
    _close(tlog, jlog, _tol(tcfg))
    for n in "kv":
        for l in range(tcfg.num_hidden_layers):
            _close(tc[n][l], jc[n][l], _tol(tcfg))
    written = np.zeros(keep.shape[:2], bool)
    written[np.arange(3), pos] = True
    assert torch.equal(tc["k"][0][~torch.from_numpy(written)],
                       keep[~torch.from_numpy(written)])
    if tcfg.dtype == torch.float32:
        assert tlog.argmax(-1).tolist() == \
            np.asarray(jnp.argmax(jlog, -1)).tolist()


def test_prefill_slot_matches(models):
    """One bucket-padded prompt into slot 1: its first token and rows
    [0, bucket) of that slot; the other slots untouched."""
    jcfg, jparams, tcfg, tparams = models
    jc, tc = _dense_caches(jcfg, tcfg, 3, 24, seed=3)
    other = tc["v"][1][0].clone()
    toks = np.zeros(16, np.int32)
    toks[:11] = _tokens(4, (11,))
    jfirst, jc = jd.llama_prefill_slot(
        jparams, jc, jnp.asarray(toks), jnp.int32(1), jnp.int32(11),
        jax.random.PRNGKey(0), config=jcfg, max_len=24)
    tfirst, tc = td.llama_prefill_slot(tparams, tc, torch.from_numpy(toks),
                                       1, 11, config=tcfg)
    if tcfg.dtype == torch.float32:
        assert int(tfirst) == int(jfirst)
    for n in "kv":
        for l in range(tcfg.num_hidden_layers):
            _close(tc[n][l][1, :16], jc[n][l][1, :16], _tol(tcfg))
    assert torch.equal(tc["v"][1][0], other)
    with pytest.raises(ValueError):
        td.llama_prefill_slot(tparams, tc, torch.from_numpy(toks), 1, 17,
                              config=tcfg)


def test_decode_burst_matches():
    """Six scanned steps with per-slot limits, an eos and a finished slot:
    emissions, final slot state and the cache (f32)."""
    jcfg, jparams, tcfg, tparams = _pair("float32")
    jc, tc = _dense_caches(jcfg, tcfg, 3, 20, seed=5)
    pos = np.array([4, 9, 2], np.int32)
    tok = _tokens(6, (3,))
    done = np.array([False, False, True])
    limit = np.array([19, 12, 10], np.int32)
    # an eos that one slot emits mid-burst (from a dry run)
    probe = td.llama_decode_burst(
        tparams, {n: tuple(b.clone() for b in bufs) for n, bufs in
                  tc.items()}, torch.from_numpy(pos), torch.from_numpy(tok),
        torch.from_numpy(done), torch.from_numpy(limit), -1, tcfg, 6)[4]
    eos = int(probe[2, 0])
    jout = jd.llama_decode_burst(
        jparams, jc, jnp.asarray(pos), jnp.asarray(tok), jnp.asarray(done),
        jnp.asarray(limit), jnp.int32(eos), jax.random.PRNGKey(0),
        config=jcfg, n=6, pad_id=0)
    tout = td.llama_decode_burst(
        tparams, tc, torch.from_numpy(pos), torch.from_numpy(tok),
        torch.from_numpy(done), torch.from_numpy(limit), eos, tcfg, 6,
        pad_id=0)
    for t, j in zip(tout[1:], jout[1:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tout[3][0] and tout[3][1]          # eos, then the limit
    for n in "kv":
        for l in range(tcfg.num_hidden_layers):
            _close(tout[0][n][l], jout[0][n][l], TOL)


# ------------------------------------------------------------- paged pool
def _pools(jcfg, tcfg, num_pages, kv_dtype, seed):
    """The same page pool on both sides, every row filled (payload codes
    and scales from N(0,1) rows through the port's codec)."""
    from paddle_tpu_torch.quant.codec import quantize_lastdim
    rng = np.random.RandomState(seed)
    shape = (num_pages, PS, tcfg.num_key_value_heads, tcfg.head_dim)
    tc = {n: [] for n in ("k", "v", "k_scale", "v_scale")}
    for _ in range(tcfg.num_hidden_layers):
        for n in "kv":
            x = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32))
            if kv_dtype is None:
                tc[n].append(x.to(tcfg.dtype))
            else:
                pay, sc = quantize_lastdim(x, kv_dtype)
                tc[n].append(pay)
                tc[n + "_scale"].append(sc)
    tc = {n: tuple(v) for n, v in tc.items() if v}

    def to_jax(t):
        if t.dtype == torch.float8_e4m3fn:
            return jnp.asarray(t.view(torch.uint8).numpy()).view(
                jnp.float8_e4m3fn)
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.asarray(t.numpy())

    return {n: tuple(to_jax(b) for b in bufs) for n, bufs in tc.items()}, tc


def test_copy_pages_matches():
    jcfg, _, tcfg, _ = _pair("float32")
    for kv_dtype in (None, "int8", "fp8"):
        jc, tc = _pools(jcfg, tcfg, 6, kv_dtype, seed=7)
        jc = jp.copy_pages(jc, [2, 4], [5, 1])
        out = tp.copy_pages(tc, [2, 4], [5, 1])
        assert out is tc
        for n, bufs in tc.items():
            for t, j in zip(bufs, jc[n]):
                if t.dtype == torch.float8_e4m3fn:
                    t = t.view(torch.uint8)
                    j = np.asarray(j).view(np.uint8)
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            assert torch.equal(bufs[0][5], bufs[0][2])


VERIFY = dict(start=[13, 7, 0, 21], n_tok=[4, 1, 0, 2])


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_paged_verify_ragged_matches(models, kv_dtype):
    """Four slots at positions that are not page-aligned, with 4, 1, 0 and
    2 live rows of k+1 = 4: the greedy targets of the live rows (f32),
    every written row of pages 1.. (the scratch page takes the dead rows'
    writes in an unspecified order), and the untouched rows."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.RandomState(9)
    B, Tv, P = 4, 4, 6
    bt = np.zeros((B, P), np.int32)
    bt[:, :4] = rng.permutation(np.arange(1, 17))[:B * 4].reshape(B, 4)
    jc, tc = _pools(jcfg, tcfg, 17, kv_dtype, seed=11)
    start = np.array(VERIFY["start"], np.int32)
    n_tok = np.array(VERIFY["n_tok"], np.int32)
    toks = _tokens(12, (B, Tv))
    jt, jc = jp.llama_paged_verify(
        jparams, jc, jnp.asarray(bt), jnp.asarray(start), jnp.asarray(toks),
        jnp.asarray(n_tok), config=jcfg, ragged=True, kv_dtype=kv_dtype)
    tt, tc = tp.llama_paged_verify(
        tparams, tc, torch.from_numpy(bt), torch.from_numpy(start),
        torch.from_numpy(toks), torch.from_numpy(n_tok), config=tcfg,
        kv_dtype=kv_dtype)
    assert tt.dtype == torch.int32 and tt.shape == (B, Tv)
    live = np.arange(Tv)[None, :] < n_tok[:, None]
    if tcfg.dtype == torch.float32:
        np.testing.assert_array_equal(tt.numpy()[live], np.asarray(jt)[live])
    tol = _tol(tcfg)
    for l in range(tcfg.num_hidden_layers):
        for n in "kv":
            t, j = tc[n][l][1:], jc[n][l][1:]
            if kv_dtype is None:
                _close(t, j, tol)
                continue
            ts, js = tc[n + "_scale"][l][1:], jc[n + "_scale"][l][1:]
            rtol = TOL if tcfg.dtype == torch.float32 else BF16_SCALE_RTOL
            np.testing.assert_allclose(ts.numpy(), np.asarray(js),
                                       rtol=rtol, atol=0)
            step = ts.numpy()[..., None] * (1.0 if kv_dtype == "int8"
                                            else 32.0)
            jd_ = np.asarray(jp._kv_decode(j, js, jnp.float32))
            td_ = _np(dequantize_lastdim(t, ts, torch.float32))
            assert (np.abs(td_ - jd_) <= step * 1.0001 + tol).all()


def test_paged_verify_gather_read_not_ported():
    _, _, tcfg, tparams = _pair("float32")
    tc = tp.init_paged_kv_cache(tcfg, 4, PS, device="cpu")
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 4"):
        tp.llama_paged_verify(tparams, tc, torch.zeros((1, 2),
                                                       dtype=torch.int32),
                              z, torch.zeros((1, 3), dtype=torch.int32), z,
                              config=tcfg, ragged=False)

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
    _pools_close(tc, jc, tcfg, kv_dtype)


def _pools_close(tc, jc, tcfg, kv_dtype, pages=slice(1, None)):
    """Every row of ``pages`` (default: all but the scratch page, which
    takes dead writes in an unspecified order) on both sides: rows within
    the model's tolerance, or for quantized pools the scales within
    TOL / BF16_SCALE_RTOL relative and the dequantized rows within one
    code step."""
    tol = _tol(tcfg)
    if not isinstance(pages, slice):
        pages = np.asarray(pages)
    for l in range(tcfg.num_hidden_layers):
        for n in "kv":
            t, j = tc[n][l][pages], jc[n][l][pages]
            if kv_dtype is None:
                _close(t, j, tol)
                continue
            ts = tc[n + "_scale"][l][pages]
            js = jc[n + "_scale"][l][pages]
            rtol = TOL if tcfg.dtype == torch.float32 else BF16_SCALE_RTOL
            np.testing.assert_allclose(ts.numpy(), np.asarray(js),
                                       rtol=rtol, atol=0)
            step = ts.numpy()[..., None] * (1.0 if kv_dtype == "int8"
                                            else 32.0)
            jd_ = np.asarray(jp._kv_decode(j, js, jnp.float32))
            td_ = _np(dequantize_lastdim(t, ts, torch.float32))
            assert (np.abs(td_ - jd_) <= step * 1.0001 + tol).all()


def _verify_case(jcfg, tcfg, kv_dtype, seed):
    """The verify inputs of ``test_paged_verify_ragged_matches``: four
    slots over pages 1..16 of a filled pool, at unaligned starts."""
    rng = np.random.RandomState(9)
    B, Tv, P = 4, 4, 6
    bt = np.zeros((B, P), np.int32)
    bt[:, :4] = rng.permutation(np.arange(1, 17))[:B * 4].reshape(B, 4)
    jc, tc = _pools(jcfg, tcfg, 17, kv_dtype, seed=seed)
    return (bt, np.array(VERIFY["start"], np.int32),
            np.array(VERIFY["n_tok"], np.int32), _tokens(12, (B, Tv)), jc,
            tc)


def _verify_both(models, kv_dtype, seed=11):
    """The gather verify (``ragged=False``) on both sides: (port targets,
    JAX targets, port pools, JAX pools, n_tok)."""
    jcfg, jparams, tcfg, tparams = models
    bt, start, n_tok, toks, jc, tc = _verify_case(jcfg, tcfg, kv_dtype, seed)
    jt, jc = jp.llama_paged_verify(
        jparams, jc, jnp.asarray(bt), jnp.asarray(start), jnp.asarray(toks),
        jnp.asarray(n_tok), config=jcfg, ragged=False, kv_dtype=kv_dtype)
    tt, tc = tp.llama_paged_verify(
        tparams, tc, torch.from_numpy(bt), torch.from_numpy(start),
        torch.from_numpy(toks), torch.from_numpy(n_tok), config=tcfg,
        ragged=False, kv_dtype=kv_dtype)
    return tt, np.asarray(jt), tc, jc, n_tok


def test_paged_verify_gather_read_not_ported():
    """The gather read of ``llama_paged_verify`` (``ragged=False``, the
    ``"paged"`` layout's verify) against the JAX package's gather verify
    in f32 over pages in the model dtype, int8 and fp8: the live rows'
    greedy targets identical, every written row as JAX writes it."""
    models = _pair("float32")
    for kv_dtype in (None, "int8", "fp8"):
        tt, jt, tc, jc, n_tok = _verify_both(models, kv_dtype)
        live = np.arange(tt.shape[1])[None, :] < n_tok[:, None]
        assert tt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy()[live], jt[live])
        _pools_close(tc, jc, models[2], kv_dtype)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_paged_verify_gather_matches_ragged(models, kv_dtype):
    """The two read paths of the port's verify on the same pool: the live
    rows' targets agree (f32), and in bf16 too the pools they write are
    the same rows (one write path); also each against JAX's pools."""
    jcfg, jparams, tcfg, tparams = models
    tt, jt, tc, jc, n_tok = _verify_both(models, kv_dtype)
    bt, start, n_tok, toks, _, tr = _verify_case(jcfg, tcfg, kv_dtype, 11)
    rt, tr = tp.llama_paged_verify(
        tparams, tr, torch.from_numpy(bt), torch.from_numpy(start),
        torch.from_numpy(toks), torch.from_numpy(n_tok), config=tcfg,
        ragged=True, kv_dtype=kv_dtype)
    live = np.arange(tt.shape[1])[None, :] < n_tok[:, None]
    if tcfg.dtype == torch.float32:
        np.testing.assert_array_equal(tt.numpy()[live], rt.numpy()[live])
        np.testing.assert_array_equal(tt.numpy()[live], jt[live])
    for n, bufs in tc.items():
        for a, b in zip(bufs, tr[n]):
            assert torch.equal(a[1:].view(torch.uint8),
                               b[1:].view(torch.uint8)), n
    _pools_close(tc, jc, tcfg, kv_dtype)


def _tables(B, P, used, seed):
    """A [B, P] block table: ``used[b]`` distinct pages 1..16 per slot,
    the rest scratch (0)."""
    rng = np.random.RandomState(seed)
    ids = rng.permutation(np.arange(1, 17))
    bt = np.zeros((B, P), np.int32)
    k = 0
    for b, n in enumerate(used):
        bt[b, :n] = ids[k:k + n]
        k += n
    return bt


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_paged_decode_step_slots_match(models, kv_dtype):
    """One gather decode step over three slots (positions 5, 17 and 0 —
    a page boundary and a free slot on scratch) against JAX's: logits,
    and every written row of the pool (greedy tokens in f32)."""
    jcfg, jparams, tcfg, tparams = models
    jc, tc = _pools(jcfg, tcfg, 17, kv_dtype, seed=13)
    bt = _tables(3, 4, (1, 3, 0), seed=1)
    pos = np.array([5, 17, 0], np.int32)
    tok = _tokens(2, (3,))
    jlog, jc = jp._paged_decode_step_slots(
        jparams, jc, jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(tok),
        jcfg, kv_dtype=kv_dtype)
    tlog = tp._paged_decode_step_slots(
        tparams, tc, torch.from_numpy(bt), torch.from_numpy(pos),
        torch.from_numpy(tok), tcfg, kv_dtype=kv_dtype)
    assert tlog.dtype == torch.float32
    _close(tlog, jlog, _tol(tcfg))
    if tcfg.dtype == torch.float32:
        assert tlog.argmax(-1).tolist() == \
            np.asarray(jnp.argmax(jlog, -1)).tolist()
    _pools_close(tc, jc, tcfg, kv_dtype)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_paged_prefill_slot_matches(models, kv_dtype):
    """An 11-token prompt in a 24-row bucket over three pages: the first
    token (f32) and all three pages as JAX writes them, pad rows
    included; the other pages untouched."""
    jcfg, jparams, tcfg, tparams = models
    jc, tc = _pools(jcfg, tcfg, 17, kv_dtype, seed=15)
    keep = tc["k"][0][4].clone()
    toks = np.zeros(24, np.int32)
    toks[:11] = _tokens(4, (11,))
    pages = np.array([3, 9, 12], np.int32)
    jfirst, jc = jp.llama_paged_prefill_slot(
        jparams, jc, jnp.asarray(toks), jnp.asarray(pages), jnp.int32(11),
        jax.random.PRNGKey(0), config=jcfg, kv_dtype=kv_dtype)
    tfirst, tc = tp.llama_paged_prefill_slot(
        tparams, tc, torch.from_numpy(toks), torch.from_numpy(pages), 11,
        tcfg, kv_dtype=kv_dtype)
    if tcfg.dtype == torch.float32:
        assert int(tfirst) == int(jfirst)
    _pools_close(tc, jc, tcfg, kv_dtype, pages=list(pages))
    assert torch.equal(tc["k"][0][4], keep)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_paged_prefill_suffix_matches(models, kv_dtype):
    """A 10-token suffix at start 16 over two shared prefix pages (the
    prefix table padded with scratch to 4 pages): the first token (f32)
    and the suffix's pages as JAX writes them."""
    jcfg, jparams, tcfg, tparams = models
    jc, tc = _pools(jcfg, tcfg, 17, kv_dtype, seed=17)
    toks = np.zeros(16, np.int32)
    toks[:10] = _tokens(6, (10,))
    pages = np.array([5, 14], np.int32)
    ptbl = np.array([7, 2, 0, 0], np.int32)
    jfirst, jc = jp.llama_paged_prefill_suffix(
        jparams, jc, jnp.asarray(toks), jnp.asarray(pages),
        jnp.asarray(ptbl), jnp.int32(16), jnp.int32(10),
        jax.random.PRNGKey(0), config=jcfg, kv_dtype=kv_dtype)
    tfirst, tc = tp.llama_paged_prefill_suffix(
        tparams, tc, torch.from_numpy(toks), torch.from_numpy(pages),
        torch.from_numpy(ptbl), 16, 10, tcfg, kv_dtype=kv_dtype)
    if tcfg.dtype == torch.float32:
        assert int(tfirst) == int(jfirst)
    _pools_close(tc, jc, tcfg, kv_dtype, pages=list(pages))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_decode_burst_matches(kv_dtype):
    """Six gather steps with per-slot limits, an eos and a finished slot
    (f32): emissions and final slot state identical, the pool as JAX
    writes it."""
    jcfg, jparams, tcfg, tparams = _pair("float32")
    jc, tc = _pools(jcfg, tcfg, 17, kv_dtype, seed=19)
    bt = _tables(3, 4, (3, 4, 1), seed=2)
    pos = np.array([12, 25, 2], np.int32)
    tok = _tokens(6, (3,))
    done = np.array([False, False, True])
    limit = np.array([20, 28, 6], np.int32)
    probe = tp.llama_paged_decode_burst(
        tparams, {n: tuple(b.clone() for b in bufs)
                  for n, bufs in tc.items()}, torch.from_numpy(bt),
        torch.from_numpy(pos), torch.from_numpy(tok), torch.from_numpy(done),
        torch.from_numpy(limit), -1, None, tcfg, 6, kv_dtype=kv_dtype)[4]
    eos = int(probe[2, 0])
    jout = jp.llama_paged_decode_burst(
        jparams, jc, jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(tok),
        jnp.asarray(done), jnp.asarray(limit), jnp.int32(eos),
        jax.random.PRNGKey(0), config=jcfg, n=6, kv_dtype=kv_dtype)
    tout = tp.llama_paged_decode_burst(
        tparams, tc, torch.from_numpy(bt), torch.from_numpy(pos),
        torch.from_numpy(tok), torch.from_numpy(done),
        torch.from_numpy(limit), eos, None, tcfg, 6, kv_dtype=kv_dtype)
    for t, j in zip(tout[1:], jout[1:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tout[3][0] and tout[3][1]          # eos, then the limit
    _pools_close(tout[0], jout[0], tcfg, kv_dtype)


def test_gather_scatter_pages_round_trip():
    """``gather_pages`` reads JAX's page contents in logical order, on
    every leaf; ``scatter_pages`` writes them back into another pool
    exactly (and leaves a leaf it is not given alone)."""
    jcfg, _, tcfg, _ = _pair("float32")
    for kv_dtype in (None, "int8", "fp8"):
        jc, tc = _pools(jcfg, tcfg, 9, kv_dtype, seed=21)
        ids = [6, 2, 5]
        jrows = jp.gather_pages(jc, ids)
        trows = tp.gather_pages(tc, ids)
        assert set(trows) == set(jrows) == set(tc)
        for n, layers in trows.items():
            for t, j in zip(layers, jrows[n]):
                assert t.device.type == "cpu" and t.shape[0] == 3
                np.testing.assert_array_equal(
                    t.view(torch.uint8).numpy(),
                    np.asarray(j).view(np.uint8))
        other = tp.init_paged_kv_cache(tcfg, 9, PS, kv_dtype=kv_dtype,
                                       device="cpu")
        out = tp.scatter_pages(other, [1, 3, 8], trows)
        assert out is other
        for n, bufs in other.items():
            for a, b in zip(bufs, tc[n]):
                assert torch.equal(a[[1, 3, 8]].view(torch.uint8),
                                   b[ids].view(torch.uint8))
                assert not a[[2, 4, 5, 6, 7]].float().any()
        if kv_dtype is not None:
            kept = tp.init_paged_kv_cache(tcfg, 9, PS, kv_dtype=kv_dtype,
                                          device="cpu")
            tp.scatter_pages(kept, [1], {"k": [r[:1] for r in trows["k"]]})
            assert not kept["k_scale"][0].any()
        with pytest.raises(ValueError, match="layers"):
            tp.scatter_pages(other, [1], {"k": trows["k"][:1]})


def test_paged_dead_rows_do_not_leak():
    """NaN in every gathered row a slot may not see (past its position,
    in scratch, in the pages after its last) leaves the gather decode's
    logits finite and equal to the finite pool's: V rows at or past
    kv_len are zeroed before the product. Also the verify and suffix
    reads."""
    _, _, tcfg, tparams = _pair("float32")
    jcfg = _pair("float32")[0]
    bt = _tables(2, 4, (2, 3), seed=4)
    pos = np.array([9, 20], np.int32)
    tok = _tokens(8, (2,))
    outs = []
    for poison in (False, True):
        _, tc = _pools(jcfg, tcfg, 17, None, seed=23)
        if poison:
            for b, p in enumerate(pos):
                pages = bt[b, p // PS:]
                for l in range(tcfg.num_hidden_layers):
                    for n in "kv":
                        buf = tc[n][l]
                        buf[pages[0], p % PS:] = float("nan")
                        buf[pages[1:]] = float("nan")
                        buf[0] = float("nan")
        outs.append(tp._paged_decode_step_slots(
            tparams, tc, torch.from_numpy(bt), torch.from_numpy(pos),
            torch.from_numpy(tok), tcfg))
    assert torch.isfinite(outs[1]).all()
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    # suffix: the prefix table's scratch padding and its rows past start
    # poisoned
    firsts = []
    for poison in (False, True):
        _, tc = _pools(jcfg, tcfg, 17, None, seed=25)
        if poison:
            for bufs in (tc["k"], tc["v"]):
                for buf in bufs:
                    buf[0] = float("nan")
        toks = torch.from_numpy(_tokens(7, (8,)))
        firsts.append(tp.llama_paged_prefill_suffix(
            tparams, tc, toks, torch.tensor([5]), torch.tensor([3, 0, 0]),
            8, 8, tcfg)[0])
    assert int(firsts[0]) == int(firsts[1])

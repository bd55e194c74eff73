"""The PyTorch port's block codecs (``paddle_tpu_torch/quant/codec.py``)
and page accounting against the JAX package's, on the CPU.

The codec must write the payloads and scales the JAX engine writes, BIT
FOR BIT, on the same f32 or bf16 inputs: int8 and fp8, exact halves of
the int8 grid, values that saturate, all-zero blocks and tiny blocks.
The JAX side runs compiled (``jax.jit``), as the JAX serving burst runs
it: XLA turns the division by the constant ``qmax`` into a multiply by
its reciprocal, which the port follows (eager JAX divides; the two differ
by one f32 ulp in many scales, also pinned here). No tolerance anywhere.

Weight-only int8 (``paddle_tpu_torch/quantization``): the JAX engine runs
``weight_only_quantize`` eagerly in its constructor, so here the JAX side
runs eagerly too; int8 values, scales and dequantized weights are held
bit for bit in f32 and bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.paging import pages_for_budget as j_pages_for_budget
from paddle_tpu.models import llama as jl
from paddle_tpu.models import llama_paged as jp
from paddle_tpu.quant import codec as jc
from paddle_tpu_torch.inference.paging import pages_for_budget
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import llama_paged as tp
from paddle_tpu_torch.quant import codec as tc
from paddle_tpu_torch import quantization as tq

MODES = ("int8", "fp8")


def _blocks(seed, n=4000, width=16):
    """Rows of N(0,1) at magnitudes from 1e-20 to 1e3, with the special
    blocks first: all zero, one nonzero element, exact halves of the int8
    grid (x/scale lands on k + 0.5), huge and tiny values."""
    rng = np.random.RandomState(seed)
    mag = rng.choice([1e-20, 1e-3, 1.0, 50.0, 1e3], (n, 1))
    x = (rng.randn(n, width) * mag).astype(np.float32)
    x[0] = 0.0
    x[1] = 0.0
    x[1, 3] = -2.5
    # absmax 127 -> scale 1 in exact arithmetic: entries k + 0.5 are halves
    x[2] = np.arange(width, dtype=np.float32) + 0.5
    x[2, 0] = 127.0
    x[3] = np.float32(3.4e38) * np.sign(rng.randn(width)).astype(np.float32)
    x[4] = np.float32(1e-38)
    return x


def _jax_quant(x, mode):
    q, s = jax.jit(lambda a: jc.quantize_lastdim(a, mode))(x)
    return np.asarray(q), np.asarray(s)


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_quantize_bitwise_equal_to_jax(mode, in_dtype):
    x = _blocks(seed=1)
    xj = jnp.asarray(x).astype(in_dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, in_dtype))
    jq, js = _jax_quant(xj, mode)
    q, s = tc.quantize_lastdim(xt, mode)
    assert q.dtype == tc.wire_dtype(mode) and s.dtype == torch.float32
    assert q.shape == x.shape and s.shape == x.shape[:1]
    np.testing.assert_array_equal(_bits(q.view(torch.uint8).numpy()),
                                  _bits(jq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_dequantize_bitwise_equal_to_jax(mode, out_dtype):
    x = _blocks(seed=2)
    jq, js = _jax_quant(jnp.asarray(x), mode)
    ref = jc.dequantize_lastdim(jnp.asarray(jq), jnp.asarray(js),
                                getattr(jnp, out_dtype))
    q, s = tc.quantize_lastdim(torch.from_numpy(x), mode)
    out = tc.dequantize_lastdim(q, s, getattr(torch, out_dtype))
    np.testing.assert_array_equal(
        _bits(out.float().numpy()), _bits(np.asarray(ref.astype(jnp.float32))))


@pytest.mark.parametrize("mode", MODES)
def test_special_blocks(mode):
    """Zeros stay exact zeros, every value saturates onto the grid (never
    NaN, never past qmax), the int8 halves round to even, and an on-grid
    block round-trips exactly."""
    x = torch.from_numpy(_blocks(seed=3))
    q, s = tc.quantize_lastdim(x, mode)
    qmax = tc.MODES[mode][1]
    qf = q.float()
    assert torch.isfinite(qf).all() and (qf.abs() <= qmax).all()
    assert (qf[0] == 0).all() and torch.isfinite(s).all()
    back = tc.dequantize_lastdim(q, s)
    assert (back[0] == 0).all()
    if mode == "int8":
        # row 2 is k + 0.5 for k < 16 with scale 1: half to even
        expect = torch.round(torch.arange(16.0) + 0.5)
        expect[0] = 127.0
        assert torch.equal(qf[2], expect)
        # an on-grid block (integers times 0.25, absmax 127·0.25) gets
        # back exactly its integers
        ints = torch.arange(-127.0, 128.0, 17.0)
        ints[0] = -127.0
        q2, _ = tc.quantize_lastdim(ints[None] * 0.25, mode)
        assert torch.equal(q2[0].float(), ints)


def test_eager_jax_division_differs_by_an_ulp_at_most():
    """The one place the port follows compiled JAX over eager JAX: the
    scale. Eager JAX divides by qmax; the two scales differ, by at most one
    f32 ulp (in about half of these blocks)."""
    x = _blocks(seed=4)
    for mode in MODES:
        _, js = _jax_quant(jnp.asarray(x), mode)
        _, es = jc.quantize_lastdim(jnp.asarray(x), mode)
        d = np.abs(_bits(js).astype(np.int64) - _bits(np.asarray(es))
                   .astype(np.int64))
        assert d.max() == 1, mode


@pytest.mark.parametrize("raw,want", [
    (None, None), ("", None), ("0", None), ("off", None), ("bf16", None),
    ("BFloat16", None), (" native ", None), ("int8", "int8"),
    ("INT8", "int8"), (" fp8", "fp8"),
])
def test_normalize_kv_dtype_matches_jax(raw, want):
    assert tc.normalize_kv_dtype(raw) == want == jc.normalize_kv_dtype(raw)


@pytest.mark.parametrize("raw", ["int9", "fp16", "int4", "e4m3"])
def test_normalize_kv_dtype_rejects_typos(raw):
    with pytest.raises(ValueError, match=raw):
        tc.normalize_kv_dtype(raw)
    with pytest.raises(ValueError, match=raw):
        jc.normalize_kv_dtype(raw)


@pytest.mark.parametrize("raw", [None, "", "row", "PAGE", "pages"])
def test_normalize_scale_gran_matches_jax(raw):
    try:
        want = jc.normalize_scale_gran(raw)
    except ValueError:
        with pytest.raises(ValueError):
            tc.normalize_scale_gran(raw)
        return
    assert tc.normalize_scale_gran(raw) == want


def test_itemsizes_match_jax():
    for mode in MODES:
        assert tc.wire_itemsize(mode) == jc.wire_itemsize(mode) == 1
        assert str(tc.wire_dtype(mode)).split(".")[-1] \
            == jnp.dtype(jc.wire_dtype(mode)).name
    assert tc.scale_itemsize() == jc.scale_itemsize() == 4


CFG = dict(hidden_size=64, num_attention_heads=1, num_key_value_heads=1,
           num_hidden_layers=2)                      # head_dim 64


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_bytes_match_jax(dtype, kv_dtype):
    jcfg = jl.LlamaConfig.tiny(**CFG, dtype=getattr(jnp, dtype))
    tcfg = tl.LlamaConfig.tiny(**CFG, dtype=getattr(torch, dtype))
    assert tp.page_bytes(tcfg, 8, kv_dtype) \
        == jp.page_bytes(jcfg, 8, kv_dtype=kv_dtype)
    for live in (None, 0, 1, 8, 9, 95):
        assert tp.paged_kv_bytes_per_token(
            tcfg, 5, 8, live_tokens=live, kv_dtype=kv_dtype) \
            == jp.paged_kv_bytes_per_token(jcfg, 5, 8, live_tokens=live,
                                           kv_dtype=kv_dtype)


@pytest.mark.parametrize("hd", [64, 128])
def test_quantized_page_ratio_and_budget(hd):
    """A bf16 page costs 2·hd/(hd+4) times an int8 or fp8 one (scales
    included): 1.88 at head_dim 64, 1.94 at 128; the same byte budget buys
    the JAX package's page counts."""
    kw = dict(CFG, hidden_size=hd)
    jcfg = jl.LlamaConfig.tiny(**kw, dtype=jnp.bfloat16)
    tcfg = tl.LlamaConfig.tiny(**kw, dtype=torch.bfloat16)
    for mode in MODES:
        ratio = tp.page_bytes(tcfg, 16) / tp.page_bytes(tcfg, 16, mode)
        assert abs(ratio - 2 * hd / (hd + 4)) < 1e-12
        for budget in (1, 10 ** 6, 48 * tp.page_bytes(tcfg, 16),
                       80 * 2 ** 30):
            assert pages_for_budget(budget, tp.page_bytes(tcfg, 16, mode)) \
                == j_pages_for_budget(budget,
                                      jp.page_bytes(jcfg, 16, kv_dtype=mode))


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_init_paged_kv_cache_layout(kv_dtype):
    """The JAX package's pool layout: payload pools in the codec's dtype
    plus zeroed f32 scale pools; kv_dtype None has no scale pools."""
    jcfg = jl.LlamaConfig.tiny(num_hidden_layers=2)
    tcfg = tl.LlamaConfig.tiny(num_hidden_layers=2)
    ref = jp.init_paged_kv_cache(jcfg, 5, 8, kv_dtype=kv_dtype)
    got = tp.init_paged_kv_cache(tcfg, 5, 8, kv_dtype=kv_dtype, device="cpu")
    assert set(got) == set(ref)
    for name, bufs in ref.items():
        assert len(got[name]) == len(bufs)
        for g, r in zip(got[name], bufs):
            assert tuple(g.shape) == r.shape
            assert g.element_size() == r.dtype.itemsize
            assert not g.float().abs().sum()
    if kv_dtype is None:
        assert got["k"][0].dtype == tcfg.dtype
    else:
        assert got["k"][0].dtype == tc.wire_dtype(kv_dtype)
        assert got["k_scale"][0].dtype == torch.float32


def _weights(seed, dtype):
    """A params dict as the quantizer sees one: a layer-stacked matrix
    whose output channels span magnitudes 1e-3 to 10 (one all-zero
    channel), a plain matrix, one too small to quantize, a vector and an
    int matrix."""
    rng = np.random.RandomState(seed)
    w = (rng.standard_normal((3, 40, 64))
         * rng.uniform(1e-3, 10.0, (1, 1, 64))).astype(np.float32)
    w[:, :, 7] = 0.0
    return {"stacked": w,
            "matrix": rng.standard_normal((96, 48)).astype(np.float32),
            "small": rng.standard_normal((16, 16)).astype(np.float32),
            "vector": rng.standard_normal(4096).astype(np.float32),
            "ints": rng.randint(-5, 5, (64, 64)).astype(np.int32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_only_quantize_bit_for_bit(dtype):
    """int8 values and scales (in the weight's dtype, reduced axes kept as
    size-1 dims) and the dequantized weights equal the eager JAX
    function's bit for bit; the leaves it must not touch pass through."""
    from paddle_tpu import quantization as jq
    raw = _weights(3, dtype)
    jparams = {k: (jnp.asarray(v, getattr(jnp, dtype))
                   if v.dtype == np.float32 else jnp.asarray(v))
               for k, v in raw.items()}
    tparams = {k: (torch.from_numpy(v).to(getattr(torch, dtype))
                   if v.dtype == np.float32 else torch.from_numpy(v))
               for k, v in raw.items()}
    jout, tout = jq.weight_only_quantize(jparams), \
        tq.weight_only_quantize(tparams)
    for k in ("stacked", "matrix"):
        t, j = tout[k], jout[k]
        assert isinstance(t, tq.QuantizedWeight)
        assert t.int8.dtype == torch.int8 and t.scale.dtype == t.orig_dtype
        assert tuple(t.scale.shape) == tuple(j.scale.shape)
        np.testing.assert_array_equal(t.int8.numpy(), np.asarray(j.int8))
        np.testing.assert_array_equal(_bits(t.scale.view(torch.int16)
                                            if dtype == "bfloat16"
                                            else t.scale.numpy()),
                                      _bits(j.scale))
    for k in ("small", "vector", "ints"):
        assert tout[k] is tparams[k]
    jd = jq.weight_only_dequantize(jout)
    td = tq.weight_only_dequantize(tout)
    for k in ("stacked", "matrix"):
        assert td[k].dtype == tparams[k].dtype
        np.testing.assert_array_equal(
            _bits(td[k].view(torch.int16) if dtype == "bfloat16"
                  else td[k].numpy()), _bits(jd[k]))


def test_quantized_weight_slices_like_its_tensor():
    """``w[l]`` is layer l's int8 matrix beside the shared scale and
    dequantizes to the dense weight's layer l; ``w[:n]`` keeps the first
    n layers: what ``layer_slice`` and the draft's truncation take."""
    raw = _weights(4, "float32")
    w = torch.from_numpy(raw["stacked"])
    q = tq.weight_only_quantize({"w": w})["w"]
    full = q.dequantize()
    assert torch.equal(q[1].dequantize(), full[1])
    assert torch.equal(q[:2].dequantize(), full[:2])
    assert q[1].int8.shape == w[1].shape
    assert q.nbytes == w.numel() + 64 * 4
    assert tq.tree_nbytes({"w": q, "b": w[0]}) == q.nbytes + w[0].nbytes
    # int8 against f32: a quarter of the bytes, plus the scales
    assert q.nbytes / w.nbytes == pytest.approx(0.25, abs=0.01)

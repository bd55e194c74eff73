"""Ragged paged attention of the PyTorch port against the JAX package.

The port's ``ragged_paged_attention`` on CPU tensors runs its plain
PyTorch version; here it is held to the JAX kernel run as the JAX
package's own tests run it on the CPU (``interpret=True``), on the same
numpy inputs, for decode, ragged prefill, suffix and q_len=0 rows, at
groups 1 and 2: K3 in f32 over pools in the model dtype, K4's plain
version over int8 and fp8 pools with f32 scales, in f32 and bf16.

Tolerance: 1e-5 absolute on outputs of order 1 in f32. Both sides compute
f32 logits and an f32 softmax; they differ only in summation order (the
JAX package's own bitwise test already misses by 1.19e-7), so 1e-5 is
~100x that noise and far below any masking or indexing error (order 0.1).
In bf16 both sides dequantize to the same bf16 values and round the
probabilities and the output to bf16; an f32 summation-order difference
can flip the output's rounding by one bf16 ulp, at most 2^-7 of |out|:
each element is held to 2^-7 of its own |out| (plus 1e-6 for zeros).
On these inputs the two sides agree bit for bit, so the bound leaves
room only for such a flip, not for a missed rounding of the dequantized
K/V or of the probabilities (≈ 2^-9 of |out| on average, but over many
elements).
"""
import ast
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import ragged_attention as jra
from paddle_tpu.quant import codec as jc
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.models.llama_decode import _cached_attention_slots
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import ragged_attention as tra

TOL = 1e-5
PS, PMAX, HD = 8, 5, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs tiny tensors here: intra-op threads cost more than
    they save and contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(kind, groups, seed, nan_fill=False, with_dead=False):
    """Random pool + block table for one row kind; dead rows (past kv_len
    in a live page, unmapped pages, the scratch page) hold NaN when
    ``nan_fill`` and zeros otherwise. ``with_dead`` also returns the dead
    rows' mask [num_pages, page_size]."""
    rng = np.random.RandomState(seed)
    KV = 2
    H = KV * groups
    if kind == "decode":
        q_lens = np.array([1, 1, 1], np.int32)
        kv_lens = np.array([3, 17, 40], np.int32)
    elif kind == "prefill":
        q_lens = np.array([5, 12, 0], np.int32)
        kv_lens = np.array([5, 12, 9], np.int32)
    else:  # suffix rows: kv_len > q_len > 1
        q_lens = np.array([3, 7, 1], np.int32)
        kv_lens = np.array([19, 15, 30], np.int32)
    B = len(q_lens)
    q_max = int(q_lens.max())
    npool = 1 + B * PMAX
    fill = np.nan if nan_fill else 0.0
    kp = np.full((npool, PS, KV, HD), fill, np.float32)
    vp = np.full((npool, PS, KV, HD), fill, np.float32)
    bt = np.zeros((B, PMAX), np.int32)           # unmapped -> scratch 0
    dead = np.ones((npool, PS), bool)
    page = 1
    for b in range(B):
        for j in range(-(-int(kv_lens[b]) // PS)):
            bt[b, j] = page
            live = min(PS, int(kv_lens[b]) - j * PS)
            kp[page, :live] = rng.randn(live, KV, HD)
            vp[page, :live] = rng.randn(live, KV, HD)
            dead[page, :live] = False
            page += 1
    q = rng.randn(B, q_max, H, HD).astype(np.float32)
    if with_dead:
        return (q, kp, vp, bt, q_lens, kv_lens), dead
    return q, kp, vp, bt, q_lens, kv_lens


def _port(q, kp, vp, bt, q_lens, kv_lens):
    out = tra.ragged_paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(q_lens),
        torch.from_numpy(kv_lens), page_size=PS)
    return out.numpy()


def _jax(q, kp, vp, bt, q_lens, kv_lens):
    return np.asarray(jra.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(q_lens), jnp.asarray(kv_lens), page_size=PS,
        interpret=True))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("kind", ["decode", "prefill", "suffix"])
def test_matches_jax_interpret(kind, groups):
    args = _case(kind, groups, seed=groups * 10 + len(kind))
    ref = _jax(*args)
    out = _port(*args)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    q_lens = args[4]
    for b in np.flatnonzero(q_lens == 0):
        assert (out[b] == 0).all()          # q_len = 0 slot: zeros


@pytest.mark.parametrize("kind", ["decode", "prefill", "suffix"])
def test_nan_dead_rows_never_leak(kind):
    """NaN in every dead pool row (the tail of each live page, unmapped
    pages, the scratch page) gives the same, finite output as zeros
    there — the port zeroes V rows at or past kv_len."""
    clean = _port(*_case(kind, 2, seed=7))
    poisoned = _port(*_case(kind, 2, seed=7, nan_fill=True))
    assert np.isfinite(poisoned).all()
    np.testing.assert_array_equal(poisoned, clean)


def test_decode_rows_match_cached_attention_oracle():
    """q_len=1 rows equal the port's dense decode oracle over the pages
    gathered through the block table."""
    cfg = LlamaConfig.tiny()                       # H=4, KV=2, hd=16
    q, kp, vp, bt, q_lens, kv_lens = _case("decode", 2, seed=3)
    out = _port(q, kp, vp, bt, q_lens, kv_lens)
    B = len(q_lens)
    kc = torch.from_numpy(kp)[torch.from_numpy(bt).long()].reshape(
        B, -1, 2, HD)
    vc = torch.from_numpy(vp)[torch.from_numpy(bt).long()].reshape(
        B, -1, 2, HD)
    ref = _cached_attention_slots(torch.from_numpy(q), kc, vc,
                                  torch.from_numpy(kv_lens - 1), cfg)
    np.testing.assert_allclose(out, ref.numpy(), rtol=0, atol=TOL)


def _quant_case(kind, groups, seed, mode, nan_fill=False):
    """``_case`` with its pools quantized per (row, kv head) by the JAX
    package's compiled codec (the bits the JAX engine writes; the port's
    codec writes the same, tests/test_torch_quant.py). With ``nan_fill``
    every dead row holds a poisoned payload (fp8: NaN, 0x7F; int8: -128,
    off the grid) and a NaN scale."""
    (q, kp, vp, bt, ql, kl), dead = _case(kind, groups, seed, with_dead=True)
    enc = jax.jit(lambda x: jc.quantize_lastdim(x, mode))
    pools = []
    for pool in (kp, vp):
        pay, sc = (np.array(a) for a in enc(jnp.asarray(pool)))
        if nan_fill:
            pay.view(np.uint8)[dead] = 0x7F if mode == "fp8" else 0x80
            sc[dead] = np.nan
        pools += [pay, sc]
    return q, pools, bt, ql, kl


def _quant_port(q, pools, bt, ql, kl, dtype):
    kq, ks, vq, vs = pools

    def pay(a):            # the numpy payload's bytes as torch's dtype
        dt = torch.int8 if a.dtype == np.int8 else torch.float8_e4m3fn
        return torch.from_numpy(a.view(np.uint8)).view(dt)

    out = tra.ragged_paged_attention(
        torch.from_numpy(q).to(dtype), pay(kq), pay(vq),
        torch.from_numpy(bt), torch.from_numpy(ql), torch.from_numpy(kl),
        page_size=PS, k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs))
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("kind,groups", [("decode", 1), ("prefill", 2),
                                         ("suffix", 2), ("decode", 2)])
def test_quantized_matches_jax_interpret(kind, groups, mode, dtype):
    """K4's plain version against the JAX package's quantized kernel
    (``_kernel_body_quant``) in interpret mode, same payloads and scales."""
    q, pools, bt, ql, kl = _quant_case(kind, groups, seed=groups + 5, mode=mode)
    kq, ks, vq, vs = pools
    ref = np.asarray(jra.ragged_paged_attention(
        jnp.asarray(q).astype(dtype), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(bt), jnp.asarray(ql), jnp.asarray(kl), page_size=PS,
        interpret=True, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        .astype(jnp.float32))
    out = _quant_port(q, pools, bt, ql, kl, getattr(torch, dtype))
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    else:                                   # one bf16 ulp of each element
        np.testing.assert_allclose(out, ref, rtol=2.0 ** -7, atol=1e-6)
    for b in np.flatnonzero(ql == 0):
        assert (out[b] == 0).all()          # q_len = 0 slot: zeros


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("kind", ["decode", "prefill", "suffix"])
def test_quantized_nan_dead_rows_never_leak(kind, mode):
    """Poisoned payloads and NaN scales in every dead row (the tail of
    each live page, unmapped pages, the scratch page) give the same,
    finite output as clean dead rows."""
    for dtype in (torch.float32, torch.bfloat16):
        clean = _quant_port(*_quant_case(kind, 2, seed=7, mode=mode),
                            dtype=dtype)
        poisoned = _quant_port(*_quant_case(kind, 2, seed=7, mode=mode,
                                            nan_fill=True), dtype=dtype)
        assert np.isfinite(poisoned).all()
        np.testing.assert_array_equal(poisoned, clean)


@pytest.mark.parametrize("which", ["k_scale", "v_scale"])
def test_exactly_one_scale_raises(which):
    """Both scales or neither, as the JAX package's ValueError: one
    missing scale would read raw payloads as numbers."""
    args = [torch.from_numpy(a) for a in _case("decode", 1, seed=0)]
    scale = torch.ones(args[1].shape[:3])
    for fn in (tra.ragged_paged_attention,
               tra.ragged_paged_attention_reference):
        with pytest.raises(ValueError, match="BOTH"):
            fn(*args, page_size=PS, **{which: scale})


def test_tolerance_is_per_row():
    """``tolerance``: in f32 each output row's bound scales with the
    largest |V| that row attends, plus F32_TOL·ROW_FLOOR of the call's
    largest live |V|; in bf16 each element's bound is BF16_UNIT·
    BF16_MARGIN·(Σ_j p_j·|v_j| + 2·|out|) plus the same floor."""
    q, kp, vp, bt, ql, kl = (torch.from_numpy(a)
                             for a in _case("prefill", 2, seed=9))
    vp[1, 0] *= 100.0                       # slot 0's first row, both heads
    bound = tra.tolerance(q, kp, vp, bt, ql, kl, page_size=PS)
    assert bound.shape == q.shape
    top = float(vp[1, 0].abs().max())
    floor = tra.F32_TOL * tra.ROW_FLOOR * top
    # every query row of slot 0 attends its row 0; slot 1's rows do not
    assert (bound[0, :5] >= tra.F32_TOL * float(vp[1, 0].abs().amax(-1)
                                                .min())).all()
    assert (bound[1] < tra.F32_TOL * top / 10).all()
    assert (bound[1] >= floor * 0.999).all()
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, kp, vp))
    bound = tra.tolerance(qb, kb, vb, bt, ql, kl, page_size=PS)
    out = tra.ragged_paged_attention_reference(qb, kb, vb, bt, ql, kl,
                                               page_size=PS).float()
    # Σ_j p_j·|v_j| lies between |out| and the largest |V| the row attends
    unit = tra.BF16_UNIT * tra.BF16_MARGIN
    floor = tra.F32_TOL * tra.ROW_FLOOR * float(vb[1, 0].float().abs().max())
    assert (bound >= unit * (3 - 2.0 ** -7) * out.abs() + floor * 0.999).all()
    rows = vb.float().abs().max()
    assert (bound <= unit * (rows + 2 * out.abs()) + floor * 1.001).all()
    # slot 1 never attends the big row, and its bound does not see it
    assert float(bound[1].max()) < unit * top / 10


def test_mixed_devices_raise():
    q, kp, vp, bt, ql, kl = (torch.from_numpy(a)
                             for a in _case("decode", 1, seed=0))
    with pytest.raises(ValueError, match="devices"):
        tra.ragged_paged_attention(q, kp, vp, bt, ql, kl.to("meta"),
                                   page_size=PS)


@pytest.mark.parametrize("bad,exc", [
    ("dtype", TypeError), ("table_dtype", TypeError),
    ("head_dim", ValueError), ("page_size", ValueError),
    ("contiguous", ValueError), ("lens_shape", ValueError),
    ("payload_dtype", TypeError), ("scale_dtype", TypeError),
    ("scale_shape", ValueError), ("scale_contiguous", ValueError),
])
def test_kernel_wrapper_rejects_what_the_kernel_cannot_take(bad, exc):
    """The CUDA wrapper validates before it builds or launches anything;
    the checks run on any device, so CPU tensors exercise them here."""
    q, kp, vp, bt, ql, kl = (torch.from_numpy(a)
                             for a in _case("decode", 2, seed=0))
    page_size = PS
    scales = {}
    if bad.startswith(("payload", "scale")):     # K4's wrapper
        kp, vp = kp.to(torch.int8), vp.to(torch.int8)
        scales = dict(k_scale=torch.ones(kp.shape[:3]),
                      v_scale=torch.ones(kp.shape[:3]))
    if bad == "payload_dtype":
        vp = vp.to(torch.float8_e4m3fn)
    elif bad == "scale_dtype":
        scales["v_scale"] = scales["v_scale"].double()
    elif bad == "scale_shape":
        scales["k_scale"] = scales["k_scale"][:, :, :1]
    elif bad == "scale_contiguous":
        scales["k_scale"] = torch.ones(kp.shape[2], kp.shape[1],
                                       kp.shape[0]).permute(2, 1, 0)
    elif bad == "dtype":
        q = q.double()
    elif bad == "table_dtype":
        bt = bt.long()
    elif bad == "head_dim":
        q, kp, vp = q[..., :8].contiguous(), kp[..., :8].contiguous(), \
            vp[..., :8].contiguous()
    elif bad == "page_size":
        page_size = PS * 2
    elif bad == "contiguous":
        q = q.repeat(1, 1, 1, 2)[..., :HD]        # rows strided 2*HD
    elif bad == "lens_shape":
        ql = ql[:2]
    with pytest.raises(exc):
        tra._launch(q, kp, vp, bt, ql, kl, page_size, **scales)


def test_kernel_source_builds_with_nvcc_and_plain_c():
    """The kernel builds for sm_90a with nvcc into a git-ignored build
    directory and binds through a plain C interface (no PyTorch headers),
    with every entry point's ctypes signature declared."""
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "-shared" in _build.NVCC_FLAGS
    src = (_build.CSRC / "ragged_paged_attention.cu").read_text()
    assert "torch/" not in src and "extension.h" not in src
    assert 'extern "C"' in src and "rpa_launch" in src
    assert "rpa_quant_launch" in src and "cuda_fp8.h" in src
    tree = ast.parse(pathlib.Path(_build.__file__).read_text())
    assert "load" in {n.name for n in tree.body
                      if isinstance(n, ast.FunctionDef)}
    argtypes, restype = _build.SIGNATURES["ragged_paged_attention"][
        "rpa_launch"]
    assert len(argtypes) == 27
    argtypes, restype = _build.SIGNATURES["ragged_paged_attention"][
        "rpa_quant_launch"]
    assert len(argtypes) == 32
    gitignore = (pathlib.Path(__file__).parents[1] / ".gitignore") \
        .read_text().split()
    assert "build/" in gitignore


# ------------------------------------------------------------- tile path
@pytest.mark.parametrize("q_max,hd,dtype,tile", [
    (1, 128, torch.bfloat16, False),         # decode
    (1, 64, torch.bfloat16, False),          # decode, head dim 64
    (512, 16, torch.bfloat16, False),        # head dim 16
    (512, 128, torch.float32, False),        # the f32 model
    (2, 128, torch.bfloat16, True),          # the fewest suffix rows
    (63, 128, torch.bfloat16, True),         # one row short of a tile
    (512, 128, torch.bfloat16, True),        # serving's prefill bucket
    (16, 128, torch.bfloat16, True),         # GQA suffix: 64 rows at 4
    (2, 64, torch.bfloat16, True),           # suffix rows, head dim 64
])
def test_tile_path_rule(q_max, hd, dtype, tile):
    """``_tile_path`` sends bf16 prefill and suffix rows (q_max > 1) at
    head dims 64 and 128 to the tile kernel; decode, head dim 16 and f32
    stay on ``rpa_kernel``."""
    assert tra._tile_path(q_max, hd, dtype) is tile


def _tile_case(seed, ps, q_lens=(40, 23), kv_lens=(97, 23), groups=2,
               KV=2, hd=64, pmax=8):
    """Pools and queries for a tile-path shape (bf16-able, head dim 64,
    q_max·groups = 80 rows), random pages; dead rows zero."""
    rng = np.random.RandomState(seed)
    B = len(q_lens)
    npool = 1 + B * pmax
    kp = np.zeros((npool, ps, KV, hd), np.float32)
    vp = np.zeros((npool, ps, KV, hd), np.float32)
    bt = np.zeros((B, pmax), np.int32)
    pages = 1 + rng.permutation(npool - 1)
    n = 0
    for b in range(B):
        for j in range(-(-kv_lens[b] // ps)):
            bt[b, j] = pages[n]
            live = min(ps, kv_lens[b] - j * ps)
            kp[pages[n], :live] = rng.randn(live, KV, hd)
            vp[pages[n], :live] = rng.randn(live, KV, hd)
            n += 1
    q = rng.randn(B, max(q_lens), KV * groups, hd).astype(np.float32)
    return (q, kp, vp, bt, np.asarray(q_lens, np.int32),
            np.asarray(kv_lens, np.int32))


@pytest.mark.parametrize("ps", [16, 32, 64])
def test_tile_path_shapes_match_jax_interpret(ps):
    """At shapes the tile path takes on the card (head dim 64, 80 rows of
    q_max·groups, page sizes 16, 32 and 64), the plain version the tile
    kernel is held to matches the JAX kernel in interpret mode, in f32 to
    TOL as the other K3 cases (in bf16 the two frameworks round sums at
    other places on the CPU)."""
    q, kp, vp, bt, ql, kl = _tile_case(seed=ps, ps=ps)
    assert tra._tile_path(q.shape[1], 64, torch.bfloat16)
    ref = np.asarray(jra.ragged_paged_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, ql, kl)), page_size=ps,
        interpret=True))
    out = tra.ragged_paged_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, ql, kl)),
        page_size=ps).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


def _tolerance_before(q, k_pool, v_pool, block_table, q_lens, kv_lens, *,
                      page_size, k_scale=None, v_scale=None):
    """``tolerance`` as it stood before the tile path: one M term."""
    out, mass, row, top = tra._plain(q, k_pool, v_pool, block_table, q_lens,
                                     kv_lens, page_size, k_scale, v_scale,
                                     bound_terms=True)
    floor = tra.F32_TOL * tra.ROW_FLOOR * top
    if q.dtype == torch.float32:
        return (tra.F32_TOL * row + floor).expand(out.shape)
    return tra.BF16_UNIT * tra.BF16_MARGIN * (mass + 2 * out.float().abs()) \
        + floor


@pytest.mark.parametrize("case", ["decode bf16", "decode f32", "tile f32",
                                  "K4 decode bf16", "K4 decode f32",
                                  "hd16 bf16"])
def test_tolerance_unchanged_off_the_tile_path(case):
    """Calls that stay on ``rpa_kernel`` (decode, f32, K4 decode, head
    dim 16) keep their bound bit for bit."""
    if case.startswith("tile"):
        q, kp, vp, bt, ql, kl = _tile_case(seed=1, ps=16)
    elif case.startswith("hd16"):
        q, kp, vp, bt, ql, kl = _tile_case(seed=2, ps=16, q_lens=(5, 3),
                                           kv_lens=(40, 9), hd=16)
    else:
        q, kp, vp, bt, ql, kl = _tile_case(seed=3, ps=16, q_lens=(1, 1),
                                           kv_lens=(40, 9))
    dtype = torch.float32 if case.endswith("f32") else torch.bfloat16
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, ql, kl)]
    args[0] = args[0].to(dtype)
    kw = {"page_size": 16}
    if case.startswith("K4"):
        for i, pool in ((1, kp), (2, vp)):
            s = np.abs(pool).max(-1) / 127 + 1e-3
            args[i] = torch.from_numpy(np.round(pool / s[..., None])
                                       .astype(np.int8))
            kw["k_scale" if i == 1 else "v_scale"] = \
                torch.from_numpy(s.astype(np.float32))
    else:
        args[1], args[2] = args[1].to(dtype), args[2].to(dtype)
    assert not tra._tile_path(args[0].shape[1], args[0].shape[3], dtype)
    assert torch.equal(tra.tolerance(*args, **kw),
                       _tolerance_before(*args, **kw))


@pytest.mark.parametrize("quant", [False, True])
def test_tolerance_adds_one_mass_term_on_the_tile_path(quant):
    """For a call ``_tile_path`` sends to the tile kernel, the bf16 bound
    is BF16_UNIT·BF16_MARGIN·(2·M + 2·|out|) + floor: exactly one more
    BF16_UNIT·M term (times the margin) than ``rpa_kernel``'s."""
    q, kp, vp, bt, ql, kl = _tile_case(seed=4, ps=32)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, ql, kl)]
    args[0] = args[0].to(torch.bfloat16)
    kw = {"page_size": 32}
    if quant:
        for i, pool in ((1, kp), (2, vp)):
            s = np.abs(pool).max(-1) / 127 + 1e-3
            args[i] = torch.from_numpy(np.round(pool / s[..., None])
                                       .astype(np.int8))
            kw["k_scale" if i == 1 else "v_scale"] = \
                torch.from_numpy(s.astype(np.float32))
    else:
        args[1], args[2] = (a.to(torch.bfloat16) for a in args[1:3])
    assert tra._tile_path(args[0].shape[1], 64, torch.bfloat16)
    out, mass, _, top = tra._plain(*args, 32, kw.get("k_scale"),
                                   kw.get("v_scale"), bound_terms=True)
    unit = tra.BF16_UNIT * tra.BF16_MARGIN
    floor = tra.F32_TOL * tra.ROW_FLOOR * top
    bound = tra.tolerance(*args, **kw)
    assert torch.equal(bound, unit * (2 * mass + 2 * out.float().abs())
                       + floor)
    extra = bound - _tolerance_before(*args, **kw)
    assert float(mass.max()) > 0
    torch.testing.assert_close(extra, unit * mass, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("ps,ok", [(8, True), (16, True), (64, True),
                                   (128, True), (48, False), (96, False),
                                   (24, False)])
def test_tile_path_page_sizes(ps, ok):
    """The tile path gathers 64-row key tiles: a page size that divides
    64 or is a multiple of it is taken, any other raises."""
    if ok:
        tra._check_tile_page_size(ps)
    else:
        with pytest.raises(ValueError, match="page_size"):
            tra._check_tile_page_size(ps)


@pytest.mark.parametrize("bad", ["page_size", "f32", "head_dim"])
def test_tile_wrapper_rejects_what_the_tile_kernel_cannot_take(bad):
    """The wrapper validates a tile-path call before it builds or
    launches anything (CPU tensors exercise the checks): a page size that
    fits no 64-row tile, and a forced tile launch of an f32 model or a
    head dim the tile kernel lacks, raise ValueError."""
    ps = 48 if bad == "page_size" else 16
    q, kp, vp, bt, ql, kl = _tile_case(seed=5, ps=ps)
    dtype = torch.float32 if bad == "f32" else torch.bfloat16
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, ql, kl)]
    args[:3] = [a.to(dtype) for a in args[:3]]
    if bad == "head_dim":
        args[:3] = [a[..., :16].contiguous() for a in args[:3]]
    tile = None if bad == "page_size" else True
    with pytest.raises(ValueError, match="tile"):
        tra._launch(*args, ps, tile=tile)


def test_every_entry_point_agrees_with_its_signature():
    """Each C entry point of the ragged library (rpa_kernel's, the tile
    path's, the tile core's check) has as many arguments as its ctypes
    signature in ``_build.SIGNATURES``, and the tile kernel sits on the
    shared Hopper tile core."""
    src = (_build.CSRC / "ragged_paged_attention.cu").read_text()
    sigs = _build.SIGNATURES["ragged_paged_attention"]
    assert {"rpa_tile_launch", "rpa_tile_quant_launch",
            "hopper_wgmma_check"} <= set(sigs)
    for name, (argtypes, _) in sigs.items():
        decl = re.search(r"(?:int|const char\*) %s\(([^)]*)\)" % name, src)
        assert decl, name
        assert len(argtypes) == len(decl.group(1).split(",")), name
    assert '#include "hopper_attention.cuh"' in src
    assert "rpa_tile_kernel" in src and "cp_async16" in src
    core = (_build.CSRC / "hopper_attention.cuh").read_text()
    assert "wgmma.mma_async" in core and "torch/" not in core

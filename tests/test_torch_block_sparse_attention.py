"""Block-sparse attention of the PyTorch port against the JAX package.

On CPU tensors the port runs its plain versions of kernels K5 and K6
(``bsa_fwd_reference``, ``bsa_bwd_reference``); here they are held to the
Pallas kernels run as the JAX package's own tests run them on the CPU
(``_bsa_fwd_impl`` / ``_bsa_bwd_impl`` with ``interpret=True``) on the same
numpy inputs: T ≤ 64, D ∈ {8, 16}, H ≤ 2. ``pattern_to_block_map`` must
give the JAX package's arrays exactly, and ``tile_plan`` (the kernels' own
64-tiles, which the CUDA kernels alone read) is held to the dense pattern
by a property test.

Tolerances: f32 outputs 1e-5 absolute (relative to max(1, max|ref|) for
gradients): both sides compute f32 scores, scale q before the product and
differ only in summation order, ~1e-6 here, where a masking fault moves
outputs by order 0.1. bf16 outputs: ``tolerance(ref, bf16)`` per row
(2^-6 of the row's max|ref| plus 2^-8 of the tensor's), since both sides
compute in f32 and round the result to bf16 once, at most one ulp apart.
lse 1e-5 where finite; −inf in the same rows.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu.ops import block_sparse_attention as jbsa
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import block_sparse_attention as tbsa

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads cost more than they save and
    contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _band(T, w):
    i, j = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
    keep = np.abs(i - j) <= w
    return i[keep], j[keep]


def _longformer(T, window=256, n_global=64):
    i, j = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
    keep = (np.abs(i - j) <= window) | (i < n_global) | (j < n_global)
    return i[keep], j[keep]


def _patterns():
    rng = np.random.default_rng(3)
    r, c = rng.integers(0, 64, 300), rng.integers(0, 64, 300)
    return {
        "band": (64, *_band(64, 9), 16),
        "tril": (64, *np.tril_indices(64), 16),
        "duplicates": (64, np.concatenate([r, r[:100]]),
                       np.concatenate([c, c[:100]]), 8),
    }


def _dense(rows, cols, T):
    pat = np.zeros((T, T), bool)
    pat[rows, cols] = True
    return pat


def _close(port, ref, rel=False):
    ref = np.asarray(ref, np.float32)
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) \
        else port
    tol = TOL * max(1.0, float(np.abs(ref).max())) if rel else TOL
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol)


def _close_bf16(port, ref):
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    diff = (port.detach().float() - ref).abs()
    assert bool((diff <= tbsa.tolerance(ref, torch.bfloat16)).all()), \
        float(diff.max())


@pytest.mark.parametrize("name", ["band", "tril", "duplicates",
                                  "longformer-8192"])
def test_pattern_to_block_map_matches_jax(name):
    if name == "longformer-8192":
        T, rows, cols, block = 8192, *_longformer(8192), 512
    else:
        T, rows, cols, block = _patterns()[name]
    bm, masks = tbsa.pattern_to_block_map(rows, cols, T, block, block)
    jbm, jmasks = jbsa.pattern_to_block_map(rows, cols, T, block, block)
    np.testing.assert_array_equal(bm, jbm)
    np.testing.assert_array_equal(masks, jmasks)
    assert bm.dtype == jbm.dtype and masks.dtype == jmasks.dtype
    if name == "longformer-8192":      # its tile and block counts
        assert rows.size == 5_148_352
        assert int((bm > 0).sum()) == 74 and int((bm == 1).sum()) == 0
        plan = tbsa.tile_plan(bm, masks, T, block, block)
        assert [int((plan.tile_map == v).sum()) for v in (1, 2)] == [1132,
                                                                     246]


@st.composite
def _plan_case(draw):
    T = draw(st.integers(8, 160))
    divisors = [d for d in range(1, T + 1) if T % d == 0]
    bq = draw(st.sampled_from(divisors))
    bk = draw(st.sampled_from(divisors))
    tile = draw(st.sampled_from([8, 16, 24, 64]))
    kind = draw(st.sampled_from(["random", "band", "blocks"]))
    seed = draw(st.integers(0, 2 ** 16))
    rng = np.random.default_rng(seed)
    if kind == "random":
        n = draw(st.integers(0, 3 * T))
        rows, cols = rng.integers(0, T, n), rng.integers(0, T, n)
    elif kind == "band":
        rows, cols = _band(T, draw(st.integers(0, T // 2)))
    else:           # whole squares: tiles covered fully and partly
        pat = np.zeros((T, T), bool)
        for _ in range(draw(st.integers(1, 4))):
            r0, c0 = rng.integers(0, T, 2)
            h, w = rng.integers(1, T + 1, 2)
            pat[r0:r0 + h, c0:c0 + w] = True
        rows, cols = np.nonzero(pat)
    return T, bq, bk, tile, rows, cols


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(_plan_case())
def test_tile_plan_matches_dense_pattern(case):
    """For block sizes that are not multiples of the tile: a tile is 0 iff
    the pattern holds none of its pairs and 1 iff it lies inside [0, T)²
    and holds every one; the words of a mixed tile are its pairs; the q
    and k lists name exactly the active tiles, in ascending order."""
    T, bq, bk, tile, rows, cols = case
    bm, masks = tbsa.pattern_to_block_map(rows, cols, T, bq, bk)
    plan = tbsa.tile_plan(bm, masks, T, bq, bk, tile)
    pat = _dense(rows, cols, T)
    n = -(-T // tile)
    padded = np.zeros((n * tile, n * tile), bool)
    padded[:T, :T] = pat
    inside = np.zeros_like(padded)
    inside[:T, :T] = True
    per_tile = padded.reshape(n, tile, n, tile).transpose(0, 2, 1, 3)
    in_tile = inside.reshape(n, tile, n, tile).transpose(0, 2, 1, 3)
    none = ~per_tile.any((2, 3))
    every = (per_tile | ~in_tile).all((2, 3)) & in_tile.all((2, 3))
    np.testing.assert_array_equal(plan.tile_map == 0, none)
    np.testing.assert_array_equal(plan.tile_map == 1, every)
    # rebuild the pattern from the q lists, and again from the k lists
    for ptr, ent, by_q in ((plan.q_ptr, plan.q_ent, True),
                           (plan.k_ptr, plan.k_ent, False)):
        got = np.zeros_like(padded)
        for major in range(n):
            entries = ent[ptr[major]:ptr[major + 1]]
            assert (np.diff(entries[:, 0]) > 0).all()
            for minor, slot in entries:
                qi, kj = (major, minor) if by_q else (minor, major)
                assert (slot < 0) == (plan.tile_map[qi, kj] == 1)
                if slot < 0:
                    blk = np.ones((tile, tile), bool)
                else:
                    words = plan.bits[slot].astype(np.uint64)
                    blk = ((words[:, None] >> np.arange(tile, dtype=np.uint64))
                           & np.uint64(1)).astype(bool)
                got[qi * tile:(qi + 1) * tile, kj * tile:(kj + 1) * tile] = blk
        np.testing.assert_array_equal(got, padded)


# inputs for the kernel-level comparisons: (T, D, H, block, rows, cols)
KERNEL_CASES = {
    "band": (64, 16, 2, 16, *_band(64, 9)),
    "empty-rows": (32, 8, 1, 8, np.repeat(np.arange(8), 4),
                   np.tile(np.arange(4), 8)),
}


def _inputs(T, D, H, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, T, H, D), np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def pallas():
    """{(case, dtype): (inputs, block map, masks, Pallas out, lse[, dq,
    dk, dv])} — one interpret-mode run of each kernel, shared below."""
    res = {}
    for i, (name, (T, D, H, block, rows, cols)) in enumerate(
            KERNEL_CASES.items()):
        bm, masks = jbsa.pattern_to_block_map(rows, cols, T, block, block)
        for dtype in ("float32", "bfloat16"):
            if name == "empty-rows" and dtype == "bfloat16":
                continue
            q, k, v, do = _inputs(T, D, H, seed=i)
            jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
            out, lse = jbsa._bsa_fwd_impl(jq, jk, jv, bm, masks, block, block,
                                          interpret=True)
            grads = ()
            if dtype == "float32":
                grads = tuple(np.array(g, np.float32)
                              for g in jbsa._bsa_bwd_impl(
                                  jq, jk, jv, out, lse, jnp.asarray(do), bm,
                                  masks, block, block, interpret=True))
            res[(name, dtype)] = ((q, k, v, do), bm, masks,
                                  np.array(out, np.float32),
                                  np.array(lse), *grads)
    return res


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("name,dtype", [("band", "float32"),
                                        ("band", "bfloat16"),
                                        ("empty-rows", "float32")])
def test_forward_matches_pallas_interpret(pallas, name, dtype):
    (q, k, v, _), bm, masks, out, lse, *_ = pallas[(name, dtype)]
    block = KERNEL_CASES[name][3]
    t_out, t_lse = tbsa.bsa_fwd_reference(
        *(_torch(x, dtype) for x in (q, k, v)), bm, masks, block, block)
    assert t_out.dtype == getattr(torch, dtype) and t_lse.dtype == \
        torch.float32 and t_lse.shape == lse.shape
    if dtype == "float32":
        _close(t_out, out)
    else:
        _close_bf16(t_out, out)
    dead = np.isneginf(lse)
    np.testing.assert_array_equal(torch.isneginf(t_lse).numpy(), dead)
    assert dead.any() == (name == "empty-rows")
    _close(t_lse.numpy()[~dead], lse[~dead])
    assert (t_out.float().numpy().transpose(0, 2, 1, 3)[dead] == 0).all()


@pytest.mark.parametrize("name", ["band", "empty-rows"])
def test_backward_matches_pallas_interpret(pallas, name):
    (q, k, v, do), bm, masks, out, lse, dq, dk, dv = \
        pallas[(name, "float32")]
    block = KERNEL_CASES[name][3]
    grads = tbsa.bsa_bwd_reference(
        *map(torch.from_numpy, (q, k, v, out, lse, do)), bm, masks, block,
        block)
    for port, ref in zip(grads, (dq, dk, dv)):
        _close(port, ref, rel=True)
    if name == "empty-rows":   # rows 8.. and keys 4.. are outside: exact 0
        assert (grads[0][:, 8:] == 0).all()
        assert (grads[1][:, 4:] == 0).all() and (grads[2][:, 4:] == 0).all()


def test_autograd_matches_jax_grad():
    """block_sparse_attention on CPU tensors (the autograd Function with
    the plain versions) against jax.grad of the JAX package's, band w=5
    with 8-blocks at T=32, D=8 (the JAX package's own gradient case)."""
    T, D = 32, 8
    rows, cols = _band(T, 5)
    q, k, v, do = _inputs(T, D, 2, seed=11)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tbsa.block_sparse_attention(*leaves, rows, cols, 8, 8)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))

    def jloss(jq, jk, jv):
        return jnp.sum(jbsa.block_sparse_attention(
            jq, jk, jv, rows, cols, 8, 8, interpret=True) * jnp.asarray(do))

    jout = jbsa.block_sparse_attention(*map(jnp.asarray, (q, k, v)), rows,
                                       cols, 8, 8, interpret=True)
    _close(out, jout)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, jg in zip(grads, jgrads):
        _close(g, jg, rel=True)


@pytest.mark.parametrize("T,block,w", [(140, 70, 11), (127, 127, 7),
                                       (200, 8, 30)])
def test_plain_matches_dense_masked_softmax(T, block, w):
    """Blocks that straddle the kernels' 64-tiles and a T no tile divides:
    the plain versions, through autograd, against dense masked softmax
    with no [T, T]-free trick (a dense torch computation)."""
    rows, cols = _band(T, w)
    keep = rows != 3                      # row 3 attends nothing
    rows, cols = rows[keep], cols[keep]
    q, k, v, do = _inputs(T, 16, 2, seed=T)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tbsa.block_sparse_attention(*leaves, rows, cols, block, block)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    dl = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    pat = torch.from_numpy(_dense(rows, cols, T))
    s = torch.einsum("bqhd,bkhd->bhqk", dl[0], dl[1]) / 4.0
    p = torch.softmax(s.masked_fill(~pat, -torch.inf), -1).nan_to_num(0.0)
    ref = torch.einsum("bhqk,bkhd->bqhd", p, dl[2])
    ref_grads = torch.autograd.grad(ref, dl, torch.from_numpy(do))
    _close(out, ref.detach().numpy())
    assert (out[:, 3] == 0).all() and (grads[0][:, 3] == 0).all()
    for g, r in zip(grads, ref_grads):
        _close(g, r.numpy(), rel=True)


def test_compile_pattern_is_cached_and_moves_nothing_per_call():
    rows, cols = _band(64, 4)
    a = tbsa.compile_pattern(rows, cols, 64, 16, 16, device="cpu")
    b = tbsa.compile_pattern(rows.copy(), cols.copy(), 64, 16, 16, "cpu")
    assert a is b and a.device == torch.device("cpu")
    assert tbsa.compile_pattern(rows, cols, 64, 32, 32, "cpu") is not a
    assert a.q_plan[0].dtype == torch.int32 and a.bits.dtype == torch.int64


def test_cuda_request_without_gpu_raises():
    """Every entry point runs on CUDA by default and raises without a
    GPU; CUDA-only shapes raise before any launch (no fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default does not raise")
    rows, cols = _band(16, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        tbsa.compile_pattern(rows, cols, 16, 8, 8)
    pat = tbsa.compile_pattern(rows, cols, 16, 8, 8, device="cpu")
    q = torch.zeros(1, 16, 2, 32)
    with pytest.raises(ValueError, match="head dim"):
        tbsa._validate(q, q, q, pat)
    x = torch.zeros(1, 16, 2, 64, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        tbsa._validate(x, x, x, pat)
    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="T=8"):
        tbsa._validate(x, x, x, pat)
    with pytest.raises(ValueError, match="unsupported device"):
        tbsa.bsa_forward(*(torch.zeros(1, 16, 2, 64, device="meta"),) * 3,
                         pat)


def test_kernel_source_and_bindings_agree():
    """K5 and K6 build from one plain-C source (no PyTorch headers), each
    entry point's ctypes signature has as many arguments as its C
    declaration, and the source's tile is the plan's."""
    src = (_build.CSRC / "block_sparse_attention.cu").read_text()
    assert "torch/" not in src and "extension.h" not in src
    assert '#include "attention_tiles.cuh"' in src
    header = (_build.CSRC / "attention_tiles.cuh").read_text()
    assert "torch/" not in header and "mma.sync" in header
    assert f"constexpr int kTile = {tbsa.TILE};" in src
    for name in ("bsa_fwd", "bsa_bwd_dq", "bsa_bwd_dkv"):
        decl = re.search(r"int %s_launch\(([^)]*)\)" % name, src)
        assert decl, name
        n_c = len(decl.group(1).split(","))
        argtypes, _ = _build.SIGNATURES["block_sparse_attention"][
            name + "_launch"]
        assert len(argtypes) == n_c, name

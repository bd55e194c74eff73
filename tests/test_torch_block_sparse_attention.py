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
    _check_pair_lists(plan, padded, tile)


def _check_pair_lists(plan, padded, tile):
    """The bf16 kernels' pair lists against the dense pattern ``padded``
    [n·tile, n·tile]: one list per pair of tiles along the first axis
    (q tiles for ``fwd``, k tiles for ``bwd``), even a pair that holds no
    pair of the pattern; each the ascending union of its two tiles'
    active tiles; each half's slot −1 where its tile is full, the words of
    its tile (in the q-row orientation both kernels read) where mixed,
    SKIP where empty or past the last tile; the order a permutation of
    the blocks by non-increasing list length."""
    n = plan.tile_map.shape[0]
    m = -(-n // 2)
    per_tile = padded.reshape(n, tile, n, tile).transpose(0, 2, 1, 3)
    for kind, tm, tiles in (("fwd", plan.tile_map, per_tile),
                            ("bwd", plan.tile_map.T,
                             per_tile.transpose(1, 0, 3, 2))):
        ptr, ent, order = (getattr(plan, f"{kind}_{x}")
                           for x in ("ptr", "ent", "order"))
        assert ptr.shape == (m + 1,) and ptr[0] == 0
        assert ent.shape == (ptr[-1], 3) and ent.dtype == np.int32
        lens = np.diff(ptr)
        assert sorted(order.tolist()) == list(range(m))
        assert (np.diff(lens[order]) <= 0).all()
        for blk in range(m):
            e = ent[ptr[blk]:ptr[blk + 1]]
            halves = (2 * blk, 2 * blk + 1)
            union = sorted({int(j) for i in halves if i < n
                            for j in np.flatnonzero(tm[i])})
            assert e[:, 0].tolist() == union
            for j, *slots in e:
                for i, slot in zip(halves, slots):
                    if i >= n or tm[i, j] == 0:
                        assert slot == tbsa.SKIP
                        continue
                    assert (slot == -1) == (tm[i, j] == 1) and slot != -2
                    pairs = tiles[i, j] if kind == "fwd" else tiles[i, j].T
                    if slot == -1:
                        assert pairs.all()
                        continue
                    words = plan.bits[slot].astype(np.uint64)
                    got = ((words[:, None] >> np.arange(
                        tile, dtype=np.uint64)) & np.uint64(1)).astype(bool)
                    np.testing.assert_array_equal(got, pairs)


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("case", range(9))
def test_pair_lists_on_phase8_patterns(case):
    """The pair lists of each of chip_smoke's nine phase-8 patterns (the
    shapes the card's checks run at, T ≤ 1024) against the dense pattern,
    as ``_check_pair_lists`` sets out; the pattern with keys outside has a
    key block whose list is empty and still present."""
    cs = _chip_smoke()
    patterns = cs.bsa_patterns()
    assert len(patterns) == 9
    label, T, rows, cols, block = patterns[case]
    bm, masks = tbsa.pattern_to_block_map(rows, cols, T, block, block)
    plan = tbsa.tile_plan(bm, masks, T, block, block)
    n = -(-T // tbsa.TILE)
    padded = np.zeros((n * tbsa.TILE, n * tbsa.TILE), bool)
    padded[:T, :T] = _dense(rows, cols, T)
    _check_pair_lists(plan, padded, tbsa.TILE)
    if label == "rows and keys outside":
        assert (np.diff(plan.bwd_ptr) == 0).any()
        assert (np.diff(plan.fwd_ptr) == 0).any()


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
    """K5 and K6 build from one plain-C source (no PyTorch headers) on the
    f32 tiles and the Hopper tile core, each entry point's ctypes
    signature has as many arguments as its C declaration (``bsa_bwd``,
    the bf16 backward, among them), and the source's tile and skip marker
    are the plan's."""
    src = (_build.CSRC / "block_sparse_attention.cu").read_text()
    assert "torch/" not in src and "extension.h" not in src
    assert '#include "attention_tiles.cuh"' in src
    assert '#include "hopper_attention.cuh"' in src
    for name in ("attention_tiles.cuh", "hopper_attention.cuh"):
        header = (_build.CSRC / name).read_text()
        assert "torch/" not in header and "extension.h" not in header
    tiles = (_build.CSRC / "attention_tiles.cuh").read_text()
    assert "std::is_same<T, float>" in tiles     # the f32 kernels' helpers
    assert "bsa_fwd_kernel<D><<<" in src and "bsa_bwd_kernel<D><<<" in src
    assert f"constexpr int kTile = {tbsa.TILE};" in src
    assert f"constexpr int kSkip = {tbsa.SKIP};" in src
    assert set(_build.SIGNATURES["block_sparse_attention"]) == {
        f"{n}_launch" for n in ("bsa_fwd", "bsa_bwd", "bsa_bwd_dq",
                                "bsa_bwd_dkv")}
    for name in ("bsa_fwd", "bsa_bwd", "bsa_bwd_dq", "bsa_bwd_dkv"):
        decl = re.search(r"int %s_launch\(([^)]*)\)" % name, src)
        assert decl, name
        n_c = len(decl.group(1).split(","))
        argtypes, _ = _build.SIGNATURES["block_sparse_attention"][
            name + "_launch"]
        assert len(argtypes) == n_c, name


@pytest.mark.parametrize("counted,passes", [
    ((), False),
    (("bsa_fwd", "bsa_bwd"), True),
    (("bsa_fwd", "bsa_bwd", "bsa_bwd_dq", "bsa_bwd_dkv"), False),
    (("bsa_fwd",), False)])
def test_chip_smoke_launch_gate(monkeypatch, counted, passes):
    """chip_smoke's phase-8 gate on the Longformer path's launches:
    ``bsa_fwd`` and ``bsa_bwd`` once a call, K6's f32 kernels never. On
    the CPU the plain versions run; here each call counts as the kernels
    in ``counted`` would (the forward ``bsa_fwd``, the backward the
    rest), so that the gate sees each mix at a small shape."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "BSA_SHAPE", (1, 2, 256, 64))
    monkeypatch.setattr(cs, "LONGFORMER", (16, 4))
    fwd, bwd = tbsa.bsa_forward, tbsa.bsa_backward

    def counted_fwd(*args):
        tbsa.LAUNCHES["bsa_fwd"] += "bsa_fwd" in counted
        return fwd(*args)

    def counted_bwd(*args):
        for name in counted[1:]:
            tbsa.LAUNCHES[name] += 1
        return bwd(*args)

    monkeypatch.setattr(tbsa, "bsa_forward", counted_fwd)
    monkeypatch.setattr(tbsa, "bsa_backward", counted_bwd)
    tbsa._get_pattern.cache_clear()        # the path counts one compile
    if passes:
        launches, errs, *_ = cs.bsa_path(device="cpu")
        assert launches == {"bsa_fwd": 2, "bsa_bwd": 2, "bsa_bwd_dq": 0,
                            "bsa_bwd_dkv": 0}
        assert set(errs) == {"out", "dq", "dk", "dv"}
    else:
        with pytest.raises(RuntimeError, match="launches"):
            cs.bsa_path(device="cpu")
    tbsa.LAUNCHES.clear()


def test_chip_smoke_names_the_pallas_kernels():
    """The kernels line names what each kernel replaces: ``bsa_fwd`` the
    forward Pallas kernel, ``bsa_bwd`` both backward ones (dq :192 and
    dkv :254); each file:line is the kernel's ``def`` in the JAX source
    (read as text). Every replacing kernel has a path note."""
    import pathlib
    cs = _chip_smoke()
    root = pathlib.Path(__file__).resolve().parents[1]
    assert set(cs.BSA_REPLACES) == {"bsa_fwd", "bsa_bwd"}
    assert set(cs.BSA_F32) == {"bsa_bwd_dq", "bsa_bwd_dkv"}
    for where, fn in ((cs.BSA_REPLACES["bsa_fwd"], "def kernel("),
                      (cs.BSA_REPLACES["bsa_bwd"], "def dq_kernel("),
                      (cs.BSA_REPLACES_ALSO["bsa_bwd"], "def dkv_kernel(")):
        path, line = where.rsplit(":", 1)
        assert path == "paddle_tpu/ops/block_sparse_attention.py"
        src = (root / path).read_text().splitlines()
        assert src[int(line) - 1].strip().startswith(fn), where
    assert all(name in cs.PATHS for name in cs.BSA_REPLACES)

"""``paddle_tpu_torch.sparse.fused_attention`` against the JAX package's.

The same numpy inputs ([B, H, T, D], B=H=2, D=8) and patterns go through
``paddle_tpu.sparse.csr.fused_attention`` (its block path reaches the
Pallas kernels in interpret mode on the CPU, as the JAX package's own
tests run it) and the port's, whose CPU tensors run the plain versions of
K5 and K6. The port's masks are PyTorch's own sparse CSR and COO tensors.
Cases: a band over 16-blocks, T=127 padded to 128, T=70 padded to 80 with
16-blocks, rows outside the pattern, the dense lowering with ``attn_mask``
and with ``key_padding_mask``, and the memo reused on a second call.

Tolerance: 1e-5 absolute on outputs of order 1, all in f32 (both sides
compute f32 scores and an f32 softmax and differ in summation order,
~1e-6; a masking or padding fault moves outputs by order 0.1);
gradients 1e-5 relative to max(1, max|ref|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.sparse import csr as jcsr
from paddle_tpu_torch import sparse as tsp
from paddle_tpu_torch.ops import block_sparse_attention as tbsa

TOL = 1e-5
B, H, D = 2, 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _band(T, w):
    i, j = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
    keep = np.abs(i - j) <= w
    return i[keep], j[keep]


def _crows(rows, T):
    return np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=T))])


def _masks(rows, cols, T):
    """The port's CSR and COO masks (CPU) and the JAX package's CSR."""
    vals = np.ones(rows.size, np.float32)
    return ({"csr": tsp.sparse_csr_tensor(_crows(rows, T), cols, vals, (T, T),
                                          device="cpu"),
             "coo": tsp.sparse_coo_tensor(np.stack([rows, cols]), vals,
                                          (T, T), device="cpu")},
            pt.sparse.sparse_csr_tensor(_crows(rows, T), cols, vals, (T, T)))


def _qkv(T, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, D), np.float32) for _ in range(3)]


# (T, rows, cols, block_size, memo key of the block path)
CASES = {
    "band-16": (64, *_band(64, 9), 16, (64, 16)),
    "T=127-auto": (127, *_band(127, 7), None, (128, 128)),
    "T=70-block-16": (70, *_band(70, 5), 16, (80, 16)),
    "empty-rows": (32, np.repeat(np.arange(8), 4), np.tile(np.arange(4), 8),
                   8, (32, 8)),
}


@pytest.fixture(scope="module")
def jax_block_path():
    """{case: JAX fused_attention output} on the block-sparse path."""
    res = {}
    for i, (name, (T, rows, cols, bs, _)) in enumerate(CASES.items()):
        q, k, v = _qkv(T, seed=i)
        _, jmask = _masks(rows, cols, T)
        out = jcsr.fused_attention(*map(jnp.asarray, (q, k, v)), jmask,
                                   block_size=bs)
        res[name] = np.array(out.numpy())
    return res


@pytest.mark.parametrize("layout", ["csr", "coo"])
@pytest.mark.parametrize("name", list(CASES))
def test_block_path_matches_jax(jax_block_path, name, layout):
    T, rows, cols, bs, memo = CASES[name]
    q, k, v = _qkv(T, seed=list(CASES).index(name))
    masks, _ = _masks(rows, cols, T)
    out = tsp.fused_attention(*map(torch.from_numpy, (q, k, v)),
                              masks[layout], block_size=bs)
    assert out.shape == (B, H, T, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), jax_block_path[name], rtol=0,
                               atol=TOL)
    assert masks[layout]._bsa_fn_memo[0] == memo
    row_any = np.zeros(T, bool)
    row_any[rows] = True
    assert (out.numpy()[:, :, ~row_any] == 0).all()


@pytest.mark.parametrize("extra", ["attn_mask", "key_padding_mask"])
@pytest.mark.parametrize("layout", ["csr", "coo"])
def test_dense_lowering_matches_jax(extra, layout):
    """An additive mask sends both packages to dense masked softmax;
    rows outside the pattern still give 0."""
    T = 32
    rows, cols = _band(T, 4)
    keep = rows != 5
    rows, cols = rows[keep], cols[keep]
    q, k, v = _qkv(T, seed=21)
    rng = np.random.default_rng(22)
    add = (rng.standard_normal((T, T), np.float32) if extra == "attn_mask"
           else np.where(rng.random((B, T)) < 0.2, -1e4, 0.0)
           .astype(np.float32))
    masks, jmask = _masks(rows, cols, T)
    out = tsp.fused_attention(*map(torch.from_numpy, (q, k, v)),
                              masks[layout], **{extra: torch.from_numpy(add)})
    ref = jcsr.fused_attention(*map(jnp.asarray, (q, k, v)), jmask,
                               **{extra: jnp.asarray(add)})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.numpy()),
                               rtol=0, atol=TOL)
    assert (out.numpy()[:, :, 5] == 0).all()
    assert not hasattr(masks[layout], "_bsa_fn_memo")


def test_memo_reused_on_second_call():
    """The compiled pattern is memoized on the mask object: a second call
    reads nothing to the host and compiles nothing."""
    T = 48
    rows, cols = _band(T, 3)
    masks, _ = _masks(rows, cols, T)
    mask = masks["csr"]
    q, k, v = map(torch.from_numpy, _qkv(T, seed=5))
    first = tsp.fused_attention(q, k, v, mask, block_size=16)
    memo = mask._bsa_fn_memo
    misses = tbsa._get_pattern.cache_info().misses
    second = tsp.fused_attention(q, k, v, mask, block_size=16)
    assert mask._bsa_fn_memo is memo
    assert tbsa._get_pattern.cache_info().misses == misses
    assert torch.equal(first, second)


def test_block_path_gradients_match_dense_lowering():
    """Backward through the block path (K6's plain version) against
    autograd of the dense lowering on the same mask, with padding
    (T=70 → 80) and a row outside the pattern."""
    T = 70
    rows, cols = _band(T, 6)
    keep = rows != 9
    rows, cols = rows[keep], cols[keep]
    masks, _ = _masks(rows, cols, T)
    q, k, v = _qkv(T, seed=31)
    do = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (B, H, T, D), np.float32))
    grads = []
    for kwargs in ({"block_size": 16}, {"attn_mask": torch.zeros(T, T)}):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = tsp.fused_attention(*leaves, masks["coo"], **kwargs)
        grads.append(torch.autograd.grad(out, leaves, do))
    for g, r in zip(*grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                   atol=TOL * max(1.0, float(r.abs().max())))
    assert (grads[0][0][:, :, 9] == 0).all()


def test_constructors_default_to_cuda():
    """sparse_csr_tensor and sparse_coo_tensor run on device="cuda" unless
    the caller asks for the CPU, and raise without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default does not raise")
    with pytest.raises(RuntimeError, match="cuda"):
        tsp.sparse_csr_tensor([0, 1], [0], [1.0], (1, 1))
    with pytest.raises(RuntimeError, match="cuda"):
        tsp.sparse_coo_tensor([[0], [0]], [1.0], (1, 1))
    t = tsp.sparse_coo_tensor([[0, 1], [1, 2]], [1.0, 2.0], device="cpu")
    assert t.shape == (2, 3) and t.layout == torch.sparse_coo
    with pytest.raises(TypeError, match="sparse CSR or COO"):
        tsp.fused_attention(*(torch.zeros(1, 1, 4, 8),) * 3,
                            torch.zeros(4, 4))


def test_chip_smoke_sparse_checks_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's phase 8 runs on the CPU up to what needs the card:
    its Longformer generator gives the dense definition's pairs, its nine
    kernel cases (here plain against plain, with the exact-zero and lse
    checks) pass, and its path check drives fused_attention forward and
    backward twice, then refuses the launch count, which CPU tensors
    leave at 0."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    T, w, g = 300, 20, 5
    rows, cols = cs.longformer_pattern(T, w, g)
    i, j = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
    dense = (np.abs(i - j) <= w) | (i < g) | (j < g)
    np.testing.assert_array_equal(rows, i[dense])
    np.testing.assert_array_equal(cols, j[dense])
    shares = cs.bsa_cases(device="cpu")
    assert set(shares) == {f"{d} {o}" for d in ("float32", "bfloat16")
                           for o in ("out", "dq", "dk", "dv")}
    monkeypatch.setattr(cs, "BSA_SHAPE", (1, 2, 256, 64))
    monkeypatch.setattr(cs, "LONGFORMER", (16, 4))
    tbsa.LAUNCHES["bsa_fwd"] = 5           # the path zeroes the counts
    with pytest.raises(RuntimeError, match="launches"):
        cs.bsa_path(device="cpu")
    assert not any(tbsa.LAUNCHES.values())

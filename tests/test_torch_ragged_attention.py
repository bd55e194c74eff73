"""Ragged paged attention of the PyTorch port against the JAX package.

The port's ``ragged_paged_attention`` on CPU tensors runs its plain
PyTorch version; here it is held to the JAX kernel run as the JAX
package's own tests run it on the CPU (``interpret=True``), on the same
numpy inputs, for decode, ragged prefill, suffix and q_len=0 rows, at
groups 1 and 2, in f32.

Tolerance: 1e-5 absolute on outputs of order 1. Both sides compute f32
logits and an f32 softmax; they differ only in summation order (the JAX
package's own bitwise test already misses by 1.19e-7), so 1e-5 is ~100x
that noise and far below any masking or indexing error (order 0.1).
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import ragged_attention as jra
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


def _case(kind, groups, seed, nan_fill=False):
    """Random pool + block table for one row kind; dead rows (past kv_len
    in a live page, unmapped pages, the scratch page) hold NaN when
    ``nan_fill`` and zeros otherwise."""
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
    page = 1
    for b in range(B):
        for j in range(-(-int(kv_lens[b]) // PS)):
            bt[b, j] = page
            live = min(PS, int(kv_lens[b]) - j * PS)
            kp[page, :live] = rng.randn(live, KV, HD)
            vp[page, :live] = rng.randn(live, KV, HD)
            page += 1
    q = rng.randn(B, q_max, H, HD).astype(np.float32)
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


def test_quantized_pools_raise():
    args = [torch.from_numpy(a) for a in _case("decode", 1, seed=0)]
    with pytest.raises(NotImplementedError, match="K4"):
        tra.ragged_paged_attention(*args, page_size=PS,
                                   k_scale=torch.ones(1),
                                   v_scale=torch.ones(1))


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
])
def test_kernel_wrapper_rejects_what_the_kernel_cannot_take(bad, exc):
    """The CUDA wrapper validates before it builds or launches anything;
    the checks run on any device, so CPU tensors exercise them here."""
    q, kp, vp, bt, ql, kl = (torch.from_numpy(a)
                             for a in _case("decode", 2, seed=0))
    page_size = PS
    if bad == "dtype":
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
        tra._launch(q, kp, vp, bt, ql, kl, page_size)


def test_kernel_source_builds_with_nvcc_and_plain_c():
    """The kernel builds for sm_90a with nvcc into a git-ignored build
    directory and binds through a plain C interface (no PyTorch headers),
    with every entry point's ctypes signature declared."""
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "-shared" in _build.NVCC_FLAGS
    src = (_build.CSRC / "ragged_paged_attention.cu").read_text()
    assert "torch/" not in src and "extension.h" not in src
    assert 'extern "C"' in src and "rpa_launch" in src
    tree = ast.parse(pathlib.Path(_build.__file__).read_text())
    assert "load" in {n.name for n in tree.body
                      if isinstance(n, ast.FunctionDef)}
    argtypes, restype = _build.SIGNATURES["ragged_paged_attention"][
        "rpa_launch"]
    assert len(argtypes) == 27
    gitignore = (pathlib.Path(__file__).parents[1] / ".gitignore") \
        .read_text().split()
    assert "build/" in gitignore

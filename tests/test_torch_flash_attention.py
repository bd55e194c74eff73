"""Flash attention of the PyTorch port against the JAX package.

On CPU tensors the port runs its plain versions of kernels K1 and K2
(``flash_attention_reference``, ``flash_attention_bwd_reference``); here
they are held to the Pallas kernels run as the JAX package's own tests run
them on the CPU (``_flash_fwd_impl`` / ``_flash_bwd_impl`` with
``interpret=True``, blocks of 128), on the same numpy inputs: B=1, H=2,
D=128, L and S in {128, 256}, causal and not, L≠S both ways. The autograd
path (``flash_attention_raw``) is held to autograd of the port's
``_fa_reference`` and to ``jax.grad`` of the JAX package's.

Tolerance: 1e-5 absolute (relative to max(1, max|ref|) for gradients),
all in f32. Both sides compute f32 scores and an f32 softmax and differ
only in summation order and in where the scale is applied (the Pallas
kernel scales q before the product), ~1e-6 here; a masking or indexing
fault moves outputs by order 0.1.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as jl
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as tfa

TOL = 1e-5
CASES = [(128, 128, False), (256, 256, True), (128, 256, True),
         (256, 128, True)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads cost more than they save and
    contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(L, S, seed, D=128, H=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32)
            for shape in ((1, L, H, D), (1, S, H, D), (1, S, H, D),
                          (1, L, H, D))]


def _close(port, ref, rel=False):
    ref = np.asarray(ref)
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    tol = TOL * max(1.0, float(np.abs(ref).max())) if rel else TOL
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def pallas():
    """{case: (inputs, Pallas out, lse, dq, dk, dv)} — one interpret-mode
    run of each kernel per case, shared by the tests below."""
    res = {}
    for i, (L, S, causal) in enumerate(CASES):
        q, k, v, do = _inputs(L, S, seed=i)
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        out, lse = jfa._flash_fwd_impl(jq, jk, jv, causal, 128, 128,
                                       interpret=True)
        grads = jfa._flash_bwd_impl(jq, jk, jv, out, lse, jnp.asarray(do),
                                    causal, 128, 128, interpret=True)
        res[(L, S, causal)] = ((q, k, v, do), np.array(out), np.array(lse),
                               *map(np.array, grads))
    return res


@pytest.mark.parametrize("L,S,causal", CASES)
def test_forward_matches_pallas_interpret(pallas, L, S, causal):
    (q, k, v, _), out, lse, *_ = pallas[(L, S, causal)]
    t_out, t_lse = tfa.flash_attention_reference(
        *map(torch.from_numpy, (q, k, v)), causal)
    assert t_out.dtype == torch.float32 and t_lse.shape == (1, 2, L)
    _close(t_out, out)
    dead = np.isneginf(lse)
    np.testing.assert_array_equal(torch.isneginf(t_lse).numpy(), dead)
    assert dead.any() == (causal and L > S)
    _close(t_lse.numpy()[~dead], lse[~dead])
    if dead.any():          # rows that see no key: zeros, as the kernel
        assert (t_out.numpy().transpose(0, 2, 1, 3)[dead] == 0).all()


@pytest.mark.parametrize("L,S,causal", CASES)
def test_backward_matches_pallas_interpret(pallas, L, S, causal):
    (q, k, v, do), out, lse, dq, dk, dv = pallas[(L, S, causal)]
    grads = tfa.flash_attention_bwd_reference(
        *map(torch.from_numpy, (q, k, v, out, lse, do)), causal)
    for port, ref in zip(grads, (dq, dk, dv)):
        _close(port, ref, rel=True)


@pytest.mark.parametrize("L,S,causal", [(48, 48, True), (40, 72, True),
                                        (72, 40, True), (40, 72, False)])
def test_autograd_matches_fa_reference(L, S, causal):
    """flash_attention_raw on CPU tensors (the _FlashAttention function
    with the plain versions) against autograd of the port's _fa_reference
    and jax.grad of the JAX package's, at D=64 and a ragged length."""
    q, k, v, do = _inputs(L, S, seed=L + S, D=64)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention_raw(*leaves, causal=causal)
    out.backward(torch.from_numpy(do))
    grads = [t.grad.clone() for t in leaves]
    for t in leaves:
        t.grad = None
    ref = tfa._fa_reference(*leaves, causal)
    ref.backward(torch.from_numpy(do))
    _close(out, ref.detach().numpy())
    for g, t in zip(grads, leaves):
        _close(g, t.grad.numpy(), rel=True)

    def jloss(jq, jk, jv):
        return jnp.sum(jfa._fa_reference(jq, jk, jv, causal)
                       * jnp.asarray(do))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, jg in zip(grads, jgrads):
        _close(g, jg, rel=True)


def test_scale_and_head_dim_64_match_pallas_padding_path():
    """sm_scale and D=64: the JAX package pads D to 128 and passes the true
    scale; the port runs D=64 natively."""
    q, k, v, do = _inputs(128, 128, seed=9, D=64)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pad = [(0, 0)] * 3 + [(0, 64)]
    out, lse = jfa._flash_fwd_impl(jnp.pad(jq, pad), jnp.pad(jk, pad),
                                   jnp.pad(jv, pad), True, 128, 128,
                                   interpret=True, sm_scale=0.3)
    t_out, t_lse = tfa.flash_attention_reference(
        *map(torch.from_numpy, (q, k, v)), True, sm_scale=0.3)
    _close(t_out, np.asarray(out)[..., :64])
    _close(t_lse, lse)


@pytest.mark.parametrize("use_flash", [True, False])
def test_llama_attention_matches_jax(use_flash):
    """The model's causal GQA attention (KV=2 of H=4 heads, hd=16), flash
    and plain paths, against the JAX package's on the same inputs."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 12, 4, 16), np.float32)
    k, v = (rng.standard_normal((2, 12, 2, 16), np.float32)
            for _ in range(2))
    ref = jl._attention(*map(jnp.asarray, (q, k, v)), jl.LlamaConfig.tiny(),
                        use_flash=use_flash)
    out = tl._attention(*map(torch.from_numpy, (q, k, v)),
                        tl.LlamaConfig.tiny(), use_flash=use_flash)
    _close(out, ref)


def test_cuda_only_shapes_raise_before_launch():
    """What the kernels do not take raises (it never falls back)."""
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="head dim"):
        tfa._validate(q, q, q)
    with pytest.raises(TypeError, match="dtype"):
        tfa._validate(*(torch.zeros(1, 8, 2, 64, dtype=torch.float16),) * 3)
    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="contiguous last dim"):
        tfa._validate(x, x.transpose(1, 3).contiguous().transpose(1, 3), x)


def test_kernel_source_and_bindings_agree():
    """The kernels build from one plain-C source (no PyTorch headers), K2's
    bf16 dQ = dS·K reads K MN-major on the tile core, and each entry point
    (the bf16 backward's ``flash_bwd_launch`` and its launch check among
    them) has a ctypes signature with as many arguments as its C
    declaration."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert "torch/" not in src and "extension.h" not in src
    assert "wgmma_ss_n64_mnb" in src
    sigs = _build.SIGNATURES["flash_attention"]
    assert set(sigs) == {"flash_fwd_launch", "flash_bwd_launch",
                         "flash_bwd_dq_launch", "flash_bwd_dkv_launch",
                         "flash_bwd_wgmma_check"}
    for name, (argtypes, _) in sigs.items():
        decl = re.search(r"int %s\(([^)]*)\)" % name, src)
        assert decl, name
        assert len(argtypes) == len(decl.group(1).split(",")), name


@pytest.mark.parametrize("bad", ["expanded_heads", "expanded_batch"])
def test_tma_maps_reject_strides_they_cannot_take(bad):
    """The bf16 forward reads q, k, v through TMA maps, so a dim of extent
    > 1 stepped by stride 0 raises before anything builds or launches
    (CPU tensors exercise the checks); f32 keeps its CUDA-core kernel and
    no such check."""
    x = torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16)
    if bad == "expanded_heads":
        y = torch.zeros(2, 8, 1, 64, dtype=torch.bfloat16).expand(2, 8, 4, 64)
    else:
        y = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16).expand(2, 8, 4, 64)
    tfa._validate(y, y, y)                   # strides of 0 pass _check
    with pytest.raises(ValueError, match="TMA"):
        tfa._flash_fwd(x, y, x, True, 0.125)
    for name, t in (("q", x), ("k", x.transpose(1, 2).contiguous()
                                .transpose(1, 2))):
        tfa._check_tma(name, t)              # any positive strides pass


@pytest.mark.parametrize("bad", ["dout_expanded", "out_shape", "lse_shape",
                                 "f32_entry"])
def test_bf16_backward_rejects_what_it_cannot_take(bad):
    """The bf16 backward (``flash_bwd``) reads q, k, v and dout through TMA
    maps and out and lse as given: a dout stepped by stride 0, an out or
    an lse of the wrong shape raise before anything builds or launches
    (CPU tensors exercise the checks); f32 never reaches it."""
    B, L, H, D = 2, 8, 4, 64
    x = torch.zeros(B, L, H, D, dtype=torch.bfloat16)
    out, dout = x, x
    lse = torch.zeros(B, H, L)
    if bad == "dout_expanded":
        dout = torch.zeros(B, L, 1, D, dtype=torch.bfloat16).expand(B, L, H, D)
    elif bad == "out_shape":
        out = x[:, :4]
    elif bad == "lse_shape":
        lse = torch.zeros(B, L, H)
    if bad == "f32_entry":
        f = x.float()
        with pytest.raises(ValueError, match="dtype|kernel|bf16"):
            tfa._bwd_bf16(f, f, f, f, lse, f, True, 0.125)
        return
    with pytest.raises(ValueError):
        tfa._bwd_bf16(x, x, x, out, lse, dout, True, 0.125)


def test_forward_sits_on_the_hopper_tile_core():
    """K1's and K2's bf16 instances are the Hopper tile core's (wgmma
    products, TMA maps from cuTensorMapEncodeTiled through the runtime, no
    -lcuda): K2 is one kernel with an f32 dq accumulator summed by TMA
    reduce-adds, and its mma.sync split survives only in f32 (the CUDA-core
    helpers, as the f32 forward's)."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    core = (_build.CSRC / "hopper_attention.cuh").read_text()
    assert '#include "hopper_attention.cuh"' in src
    assert "flash_fwd_kernel<D><<<" in src
    assert "flash_fwd_f32_kernel<T, D><<<" in src
    assert "cudaGetDriverEntryPoint" in core and "-lcuda" not in \
        " ".join(_build.NVCC_FLAGS)
    assert "cp.async.bulk.tensor.4d" in core
    assert "flash_bwd_kernel<D><<<" in src           # K2's bf16 kernel
    assert "tma_reduce_add_4d(&tdq" in src
    assert "cp.reduce.async.bulk.tensor.4d" in core
    assert "cp.async.bulk.shared::cluster" in core   # its lse/delta copies
    assert "bwd_dq<float, 64>" in src and "bwd_dq<bf16" not in src
    assert "bwd_dkv<float, 64>" in src and "bwd_dkv<bf16" not in src
    argtypes, _ = _build.SIGNATURES["flash_attention"]["flash_fwd_launch"]
    assert len(argtypes) == 15                       # signature unchanged

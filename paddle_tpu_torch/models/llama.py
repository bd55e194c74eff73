"""Llama forward in PyTorch — the port of ``paddle_tpu/models/llama.py``.

Parameters keep the JAX package's LAYER-STACKED layout (a flat dict whose
per-layer entries carry a leading ``[L]`` dim) and its ``x @ W``
orientation, so converting weights between the packages needs no
transposes (``params_from_jax``). ``jax.lax.scan`` over layers becomes a
Python loop over views of the stacked tensors.

Numerics follow the reference: RMSNorm, rope and softmax in f32, bf16
(or the config dtype) activations, f32 logits. Attention defaults to the
flash path (``ops/flash_attention.py``: kernels K1/K2 on CUDA tensors,
their plain versions on CPU tensors), as the JAX package's ``_attention``
does; ``use_flash=False`` keeps the plain -1e30-masked softmax.

Training: ``llama_trunk`` applies the JAX package's remat schedules with
``torch.utils.checkpoint`` (``remat_policy``), ``llama_loss`` is the
masked-mean token cross-entropy, dense or sequence-chunked
(``_chunked_ce``). Layer parameters may be stacked ``[L, ...]`` tensors
or per-layer sequences of tensors (``layer_slice`` indexes either); the
trainer uses the latter so that each layer's gradient is that layer's
size. The MoE branch is not ported: a config with experts raises.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .._device import resolve_device
from ..ops.flash_attention import flash_attention_raw

__all__ = ["LlamaConfig", "init_params", "params_from_jax", "llama_forward",
           "llama_loss", "llama_trunk", "remat_policy", "split_layer_params",
           "resolve_head", "lm_head_logits"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    num_experts: int = 0        # MoE is not ported: > 0 raises

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=4, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=128,
                 dtype=torch.float32)
        d.update(kw)
        return cls(**d)

    @classmethod
    def llama2_7b(cls, **kw):
        return cls(**{**dict(hidden_size=4096, intermediate_size=11008,
                             num_hidden_layers=32, num_attention_heads=32,
                             num_key_value_heads=32), **kw})


_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "ln1",
               "ln2")


def _param_shapes(c: LlamaConfig) -> dict:
    L, D, F, V = (c.num_hidden_layers, c.hidden_size, c.intermediate_size,
                  c.vocab_size)
    H, KV, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim
    shapes = {"embed_tokens": (V, D), "wq": (L, D, H * hd),
              "wk": (L, D, KV * hd), "wv": (L, D, KV * hd),
              "wo": (L, H * hd, D), "w_gate": (L, D, F), "w_up": (L, D, F),
              "w_down": (L, F, D)}
    if not c.tie_word_embeddings:
        shapes["lm_head"] = (D, V)
    return shapes


def init_params(config: LlamaConfig, seed: int = 0, device="cuda") -> dict:
    """The port's own seeded init: the JAX package's names, shapes and
    std 0.02 normals (norm weights are ones, in f32), drawn from a
    ``torch.Generator`` on ``device``. Each stacked tensor is filled one
    layer at a time, so a 7B model initializes on the GPU in seconds with
    an f32 scratch of one layer's slice and never passes through the CPU.
    The draws are not the JAX PRNG's: tests that compare the packages
    convert the JAX weights with :func:`params_from_jax` instead."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    params = {}
    for name, shape in _param_shapes(c).items():
        out = torch.empty(shape, dtype=c.dtype, device=dev)
        chunks = out if name in _LAYER_KEYS else out[None]
        for chunk in chunks:
            chunk.copy_(torch.randn(chunk.shape, generator=gen, device=dev,
                                    dtype=torch.float32) * 0.02)
        params[name] = out
    L, D = c.num_hidden_layers, c.hidden_size
    params["ln1"] = torch.ones((L, D), dtype=torch.float32, device=dev)
    params["ln2"] = torch.ones((L, D), dtype=torch.float32, device=dev)
    params["norm"] = torch.ones((D,), dtype=torch.float32, device=dev)
    return params


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(np_params: dict, config: LlamaConfig,
                    device="cuda") -> dict:
    """The JAX package's params dict (values as numpy arrays) as the port's
    dict on ``device``: same names, same layer-stacked shapes, same
    dtypes — no transposes, since both packages multiply ``x @ W``."""
    dev = resolve_device(device)
    expected = _param_shapes(config)
    out = {}
    for name, a in np_params.items():
        if name not in expected and name not in ("ln1", "ln2", "norm"):
            raise ValueError(f"params_from_jax: unsupported param {name!r} "
                             "(MoE weights are not ported)")
        t = _to_torch(a)
        if name in expected and tuple(t.shape) != expected[name]:
            raise ValueError(f"params_from_jax: {name} has shape "
                             f"{tuple(t.shape)}, config wants "
                             f"{expected[name]}")
        out[name] = t.to(dev)
    return out


def _rope(q, k, positions, theta, head_dim):
    """Rotary embedding in f32; q/k [B, T, heads, hd], positions [B, T]."""
    dev = q.device
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=dev) / head_dim))
    angles = positions[..., None].to(torch.float32) * freqs   # [B, T, hd/2]
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]

    def rot(x):
        x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    return rot(q).to(q.dtype), rot(k).to(k.dtype)


def _rmsnorm(x, w, eps):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def f32_scale(head_dim: int) -> float:
    """1/sqrt(hd) rounded the way the reference computes it in f32
    (``1 / jnp.sqrt(jnp.float32(hd))``), as a Python float."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


def _expand_gqa(k, v, config):
    """Repeat kv heads up to the query head count (GQA → MHA layout)."""
    H, KV = config.num_attention_heads, config.num_key_value_heads
    if KV != H:
        rep = H // KV
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return k, v


def _attention(q, k, v, config, use_flash=True, flash=flash_attention_raw):
    """Causal attention, q [B,T,H,hd], k/v [B,S,KV,hd], bottom-right
    aligned. ``use_flash``: the flash path through ``flash`` (by default
    K1 forward, K2 backward on CUDA tensors; ``flash_attention_plain``
    holds a layer to their plain versions); otherwise the plain path: f32
    logits, -1e30 mask, f32 softmax rounded to q.dtype."""
    k, v = _expand_gqa(k, v, config)
    if use_flash:
        return flash(q, k, v, causal=True)
    scale = 1.0 / math.sqrt(config.head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    T, S = logits.shape[-2], logits.shape[-1]
    mask = torch.ones((T, S), dtype=torch.bool,
                      device=q.device).tril(diagonal=S - T)
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def split_layer_params(params):
    layer = {k: v for k, v in params.items() if k in _LAYER_KEYS}
    other = {k: v for k, v in params.items() if k not in _LAYER_KEYS}
    return layer, other


def layer_slice(layer_p, l):
    """Layer ``l``'s parameters: views of stacked ``[L, ...]`` tensors, or
    the ``l``-th entries of per-layer sequences."""
    return {k: v[l] for k, v in layer_p.items()}


def resolve_head(other):
    """The lm head matrix [D, V] (tied → transposed embedding)."""
    head = other.get("lm_head")
    if head is None:
        head = other["embed_tokens"].T
    return head


def lm_head_logits(x, other, config: LlamaConfig):
    """Final RMSNorm + lm-head projection with f32 logits: the operands
    are the model-dtype values widened exactly to f32, so this is the
    reference's model-dtype product with f32 accumulation."""
    x = _rmsnorm(x, other["norm"], config.rms_norm_eps)
    head = resolve_head(other).to(x.dtype)
    return torch.matmul(x.to(torch.float32), head.to(torch.float32))


def _qkv(h, lp, c):
    B, T, _ = h.shape
    q = (h @ lp["wq"]).reshape(B, T, c.num_attention_heads, c.head_dim)
    k = (h @ lp["wk"]).reshape(B, T, c.num_key_value_heads, c.head_dim)
    v = (h @ lp["wv"]).reshape(B, T, c.num_key_value_heads, c.head_dim)
    return q, k, v


def _mlp(x, lp, c):
    h2 = _rmsnorm(x, lp["ln2"], c.rms_norm_eps)
    ff = torch.nn.functional.silu(h2 @ lp["w_gate"]) * (h2 @ lp["w_up"])
    return x + (ff @ lp["w_down"])


def _decoder_layer(x, lp, config, positions, flash=flash_attention_raw):
    """One dense decoder block with causal attention over its own rows
    (through ``flash``, see ``_attention``); returns (x, k, v) — the
    rotated K and the V it attended."""
    c = config
    B, T, _ = x.shape
    q, k, v = _qkv(_rmsnorm(x, lp["ln1"], c.rms_norm_eps), lp, c)
    q, k = _rope(q, k, positions, c.rope_theta, c.head_dim)
    att = _attention(q, k, v, c, flash=flash)
    x = x + (att.reshape(B, T, -1) @ lp["wo"])
    return _mlp(x, lp, c), k, v


def _no_moe(config):
    if config.num_experts:
        raise NotImplementedError("the MoE branch of the Llama model is not "
                                  "ported (ROADMAP Queue 1)")


def _positions(B, T, device):
    return torch.arange(T, dtype=torch.int32, device=device)[None, :] \
        .expand(B, T)


def _embed(other, tokens, config):
    return other["embed_tokens"][tokens.long()].to(config.dtype)


def _trunk(params, tokens, config: LlamaConfig):
    """Embedding + every decoder layer over tokens [B, T]: (final hidden
    [B, T, D], other params, per-layer K list, per-layer V list)."""
    _no_moe(config)
    layer_p, other = split_layer_params(params)
    B, T = tokens.shape
    x = _embed(other, tokens, config)
    positions = _positions(B, T, x.device)
    ks, vs = [], []
    for l in range(config.num_hidden_layers):
        x, k, v = _decoder_layer(x, layer_slice(layer_p, l), config,
                                 positions)
        ks.append(k)
        vs.append(v)
    return x, other, ks, vs


_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
              torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy():
    """The selective remat policy of ``remat=True`` (JAX's
    ``dots_saveable``): save the outputs of matrix products (aten mm,
    addmm, bmm), recompute everything else in the backward — the flash
    forward included, so K1 launches twice per layer per step. Returns a
    ``context_fn`` for ``torch.utils.checkpoint.checkpoint``."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return functools.partial(create_selective_checkpoint_contexts,
                             _save_dots)


def llama_trunk(x, layer_params, config: LlamaConfig, positions=None,
                remat=True):
    """Every decoder layer over x [B, T, D]; ``layer_params`` holds
    stacked ``[L, ...]`` tensors or per-layer sequences.

    remat: False (keep every activation) | True (save matrix-product
    outputs, recompute the rest: ``remat_policy``) | "full" (save only
    each layer's input). ``"dots_noffn"`` is not ported. Outside autograd
    (no grad enabled) there is nothing to rematerialise and every schedule
    runs the layers directly."""
    from torch.utils.checkpoint import checkpoint
    _no_moe(config)
    if remat not in (False, True, "full"):
        raise NotImplementedError(f"remat={remat!r} is not ported (ROADMAP "
                                  "Queue 1); use False, True or 'full'")
    B, T, _ = x.shape
    if positions is None:
        positions = _positions(B, T, x.device)

    def layer(x, lp):
        return _decoder_layer(x, lp, config, positions)[0]

    for l in range(config.num_hidden_layers):
        lp = layer_slice(layer_params, l)
        if not remat or not torch.is_grad_enabled():
            x = layer(x, lp)
        elif remat == "full":
            x = checkpoint(layer, x, lp, use_reentrant=False)
        else:
            x = checkpoint(layer, x, lp, use_reentrant=False,
                           context_fn=remat_policy())
    return x


def llama_forward(params, tokens, config: LlamaConfig, remat=True):
    """tokens [B, T] int → f32 logits [B, T, V] (logits only: the JAX
    package also returns the MoE aux loss, which is not ported)."""
    layer_p, other = split_layer_params(params)
    x = _embed(other, tokens, config)
    x = llama_trunk(x, layer_p, config, remat=remat)
    return lm_head_logits(x, other, config)


def _token_nll(logits, labels):
    """(sum of −log p(label), count) over labels >= 0; logits f32. Labels
    below 0 are clamped before the gather (torch.gather raises on them
    where JAX's take_along_axis wraps) and then masked out."""
    logp = torch.log_softmax(logits, dim=-1)
    lab = labels.long()
    ll = logp.gather(-1, lab.clamp_min(0)[..., None])[..., 0]
    mask = (lab >= 0).to(torch.float32)
    return -torch.sum(ll * mask), torch.sum(mask)


def _chunked_ce(x, head, labels, chunk):
    """Sequence-chunked cross-entropy over the normed hidden x [B, T, D]:
    one [B, chunk, V] block of f32 logits at a time, each chunk under
    ``checkpoint`` so its logits are recomputed in the backward instead of
    kept. Returns (sum_nll, n_tokens)."""
    from torch.utils.checkpoint import checkpoint
    B, T, D = x.shape
    if T % chunk:
        raise ValueError(f"loss_chunk {chunk} does not divide T={T}")

    def one(xc, lc):
        logits = torch.matmul(xc.to(torch.float32),
                              head.to(xc.dtype).to(torch.float32))
        return _token_nll(logits, lc)

    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(T // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        if torch.is_grad_enabled():
            a, b = checkpoint(one, x[:, sl], labels[:, sl],
                              use_reentrant=False)
        else:
            a, b = one(x[:, sl], labels[:, sl])
        nll, n = nll + a, n + b
    return nll, n


def llama_loss(params, tokens, labels, config: LlamaConfig, remat=True,
               loss_chunk=None):
    """Masked-mean token cross-entropy (labels < 0 are ignored) of tokens
    [B, T] against labels [B, T], an f32 scalar. ``loss_chunk``: sequence
    chunk of the cross-entropy (None: the dense [B, T, V] logits)."""
    _no_moe(config)
    if loss_chunk:
        layer_p, other = split_layer_params(params)
        x = llama_trunk(_embed(other, tokens, config), layer_p, config,
                        remat=remat)
        x = _rmsnorm(x, other["norm"], config.rms_norm_eps)
        nll, n = _chunked_ce(x, resolve_head(other), labels, loss_chunk)
    else:
        logits = llama_forward(params, tokens, config, remat)
        nll, n = _token_nll(logits, labels)
    return nll / torch.clamp_min(n, 1.0)

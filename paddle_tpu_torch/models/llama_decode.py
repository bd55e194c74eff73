"""KV-cache incremental decode — the port of
``paddle_tpu/models/llama_decode.py``.

``llama_generate`` (prefill + a loop of single-token steps over a dense
``[L, B, S, KV, hd]`` cache) is the single-stream greedy oracle the paged
serving path is held to. ``_cached_attention_slots`` is the decode-row
oracle of the ragged kernel. The cache is updated in place where the JAX
package wrote a fresh buffer through ``dynamic_update_slice``.

The slot primitives run over a dense per-slot cache (``init_kv_cache``,
``[B, S, KV, hd]`` per layer) whose batch axis is a POOL OF SLOTS with
independent positions: ``llama_prefill_slot`` prefills one bucket-padded
prompt into one slot (its attention through ``_attention``: kernel K1 on
a CUDA tensor), ``llama_decode_step_slots`` advances every slot one token
at its own position, and ``llama_decode_burst`` runs n such steps with
the serving engine's stop rules. The speculative draft
(``inference/speculative.py``) is their caller in the port; the slot
attention is plain tensor arithmetic, as in the JAX package.

Sampling: greedy (``temperature <= 0``) is argmax and is held to the JAX
package token for token. Temperature and top-k sampling draw from an
explicit ``torch.Generator``; they cannot reproduce ``jax.random``'s bits.
"""
from __future__ import annotations

import torch

from .._device import resolve_device
from .llama import (LlamaConfig, _mlp, _qkv, _rmsnorm, _rope, _trunk,
                    f32_scale, layer_slice, lm_head_logits,
                    split_layer_params)

__all__ = ["init_kv_cache", "llama_prefill", "llama_decode_step",
           "llama_generate", "llama_decode_step_slots", "llama_prefill_slot",
           "llama_decode_burst"]


def init_kv_cache(config: LlamaConfig, batch: int, max_len: int,
                  device="cuda"):
    """Per-layer tuples of zeroed [B, S_max, KV, hd] buffers."""
    c = config
    dev = resolve_device(device)
    shape = (batch, max_len, c.num_key_value_heads, c.head_dim)
    return {
        "k": tuple(torch.zeros(shape, dtype=c.dtype, device=dev)
                   for _ in range(c.num_hidden_layers)),
        "v": tuple(torch.zeros(shape, dtype=c.dtype, device=dev)
                   for _ in range(c.num_hidden_layers)),
    }


def _prefill_stacked(params, tokens, config: LlamaConfig):
    """Prompt forward: (logits [B,T,V], ks, vs stacked [L,B,T,KV,hd])."""
    x, other, ks, vs = _trunk(params, tokens, config)
    return lm_head_logits(x, other, config), torch.stack(ks), \
        torch.stack(vs)


def llama_prefill(params, tokens, config: LlamaConfig, max_len: int):
    """Prompt forward: logits [B, T, V] + a cache whose [0:T] rows are the
    prompt's K/V. T must be ≤ max_len."""
    T = tokens.shape[1]
    if T > max_len:
        raise ValueError(f"prompt length {T} exceeds max_len {max_len}")
    logits, ks, vs = _prefill_stacked(params, tokens, config)
    pad = (0, 0, 0, 0, 0, max_len - T)
    cache = {
        "k": tuple(torch.nn.functional.pad(ks[l], pad)
                   for l in range(config.num_hidden_layers)),
        "v": tuple(torch.nn.functional.pad(vs[l], pad)
                   for l in range(config.num_hidden_layers)),
    }
    return logits, cache


def _cached_attention_slots(q, kc, vc, pos, config):
    """Per-slot positions: q [B,1,H,hd]; kc/vc [B,S,KV,hd]; pos [B].
    Grouped einsum (no repeat of the cache to H heads), f32 logits, -1e30
    mask over rows > pos, f32 softmax rounded to q.dtype. This is the
    decode-row oracle of the ragged kernel."""
    c = config
    H, KV = c.num_attention_heads, c.num_key_value_heads
    g = H // KV
    B, _, _, hd = q.shape
    S = kc.shape[1]
    qg = q.reshape(B, 1, KV, g, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          kc.to(torch.float32)) * f32_scale(c.head_dim)
    valid = (torch.arange(S, device=q.device)[None, :]
             <= pos.to(q.device)[:, None].long())
    logits = logits.masked_fill(~valid[:, None, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, vc)
    return out.reshape(B, 1, H, hd)


def _decode_step_stacked(params, ks, vs, pos: int, token, config):
    """One decode step on a STACKED [L,B,S,KV,hd] cache at the scalar
    position ``pos`` (written in place)."""
    c = config
    layer_p, other = split_layer_params(params)
    B = token.shape[0]
    x = other["embed_tokens"][token.long()[:, None]].to(c.dtype)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    pos_v = torch.full((B,), pos, dtype=torch.int32, device=x.device)
    for l in range(c.num_hidden_layers):
        lp = layer_slice(layer_p, l)
        h = _rmsnorm(x, lp["ln1"], c.rms_norm_eps)
        q, k, v = _qkv(h, lp, c)
        q, k = _rope(q, k, positions, c.rope_theta, c.head_dim)
        ks[l, :, pos] = k[:, 0]
        vs[l, :, pos] = v[:, 0]
        att = _cached_attention_slots(q, ks[l], vs[l], pos_v, c)
        x = x + (att.reshape(B, 1, -1) @ lp["wo"])
        x = _mlp(x, lp, c)
    return lm_head_logits(x[:, 0, :], other, c)


def llama_decode_step(params, cache, pos: int, token, config: LlamaConfig):
    """One incremental step: token [B] (the previously emitted token) at
    position ``pos``. Returns (next-token logits [B, V], updated cache);
    the cache's buffers are written in place."""
    ks = torch.stack(cache["k"])
    vs = torch.stack(cache["v"])
    logits = _decode_step_stacked(params, ks, vs, int(pos), token, config)
    L = config.num_hidden_layers
    return logits, {"k": tuple(ks[l] for l in range(L)),
                    "v": tuple(vs[l] for l in range(L))}


def llama_decode_step_slots(params, cache, pos, token, config: LlamaConfig):
    """``llama_decode_step`` with a PER-SLOT position vector.

    token [B] int32, pos [B] int32: slot b writes its K/V at row pos[b]
    (in place) and attends rows <= pos[b]. Free or finished slots rewrite
    their frozen row with identical values: dead compute, not corruption.
    Returns (next-token logits [B, V] f32, cache)."""
    c = config
    layer_p, other = split_layer_params(params)
    B = token.shape[0]
    x = other["embed_tokens"][token.long()[:, None]].to(c.dtype)
    positions = pos[:, None].to(torch.int32)
    rows = torch.arange(B, device=x.device)
    at = pos.long()
    for l in range(c.num_hidden_layers):
        lp = layer_slice(layer_p, l)
        h = _rmsnorm(x, lp["ln1"], c.rms_norm_eps)
        q, k, v = _qkv(h, lp, c)
        q, k = _rope(q, k, positions, c.rope_theta, c.head_dim)
        kc, vc = cache["k"][l], cache["v"][l]
        kc[rows, at] = k[:, 0]
        vc[rows, at] = v[:, 0]
        att = _cached_attention_slots(q, kc, vc, pos, c)
        y = x + (att.reshape(B, 1, -1) @ lp["wo"])
        x = _mlp(y, lp, c)
    return lm_head_logits(x[:, 0, :], other, c), cache


def llama_prefill_slot(params, cache, tokens, slot: int, tlen: int,
                       config: LlamaConfig, temperature: float = 0.0,
                       top_k: int = 0, generator=None):
    """Prefill ONE request into cache slot ``slot``.

    tokens [Tb] int32, the prompt padded to a bucket length; ``tlen`` the
    real prompt length. Writes rows [0, Tb) of the slot in place (pad rows
    hold K/V that decode overwrites before its mask ever reaches them),
    samples the first generated token from the logits at tlen - 1, and
    returns (first token as a 0-d int32 tensor, cache)."""
    Tb = tokens.shape[0]
    S = cache["k"][0].shape[1]
    if not 1 <= int(tlen) <= Tb <= S:
        raise ValueError(f"prompt length {tlen}, bucket {Tb}, cache rows "
                         f"{S}: want 1 <= tlen <= bucket <= rows")
    with torch.no_grad():
        x, other, ks, vs = _trunk(params, tokens[None, :], config)
        for l in range(config.num_hidden_layers):
            cache["k"][l][int(slot), :Tb] = ks[l][0]
            cache["v"][l][int(slot), :Tb] = vs[l][0]
        logits = lm_head_logits(x[:, int(tlen) - 1, :], other, config)
        first = _sample(logits, temperature, top_k, generator)
    return first[0], cache


def llama_decode_burst(params, cache, pos, tok, done, limit, eos_id: int,
                       config: LlamaConfig, n: int, temperature: float = 0.0,
                       top_k: int = 0, pad_id: int = 0, generator=None):
    """n slot-decode steps, the dense serving hot loop.

    pos/tok/done/limit [B]; ``eos_id`` -1 for none. A slot stops advancing
    when it emits eos_id or its position reaches ``limit`` (= prompt_len +
    max_new - 1, capped at S - 1); finished slots emit ``pad_id`` and
    freeze. Returns (cache, pos, tok, done, emitted [n, B])."""
    emitted = []
    with torch.no_grad():
        for _ in range(n):
            logits, cache = llama_decode_step_slots(params, cache, pos, tok,
                                                    config)
            nxt = _sample(logits, temperature, top_k, generator)
            emitted.append(torch.where(done, torch.full_like(nxt, pad_id),
                                       nxt))
            new_pos = torch.where(done, pos, pos + 1)
            tok = torch.where(done, tok, nxt)
            done = done | (nxt == eos_id) | (new_pos >= limit)
            pos = new_pos
    emitted = torch.stack(emitted) if emitted \
        else torch.empty((0, tok.shape[0]), dtype=tok.dtype,
                         device=tok.device)
    return cache, pos, tok, done, emitted


def _sample(logits, temperature, top_k, generator=None):
    """Greedy argmax at temperature <= 0 (first index on ties, like
    jnp.argmax); otherwise top-k filtered categorical sampling from
    ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    out = torch.multinomial(flat, 1, generator=generator)
    return out.reshape(probs.shape[:-1]).to(torch.int32)


def llama_generate(params, tokens, config: LlamaConfig, max_new_tokens: int,
                   temperature: float = 0.0, top_k: int = 0, generator=None,
                   max_len: int | None = None, device="cuda"):
    """Prefill + a loop of decode steps. tokens [B, T] → generated [B, N]
    int32. The params must already live on ``device``."""
    dev = resolve_device(device)
    if params["embed_tokens"].device != dev:
        raise ValueError(f"params live on {params['embed_tokens'].device}, "
                         f"generate was asked to run on {dev}")
    tokens = torch.as_tensor(tokens, device=dev)
    B, T = tokens.shape
    if max_new_tokens <= 0:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev)
    S = max_len or (T + max_new_tokens)
    with torch.no_grad():
        logits, ks, vs = _prefill_stacked(params, tokens, config)
        pad = (0, 0, 0, 0, 0, S - T)
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
        tok = _sample(logits[:, -1, :], temperature, top_k, generator)
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits = _decode_step_stacked(params, ks, vs, T + i, tok, config)
            tok = _sample(logits, temperature, top_k, generator)
            out.append(tok)
    return torch.stack(out, dim=1)

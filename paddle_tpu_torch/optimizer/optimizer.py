"""Optimizer base — the port of ``paddle_tpu/optimizer/optimizer.py``'s
functional path (``init_state`` / ``apply_gradients``), the one
``LlamaTrainStep`` uses.

Parameters, gradients and state are dicts keyed by parameter name. A value
is a tensor or a sequence of tensors (the trainer's per-layer leaves); the
state of a parameter is a dict of tensors (``{"moment1", "moment2"}`` for
Adam), or a sequence of such dicts beside a sequence of tensors.

``apply_gradients`` updates parameters and state IN PLACE under
``torch.no_grad()`` and returns the same dicts: the JAX package's update
is pure, but at Llama-2-7B an out-of-place update would double 54 GB of
weights, gradients and moments. It walks each tensor in slices along its
first dimension of at most ``_SLICE_ELEMS`` elements (one layer of a
stacked ``[L, ...]`` weight), so its f32 temporaries stay at one layer's
size. Every operation is elementwise, so the slicing changes no value.

The rounding order is the JAX package's: the gradient is cast to the
parameter dtype; the update rule's step is cast to the parameter dtype
before it is subtracted; then the decoupled decay ``(lr·wd·p)`` —
computed in f32 from the pre-update ``p`` — is cast to the parameter dtype
and subtracted.
Every parameter is decayed, norm weights included, as the JAX functional
path does. ``lr`` is taken as an f32 scalar, as ``LlamaTrainStep`` passes
it to the JAX step.

``learning_rate`` is a float or an ``LRScheduler`` (``lr.py``), whose
current value ``get_lr()`` returns. Master weights (``multi_precision``)
and the eager ``step()`` API over ``parameters`` are not ported (ROADMAP
Queue 1 item 9): asking for them raises.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["Optimizer"]

_SLICE_ELEMS = 1 << 26


def _pairs(value, state):
    """(tensor, state dict) pairs of one parameter entry."""
    if isinstance(value, (list, tuple)):
        return list(zip(value, state))
    return [(value, state)]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if not isinstance(learning_rate, (numbers.Real, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, not {type(learning_rate)}")
        if parameters is not None or multi_precision:
            raise NotImplementedError(
                "the eager step() API over a parameters list and master "
                "weights (multi_precision) are not ported (ROADMAP Queue 1 "
                "item 9); use init_state/apply_gradients")
        self._learning_rate = learning_rate \
            if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self._grad_clip = grad_clip
        if weight_decay is None:
            self._weight_decay = 0.0
        elif isinstance(weight_decay, numbers.Real):
            self._weight_decay = float(weight_decay)
        else:  # L2Decay-style object
            self._weight_decay = float(getattr(
                weight_decay, "_coeff", getattr(weight_decay, "coeff", 0.0)))
        self._step_count = 0

    # ---------------- lr ----------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return self._learning_rate

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    # ---------------- update rule (override) ----------------
    def _init_one(self, p) -> dict:
        """Per-parameter state, zeros in the rule's dtypes."""
        return {}

    def _update_one(self, p, g, state: dict, lr: float, step: int):
        """Update ``p`` and ``state`` in place from the gradient ``g``
        (already in p's dtype). Override in subclasses."""
        raise NotImplementedError

    def _decoupled_decay(self) -> bool:
        """AdamW-style decay (True) vs L2 regularisation in the gradient."""
        return False

    # ---------------- functional API ----------------
    def init_state(self, params):
        """params dict → state dict of the same structure."""
        return {k: [self._init_one(p) for p in v]
                if isinstance(v, (list, tuple)) else self._init_one(v)
                for k, v in params.items()}

    @torch.no_grad()
    def apply_gradients(self, grads, params, state, lr=None, step=None):
        """Update ``params`` and ``state`` in place from ``grads`` (None
        entries are skipped); returns (params, state)."""
        lr = self.get_lr() if lr is None else float(lr)
        step = self._step_count + 1 if step is None else int(step)
        if self._grad_clip is not None:
            grads = self._grad_clip.clip_tree(grads)
        for name, value in params.items():
            g = grads.get(name)
            if g is None:
                continue
            gs = g if isinstance(value, (list, tuple)) else [g]
            for (p, st), gi in zip(_pairs(value, state[name]), gs):
                if gi is not None:
                    self._apply_sliced(p, gi, st, lr, step)
        return params, state

    def _apply_sliced(self, p, g, st, lr, step):
        if p.dim() == 0 or p.numel() <= _SLICE_ELEMS:
            return self._apply_one(p, g, st, lr, step)
        per = max(1, _SLICE_ELEMS // max(1, p[0].numel()))
        for r in range(0, p.shape[0], per):
            sl = slice(r, r + per)
            self._apply_one(p[sl], g[sl], {k: v[sl] for k, v in st.items()},
                            lr, step)

    def _apply_one(self, p, g, st, lr, step):
        g_w = g.to(p.dtype)
        wd = self._weight_decay
        if wd and not self._decoupled_decay():
            # the JAX package's Python-float wd meets p in p's dtype
            g_w = g_w + torch.tensor(wd, dtype=p.dtype, device=p.device) * p
        decay = None
        if wd and self._decoupled_decay():      # from the pre-update p
            lr_wd = float(np.float32(lr) * np.float32(wd))
            decay = (p.to(torch.float32) * lr_wd).to(p.dtype)
        self._update_one(p, g_w, st, lr, step)
        if decay is not None:
            p.sub_(decay)

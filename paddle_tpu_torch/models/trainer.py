"""Llama training step on one device — the port of
``paddle_tpu/models/trainer.py``'s ``LlamaTrainStep`` (its single-device
branch).

    step = LlamaTrainStep(config, optimizer=AdamW(...), device="cuda")
    loss = step(tokens, labels)        # forward, backward, update

Each call runs ``llama_loss`` forward (with an MoE config its aux loss
included), ``loss.backward()`` (attention through kernels K1/K2 on the
card), then ``apply_gradients`` in place at the optimizer's current
``get_lr()`` (a float, or an ``LRScheduler``'s value, rounded to f32 as
the JAX step receives it), and returns the loss as a device tensor
without a host sync.

Parameters stay in the JAX package's layer-stacked layout (``params``),
but autograd sees one leaf per layer and matrix: ``stacked[l]`` detached,
a view of the same storage. Indexing a stacked leaf instead would make the
backward of every ``v[l]`` materialise and sum a full ``[L, ...]`` zero
gradient per layer; with per-layer leaves each layer's gradient is that
layer's size, and the in-place update writes through the views into the
stacked tensors that serving code reads. The optimizer state is stacked
the same way and updated through per-layer views.

A mesh, microbatches and pipeline schedules are not ported (ROADMAP
Queue 1 item 8), nor the span, metrics, fleet and device-trace hooks of
the JAX step (Queue 1 item 2, after item 5's observability modules).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..optimizer import AdamW, Optimizer
from . import llama as L
from .llama import _to_torch

__all__ = ["LlamaTrainStep", "opt_state_from_jax"]


def opt_state_from_jax(np_state: dict, device="cuda") -> dict:
    """The JAX package's optimizer state (``{name: {"moment1": arr,
    "moment2": arr, ...}}``, values as numpy arrays, bf16 or f32) as the
    port's state dict on ``device``, same names, shapes and dtypes."""
    dev = resolve_device(device)
    return {name: {k: _to_torch(a).to(dev) for k, a in st.items()}
            for name, st in np_state.items()}


def _per_layer(tree: dict, n_layers: int) -> dict:
    """Layer-stacked entries as lists of per-layer views."""
    return {k: [v[l] for l in range(n_layers)] if k in L._LAYER_KEYS else v
            for k, v in tree.items()}


class LlamaTrainStep:
    """step = LlamaTrainStep(config, optimizer=...); loss = step(tokens,
    labels)"""

    def __init__(self, config: L.LlamaConfig, mesh=None,
                 optimizer: Optimizer | None = None,
                 num_microbatches: int = 1, remat=True, seed: int = 0,
                 pp_schedule: str = "gpipe", loss_chunk: int | None = None,
                 device="cuda"):
        if mesh is not None or num_microbatches != 1 \
                or pp_schedule.lower() != "gpipe":
            raise NotImplementedError(
                "LlamaTrainStep runs on one device: a mesh, microbatches "
                "and pipeline schedules are not ported (ROADMAP Queue 1 "
                "item 8)")
        self.config = config
        self.optimizer = optimizer or AdamW(learning_rate=3e-4,
                                            weight_decay=0.1)
        self.remat = remat
        self.loss_chunk = loss_chunk
        self.device = resolve_device(device)
        self._step_i = 0
        self._set(L.init_params(config, seed=seed, device=self.device),
                  None)

    def _set(self, params: dict, opt_state):
        """Adopt stacked params and state; build the per-layer leaves and
        views the step works on."""
        self._params = params
        self._opt_state = self.optimizer.init_state(params) \
            if opt_state is None else opt_state
        n = self.config.num_hidden_layers
        self._leaves = {k: [t.detach().requires_grad_() for t in v]
                        if isinstance(v, list)
                        else v.detach().requires_grad_()
                        for k, v in _per_layer(params, n).items()}
        self._state_views = {k: [{s: t[l] for s, t in st.items()}
                                 for l in range(n)]
                             if k in L._LAYER_KEYS else st
                             for k, st in self._opt_state.items()}

    def _ints(self, a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(a, np.int32))
        return a.to(self.device, torch.int32)

    def __call__(self, tokens, labels):
        tokens = self._ints(tokens)
        labels = self._ints(labels)
        self._step_i += 1
        lr = float(np.float32(self.optimizer.get_lr()))
        loss = L.llama_loss(self._leaves, tokens, labels, self.config,
                            remat=self.remat, loss_chunk=self.loss_chunk)
        loss.backward()
        grads = {k: [t.grad for t in v] if isinstance(v, list) else v.grad
                 for k, v in self._leaves.items()}
        self.optimizer.apply_gradients(grads, self._leaves,
                                       self._state_views,
                                       lr=lr,
                                       step=self._step_i)
        del grads
        for v in self._leaves.values():
            for t in (v if isinstance(v, list) else [v]):
                t.grad = None
        return loss.detach()

    @property
    def params(self):
        return self._params

    # ---- resilience protocol ----
    def resilience_state(self):
        """Params, optimizer moments and the step counter (bias correction
        depends on it): everything an exact resume needs."""
        return {"params": self._params, "opt_state": self._opt_state,
                "step": np.asarray(self._step_i, np.int64)}

    def load_resilience_state(self, state):
        """Adopt a ``resilience_state()`` — or the JAX package's, converted
        with ``params_from_jax`` and ``opt_state_from_jax``."""
        self._set(state["params"], state["opt_state"])
        self._step_i = int(np.asarray(state["step"]))

    def train_step(self, tokens, labels):
        return self(tokens, labels)

"""Adam and AdamW with stochastically rounded bf16 moments — the port of
``paddle_tpu/optimizer/optimizers.py`` (``_sr_cast``, ``Adam``,
``AdamW``). The other optimizers of that module are not ported (ROADMAP
Queue 1).

``_sr_cast`` reproduces the JAX package's dither bit for bit. torch has no
uint32 arithmetic, so the uint32 hash runs in int64 with every result
masked back to 32 bits: the shifts are then logical, as on uint32, and
each multiply by a 32-bit constant is split into 16-bit halves so that no
int64 product overflows.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]

_M32 = 0xFFFFFFFF


def _mul32(h, c: int):
    """(h · c) mod 2^32 for int64 h in [0, 2^32) and a 32-bit constant c,
    without an int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _sr_cast(x32, dtype, step, salt):
    """Stochastically rounded f32 → bf16 moment store: a uniform-in-ulp
    dither, hashed from the value's own bits mixed with (step, salt), is
    added to the low 16 bits before truncating, so the cast is unbiased
    and deterministic. Any other dtype is a plain cast."""
    if dtype != torch.bfloat16:
        return x32.to(dtype)
    bits = x32.to(torch.float32).view(torch.int32).to(torch.int64) & _M32
    mix = (2654435761 * (int(step) & _M32)
           + ((int(salt) * 0x9E3779B9) & _M32)) & _M32
    h = bits ^ mix
    h = _mul32(h, 2246822519)
    h = h ^ (h >> 13)
    h = _mul32(h, 3266489917)
    h = h ^ (h >> 16)
    dithered = (bits + (h & 0xFFFF)) & 0xFFFF0000
    dithered = torch.where(dithered >= 1 << 31, dithered - (1 << 32),
                           dithered)
    return dithered.to(torch.int32).view(torch.float32).to(dtype)


class Adam(Optimizer):
    """moment_dtype: storage dtype of the two moments (the arithmetic is
    f32); bf16 moments are stored through ``_sr_cast``. ``amsgrad`` is not
    ported."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False,
                 moment_dtype=torch.float32):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        if amsgrad:
            raise NotImplementedError("Adam(amsgrad=True) is not ported "
                                      "(ROADMAP Queue 1 item 9)")
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._moment_dtype = moment_dtype

    def _init_one(self, p):
        return {"moment1": torch.zeros_like(p, dtype=self._moment_dtype),
                "moment2": torch.zeros_like(p, dtype=self._moment_dtype)}

    def _update_one(self, p, g, state, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        md = self._moment_dtype
        f32 = np.float32
        g32 = g.to(torch.float32)
        m = b1 * state["moment1"].to(torch.float32) + (1 - b1) * g32
        v = b2 * state["moment2"].to(torch.float32) + (1 - b2) * g32 * g32
        # bias corrections in f32, as b ** f32(step) on the JAX side
        bc1 = float(f32(1) - f32(b1) ** f32(step))
        bc2 = float(f32(1) - f32(b2) ** f32(step))
        mhat = m / bc1
        vhat = v / bc2
        state["moment1"].copy_(_sr_cast(m, md, step, 1))
        state["moment2"].copy_(_sr_cast(v, md, step, 2))
        upd = float(f32(lr)) * mhat / (torch.sqrt(vhat) + eps)
        p.sub_(upd.to(p.dtype))


class AdamW(Adam):
    """Adam with decoupled weight decay."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False, moment_dtype=torch.float32):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name=name, amsgrad=amsgrad,
                         moment_dtype=moment_dtype)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_decay(self):
        return True

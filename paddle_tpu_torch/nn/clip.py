"""Gradient clipping by global norm — the port of
``paddle_tpu/nn/clip.py`` (``global_norm`` and the functional
``ClipGradByGlobalNorm.clip_tree``).

Gradients come as a dict whose values are tensors, per-layer sequences of
tensors, or None. The eager ``(param, grad)`` interface waits for the
framework surface (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm", "global_norm"]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, (list, tuple)):
            yield from (g for g in v if g is not None)
        elif v is not None:
            yield v


def global_norm(leaves):
    """sqrt of the sum over leaves of sum(leaf²), in f32."""
    total = 0
    for leaf in leaves:
        total = total + torch.sum(leaf.to(torch.float32) ** 2)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def clip_tree(self, grads):
        """Functional: a new dict with every gradient scaled by
        min(clip_norm / max(global_norm, 1e-6), 1), each in its own
        dtype."""
        gn = global_norm(_leaves(grads))
        scale = torch.clamp_max(self.clip_norm / torch.clamp_min(gn, 1e-6),
                                1.0)

        def one(g):
            if g is None:
                return None
            return (g.to(torch.float32) * scale.to(g.device)).to(g.dtype)

        return {k: [one(g) for g in v] if isinstance(v, (list, tuple))
                else one(v) for k, v in grads.items()}

"""Optimizers: AdamW and Adafactor over the port's nested dicts of
tensors.  The counterpart of ``src/repro/train/optimizer.py``.

The state mirrors the parameter tree, float32 whatever the parameters'
dtype, as in the reference: AdamW keeps ``m`` and ``v``, Adafactor the
factored second moments (row and column vectors) of every leaf of two or
more dimensions.  ``update(grads, state, params)`` returns ``(params,
state, metrics)`` as the reference's does, but it updates the parameters
and the state in place (the returned ones are the tensors it was given;
the gradients are left as they are): at 2.86 B parameters in float32 a
functional update would hold a second copy of the parameters and of ``m``
and ``v`` (34 GB) on the card.  One leaf's temporaries exist at a time.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .tree import tree_leaves, tree_map

__all__ = ["Optimizer", "adamw", "adafactor", "make_optimizer", "global_norm"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (new_params, new_state, metrics)
    name: str


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in
    float32."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(grads, clip_norm: Optional[float]):
    """The global norm of the gradients and the factor ``min(1, clip_norm
    / max(norm, 1e-9))`` they are scaled by (None without clipping)."""
    norm = global_norm(grads)
    if not clip_norm:
        return norm, None
    return norm, torch.clamp(clip_norm / torch.clamp_min(norm, 1e-9), max=1.0)


def _scaled(g: torch.Tensor, scale) -> torch.Tensor:
    """One leaf's gradient in float32, clipped: a new tensor."""
    return g.float() * scale if scale is not None else g.float()


def _f32(x: float) -> float:
    """A scalar as float32 rounds it, so the bias corrections and decay
    rates are the reference's float32 values."""
    return float(np.float32(x))


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: Optional[float] = 1.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        dev = tree_leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params):
        gnorm, scale = _clip_scale(grads, clip_norm)
        state["step"] += 1
        t = np.float32(int(state["step"]))
        bc1 = _f32(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = _f32(np.float32(1.0) - np.float32(b2) ** t)

        def upd(p, g, m, v):
            g = _scaled(g, scale)
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * (1 - b2) * g)
            delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
            delta.add_(p.float() * weight_decay)
            if p.dtype == torch.float32:
                p.sub_(delta.mul_(lr))
            else:
                p.copy_(p.float().sub_(delta.mul_(lr)))

        tree_map(upd, params, grads, state["m"], state["v"])
        return params, state, {"grad_norm": gnorm}

    return Optimizer(init, update, "adamw")


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_norm: Optional[float] = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Factored second moments for >=2-D leaves; no first moment."""

    def init(params):
        def state_for(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if p.dim() >= 2:
                return {"vr": z(p.shape[:-1]),   # reduce cols
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        dev = tree_leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "v": tree_map(state_for, params)}

    @torch.no_grad()
    def update(grads, state, params):
        gnorm, scale = _clip_scale(grads, clip_norm)
        state["step"] += 1
        t = np.float32(int(state["step"]))
        beta = np.float32(1.0) - t ** np.float32(-decay)
        keep, take = float(beta), float(np.float32(1.0) - beta)

        def upd(p, g, s):
            g = _scaled(g, scale)
            g2 = g * g + eps
            if p.dim() >= 2:
                s["vr"].copy_(keep * s["vr"] + take * g2.mean(dim=-1))
                s["vc"].copy_(keep * s["vc"] + take * g2.mean(dim=-2))
                denom = torch.clamp_min(s["vr"].mean(dim=-1, keepdim=True),
                                        eps)
                vhat = (s["vr"][..., None] * s["vc"][..., None, :]) / \
                    denom[..., None]
            else:
                s["v"].copy_(keep * s["v"] + take * g2)
                vhat = s["v"]
            u = g / torch.sqrt(vhat + eps)
            # Adafactor update clipping (RMS of update <= 1)
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp_min(rms, 1.0)
            newp = p.float() - lr * u
            if weight_decay:
                newp -= lr * weight_decay * p.float()
            p.copy_(newp)

        tree_map(upd, params, grads, state["v"])
        return params, state, {"grad_norm": gnorm}

    return Optimizer(init, update, "adafactor")


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(name)

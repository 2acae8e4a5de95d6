"""AdamW, its cosine schedule and global-norm clipping (port of
``repro.optim.adamw``).

QAT trains the latent float32 weights on straight-through gradients.  The
state is a ``NamedTuple`` of trees shaped like the params (float32 moments)
and an int32 step, as the reference's, so one checkpoint holds params and
state alike.  Every scalar of the update -- the schedule, the clip factor,
the bias corrections -- is a float32 tensor, as the reference computes
them, never a Python double.

Weight decay follows the reference's rule: a leaf is decayed when its rank
*in the reference's layout* is at least 2.  The reference stacks each
repeated period of layers on a leading axis, so a norm gain of a period
layer, ``(d,)`` here, is ``(n_periods, d)`` there and is decayed, while the
final norm and a prefix layer's gains are not (``decay_mask``; ROADMAP
section 3 pins this as the reference's behaviour).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree
from repro_torch.core.constants import scalar

__all__ = [
    "AdamWConfig",
    "OptState",
    "init_state",
    "cosine_schedule",
    "global_norm",
    "decay_mask",
    "apply_updates",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    mu: Any  # first moment (a tree like params, float32)
    nu: Any  # second moment
    step: torch.Tensor  # int32 scalar


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded correctly, as the reference's: the CPU's
    vectorised ``torch.sqrt`` is one ulp low in about 0.7% of inputs, so
    there it is taken in float64 and rounded once (exact for a square
    root); CUDA's float32 ``sqrt`` is correctly rounded already."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def init_state(params) -> OptState:
    zeros = tree.unflatten(params, [torch.zeros_like(p, dtype=torch.float32)
                                    for p in tree.leaves(params)])
    nu = tree.unflatten(params, [torch.zeros_like(p) for p in tree.leaves(zeros)])
    step = torch.zeros((), dtype=torch.int32, device=tree.leaves(params)[0].device)
    return OptState(mu=zeros, nu=nu, step=step)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine down to ``min_lr_ratio *
    lr``, in float32 as the reference's jnp arithmetic: ``step / warmup``
    and ``cos(pi * t)`` in float32, each Python constant rounded to float32
    first."""
    dev = step.device

    def f(v: float) -> torch.Tensor:
        return scalar(v, torch.float32, dev)

    warmup = max(cfg.warmup_steps, 1)
    span = max(cfg.total_steps - cfg.warmup_steps, 1)
    warm = torch.minimum(step.to(torch.float32) / f(float(warmup)), f(1.0))
    t = (step - cfg.warmup_steps).to(torch.float32) / f(float(span))
    t = torch.minimum(torch.maximum(t, f(0.0)), f(1.0))
    cos = f(0.5) * (f(1.0) + torch.cos(f(torch.pi) * t))
    frac = f(cfg.min_lr_ratio) + f(1.0 - cfg.min_lr_ratio) * cos
    return f(cfg.lr) * warm * frac


def global_norm(grads, reduce=None) -> torch.Tensor:
    """``sqrt(sum_leaves(sum(g**2)))`` in float32: each leaf summed, then
    the leaf sums (the reference sums in XLA's order, so the two agree to
    a few float32 ulps, not bit for bit).  ``reduce`` maps the vector of
    leaf sums before they are added: where ``grads`` are one rank's shards,
    a sum over the ranks (``runtime.train_loop``)."""
    sums = torch.stack([torch.sum(torch.square(g.to(torch.float32))) for g in tree.leaves(grads)])
    if reduce is not None:
        sums = reduce(sums)
    return _sqrt(torch.sum(sums))


def decay_mask(params: dict, cfg: ArchConfig) -> dict:
    """1.0 for a leaf the reference decays, else 0.0: rank >= 2 in the
    reference's layout, where a period layer's leaves carry one more axis
    (its stack) than here; the prefix layers (``cfg.prefix_layers``) and
    the top-level leaves keep their rank.  An encoder stack is a period of
    one layer (``encoder.n_layers`` times), so each of its layers' leaves
    carries the extra axis too; its ``stub_proj`` and ``final_norm`` keep
    their rank."""
    def mark(node, extra: int):
        return tree.unflatten(node, [float(x.ndim + extra >= 2) for x in tree.leaves(node)])

    def stack(layers: list, n_prefix: int) -> list:
        return [mark(layer, 0 if i < n_prefix else 1) for i, layer in enumerate(layers)]

    def top(k, v):
        if k == "layers":
            return stack(v, len(cfg.prefix_layers))
        if k == "encoder":
            return {ek: stack(ev, 0) if ek == "layers" else mark(ev, 0) for ek, ev in v.items()}
        return mark(v, 0)

    return {k: top(k, v) for k, v in params.items()}


def apply_updates(params, grads, state: OptState, cfg: AdamWConfig,
                  mask=None, gnorm=None) -> Tuple[Any, OptState, dict]:
    """One AdamW step on the trees ``params`` and ``grads``.  ``mask`` is a
    tree of decay flags (``decay_mask`` for a model's params); without one
    every leaf of rank >= 2 is decayed.  ``gnorm``: the gradients' global
    norm where ``grads`` are one rank's shards of them (else
    ``global_norm(grads)``).  Returns (new_params, new_state, metrics
    ``{"grad_norm", "lr"}``); the inputs are not modified."""
    if mask is None:
        mask = tree.unflatten(params, [float(p.ndim >= 2) for p in tree.leaves(params)])
    gnorm = global_norm(grads) if gnorm is None else gnorm
    dev = gnorm.device

    def f(v: float) -> torch.Tensor:
        return scalar(v, torch.float32, dev)

    clip = torch.minimum(f(1.0), f(cfg.grad_clip) / (gnorm + f(1e-9)))
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    step_f = step.to(torch.float32)
    b1c = f(1.0) - torch.pow(f(cfg.b1), step_f)
    b2c = f(1.0) - torch.pow(f(cfg.b2), step_f)
    b1, b2, one_b1, one_b2 = f(cfg.b1), f(cfg.b2), f(1.0 - cfg.b1), f(1.0 - cfg.b2)
    eps = f(cfg.eps)

    new_p, new_m, new_v = [], [], []
    for p, g, m, v, dm in zip(tree.leaves(params), tree.leaves(grads), tree.leaves(state.mu),
                              tree.leaves(state.nu), tree.leaves(mask)):
        g = g.to(torch.float32) * clip
        m2 = b1 * m + one_b1 * g
        v2 = b2 * v + one_b2 * g * g
        mhat = m2 / b1c
        vhat = v2 / b2c
        p32 = p.to(torch.float32)
        delta = mhat / (_sqrt(vhat) + eps) + f(cfg.weight_decay * dm) * p32
        new_p.append((p32 - lr * delta).to(p.dtype))
        new_m.append(m2)
        new_v.append(v2)
    return (
        tree.unflatten(params, new_p),
        OptState(mu=tree.unflatten(params, new_m), nu=tree.unflatten(params, new_v), step=step),
        {"grad_norm": gnorm, "lr": lr},
    )

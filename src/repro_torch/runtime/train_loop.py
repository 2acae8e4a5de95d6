"""The QAT training step on one device (port of ``repro.runtime.train_loop``).

``make_train_step`` returns ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``: the loss's gradients by autograd through the
train-mode forward (``model_zoo.loss_fn``), then one AdamW update
(``optim.adamw``).  The step is functional: it returns new trees and
leaves its inputs as they were.

* **Microbatching**: ``accum_steps`` splits the batch along B into equal
  microbatches (rows past ``micro * accum`` are dropped, as the reference
  drops them) and sums their gradients from zero in float32, one backward
  at a time, so activation memory scales with the microbatch; gradients
  and metrics (``loss``, the MoE balance loss ``aux``, ``nll``) are then
  divided by ``accum``.
* **Remat**: ``TrainConfig.remat`` checkpoints each block, recomputed in
  the backward (``transformer.stack_apply``).

There is one device and no mesh: the reference's sharded step,
``prebinarize_params`` (packing the binarized weights before an FSDP
gather; ``QuantConfig.prebinarize_gather`` raises) and
``make_compressed_dp_step`` wait for the multi-device slice (ROADMAP
section 1, item 7.4).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree
from repro_torch.models import model_zoo as Z
from repro_torch.optim import adamw

__all__ = ["TrainConfig", "init_train_state", "value_and_grad", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    accum_steps: int = 1
    remat: bool = True
    aux_weight: float = 0.01


def init_train_state(seed: int, cfg: ArchConfig, device="cuda"):
    """Latent params (``model_zoo.init_params``) and a fresh AdamW state."""
    params = Z.init_params(seed, cfg, device=device)
    return params, adamw.init_state(params)


def value_and_grad(params: dict, batch: dict, cfg: ArchConfig, tcfg: TrainConfig):
    """(metrics, grads) of ``model_zoo.loss_fn`` at ``params``; the
    metrics detached, the grads a tree like ``params``."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    tracked = tree.unflatten(params, leaves)
    total, metrics = Z.loss_fn(tracked, batch, cfg, aux_weight=tcfg.aux_weight, remat=tcfg.remat)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return {k: v.detach() for k, v in metrics.items()}, tree.unflatten(params, grads)


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig, device="cuda"):
    """The train step for ``cfg`` on ``device``.  ``batch``: ``{"tokens":
    (B, S)}``, and ``"frontend"`` (B, P, d_input) for a model with one, as
    numpy or tensors (moved to ``device``; microbatches slice every leaf
    along B)."""
    accum = tcfg.accum_steps

    def step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        if accum == 1:
            metrics, grads = value_and_grad(params, batch, cfg, tcfg)
        else:
            micro = batch["tokens"].shape[0] // accum
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in tree.leaves(params)]
            metrics = None
            for i in range(accum):
                mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
                m, g = value_and_grad(params, mb, cfg, tcfg)
                grads = [a + b for a, b in zip(grads, tree.leaves(g))]
                metrics = m if metrics is None else {k: metrics[k] + m[k] for k in metrics}
            grads = tree.unflatten(params, [g / accum for g in grads])
            metrics = {k: v / accum for k, v in metrics.items()}
        params2, opt2, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, tcfg.optimizer, adamw.decay_mask(params, cfg))
        return params2, opt2, dict(metrics, **opt_metrics)

    return step

"""Carry params of the JAX reference across to the port, as numpy trees.

The caller turns the reference's params into numpy first (for example
``jax.tree.map(np.asarray, params)``), so this module imports no JAX.  The
reference stacks the repeated ``period`` of layers on a leading scan axis;
the port keeps one dict per layer, so the stack is cut apart in
``cfg.layer_kinds`` order (prefix layers first, then each period in turn).

Leaves are converted bit for bit: ``uint32`` packed words become ``int32``
tensors holding the same bits (rank-3 stacked experts ``(E, K/32, N)``
included), ``bfloat16`` arrays keep their bits, and everything else keeps
its dtype (the float32 MoE router and a frontend's ``stub_proj`` among
them).  deepseek-v3's ``mtp`` subtree (the multi-token-prediction head,
which serves only the training loss) crosses with a latent tree and is
dropped from a serving one: the port's serving params have none.  A
frontend's ``encoder`` subtree keeps ``stub_proj`` and
``final_norm``; its scanned encoder ``stack`` (a period of one global
layer, ``encoder.n_layers`` times) becomes its own ``layers`` list.  A
tree of the reference's gradients (or AdamW moments) crosses the same
way, every leaf landing where the port's ``init_params`` puts it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

__all__ = ["to_tensor", "from_reference"]


def to_tensor(a: Any, device="cuda") -> torch.Tensor:
    """One numpy leaf -> tensor with identical bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).to(device)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _leaves(node, fn):
    if isinstance(node, dict):
        return {k: _leaves(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_leaves(v, fn) for v in node]
    return fn(node)


def _unstack(stack: dict, n_periods: int, device) -> list:
    """A reference stack -> one param dict per layer, prefix layers first,
    then each period in turn."""
    layers = [_leaves(p, lambda a: to_tensor(a, device)) for p in stack["prefix"]]
    for i in range(n_periods):
        for stacked in stack["period"]:
            layers.append(_leaves(stacked, lambda a: to_tensor(np.asarray(a)[i], device)))
    return layers


def from_reference(tree: dict, cfg: ArchConfig, device="cuda") -> dict:
    """Reference params (``init_params`` latents or ``prepare_serving_params``
    output, as numpy) -> the port's ``{"embedding", "final_norm", "layers"}``
    (and ``"encoder"``)."""
    out = {k: to_tensor(v, device) for k, v in tree.items() if k not in ("stack", "mtp", "encoder")}
    out["layers"] = _unstack(tree["stack"], cfg.n_periods, device)
    if "mtp" in tree and "w" in tree["mtp"]["proj"]:  # a latent tree's head
        out["mtp"] = _leaves(tree["mtp"], lambda a: to_tensor(a, device))
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {k: _leaves(v, lambda a: to_tensor(a, device))
                          for k, v in enc.items() if k != "stack"}
        if "stack" in enc:
            out["encoder"]["layers"] = _unstack(enc["stack"], cfg.encoder.n_layers, device)
    return out

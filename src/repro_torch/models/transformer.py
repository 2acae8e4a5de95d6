"""Block assembly (port of ``repro.models.transformer``), in serve mode and
in train mode.

The reference scans one stacked ``period`` of params with ``lax.scan``;
here the stack is a Python loop over per-layer param dicts, in
``cfg.layer_kinds`` order (the prefix layers, then each period in turn).
Block kinds ``"g"`` (global attention) and ``"l"`` (sliding-window
attention), each with a dense FFN; ``"Md"`` (multi-head latent attention
with a dense FFN of ``d_ff``) and ``"Mm"`` (MLA with the mixture of
experts); ``"r"`` (the RG-LRU recurrence with a dense FFN) and ``"s"`` (a
Mamba-2 SSD mixer alone: norm and mixer, no FFN).  Pre-norm residual
blocks (RMSNorm).  A recurrent layer's cache is its state, with no rows
axis (``models/ssm.py``).  A decoder block built with ``cross=True`` adds
cross-attention (``ln_cross``, ``cross_attn``) onto an encoder's output
between its mixer and its FFN; an encoder stack runs without caches.

Train mode (QAT) runs the stack without caches, every block kind and
cross-attention onto an encoder's output; with ``remat`` each block is
checkpointed (``torch.utils.checkpoint``, recomputed in the backward), as
the reference checkpoints its scanned period body.  Recomputing changes
no value.  Each block returns its auxiliary loss beside its output (an
``"Mm"`` block's load-balance loss, else 0), through the checkpoint, and
the stack sums them in float32 in layer order, as the reference's prefix
loop and period scan do.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

__all__ = ["init_block", "init_block_cache", "block_apply", "stack_apply"]

RECURRENT_KINDS = ("r", "s")
KINDS = ("g", "l") + A.MLA_KINDS + RECURRENT_KINDS


def init_block(gen: torch.Generator, cfg: ArchConfig, kind: str, site=lambda p: p,
               cross: bool = False) -> dict:
    """One block's latent params; an ``"Mm"`` block's expert sites pass
    through ``site`` as they are drawn (``moe.init_moe``); ``cross`` adds
    cross-attention to an attention block."""
    if kind not in KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet (only {KINDS})")
    d = cfg.d_model
    zeros = dict(dtype=torch.float32, device=gen.device)
    p = {"ln1": torch.zeros((d,), **zeros)}
    if kind == "s":
        p["ssd"] = S.init_ssd(gen, cfg)
        return p  # a mamba2 block is norm + mixer only
    if kind == "r":
        p["rglru"] = S.init_rglru(gen, cfg)
    else:
        p["attn"] = A.init_mla(gen, cfg) if kind in A.MLA_KINDS else A.init_attention(gen, cfg)
    if cross:
        p["ln_cross"] = torch.zeros((d,), **zeros)
        p["cross_attn"] = A.init_attention(gen, cfg)
    p["ln2"] = torch.zeros((d,), **zeros)
    if kind == "Mm":
        p["moe"] = M.init_moe(gen, cfg, site)
    else:
        p["ffn"] = L.init_ffn(gen, cfg.ffn_type, d, cfg.d_ff)
    return p


def init_block_cache(batch: int, max_len: int, cfg: ArchConfig, kind: str, device="cuda") -> dict:
    """One layer's cache: a recurrent layer's state, else its KV or latent
    cache of ``A.cache_rows`` rows."""
    if kind == "r":
        return S.init_rglru_state(batch, cfg, device=device)
    if kind == "s":
        return S.init_ssd_state(batch, cfg, device=device)
    return A.init_kv_cache(batch, max_len, cfg, kind, device=device)


def block_apply(p: dict, x, cfg: ArchConfig, kind: str, positions, cache: Optional[dict],
                encoder_out=None, mode: str = "serve"):
    """Pre-norm residual block.  Returns (x, cache) (cache updated in place).

    A block with ``cross_attn`` attends to ``encoder_out`` (B, T, D) when it
    is given (and skips cross-attention when it is not): keys and values
    projected from all T rows, non-causal.  ``mode="train"``: no cache;
    returns (x, aux), aux the block's float32 auxiliary loss (an MoE
    block's load balance, else 0)."""
    train = mode == "train"
    aux = torch.zeros((), dtype=torch.float32, device=x.device) if train else None
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "s":
        mix, cache = S.ssd_mixer(p["ssd"], h, cfg, cache, mode=mode)
        return x + mix, (aux if train else cache)
    if kind == "r":
        mix, cache = S.rglru_mixer(p["rglru"], h, cfg, cache, mode=mode)
    elif kind in A.MLA_KINDS:
        mix, cache = A.mla_attention(p["attn"], h, cfg, positions, cache, mode=mode)
    else:
        mix, cache = A.attention(p["attn"], h, cfg, kind, positions, cache, mode=mode)
    x = x + mix
    if "cross_attn" in p and encoder_out is not None:
        h = L.rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        rows = (*encoder_out.shape[:-1], cfg.n_kv_heads, cfg.d_head)
        ck = L.qlinear(p["cross_attn"]["k"], encoder_out, cfg.quant, mode=mode,
                       name="cross_attn.k").reshape(rows)
        cv = L.qlinear(p["cross_attn"]["v"], encoder_out, cfg.quant, mode=mode,
                       name="cross_attn.v").reshape(rows)
        mix, _ = A.attention(p["cross_attn"], h, cfg, "g", positions, None,
                             kv_override=(ck, cv), causal=False, mode=mode)
        x = x + mix
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if kind == "Mm":
        out = M.moe_ffn(p["moe"], h, cfg, mode=mode)
        if train:
            out, aux = out
    else:
        out = L.ffn(p["ffn"], h, cfg.ffn_type, cfg.quant, mode=mode)
    return x + out, (aux if train else cache)


def stack_apply(layers: List[dict], x, cfg: ArchConfig, positions,
                caches: Optional[List[dict]] = None, encoder_out=None,
                mode: str = "serve", remat: bool = False):
    """Apply every layer in order; returns (x, caches).  ``caches=None``
    runs the stack stateless (an encoder).  ``mode="train"`` runs without
    caches (cross-attending to ``encoder_out`` where it is given), each
    block checkpointed when ``remat`` is set, and returns (x, aux), aux
    the blocks' auxiliary losses summed in float32 from 0 in layer
    order."""
    if mode == "train":
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p, kind in zip(layers, cfg.layer_kinds):
            def block(x, enc, p=p, kind=kind):
                return block_apply(p, x, cfg, kind, positions, None, enc, mode=mode)

            x, block_aux = (torch.utils.checkpoint.checkpoint(block, x, encoder_out, use_reentrant=False)
                            if remat else block(x, encoder_out))
            aux = aux + block_aux
        return x, aux
    for i, (p, kind) in enumerate(zip(layers, cfg.layer_kinds)):
        x, _ = block_apply(p, x, cfg, kind, positions, None if caches is None else caches[i],
                           encoder_out)
    return x, caches

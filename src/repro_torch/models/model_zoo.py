"""Public model API of the port (counterpart of ``repro.models.model_zoo``),
serving subset for dense GQA decoders -- global (``"g"``) and
sliding-window (``"l"``) layers, as granite-8b, mistral-nemo-12b, qwen3-32b
and gemma3-27b have them --, bidirectional encoders (bit-bert-base:
learned positions, non-causal prefill), the deepseek family (MLA layers
``"Md"`` / ``"Mm"``, the latter with a mixture of experts) and the
recurrent families (RG-LRU layers ``"r"`` beside local attention in
recurrentgemma-2b, SSD layers ``"s"`` in mamba2-130m) and the stub
frontends (``cfg.encoder``): internvl2-2b's projected patch embeddings over
the first positions of the prompt, and whisper-tiny's non-causal encoder
over projected frame embeddings, which every decoder layer cross-attends
to.

Params are plain dicts: ``{"embedding", "final_norm", "layers": [block,
...]}``, plus ``"unembedding"`` when the embeddings are untied and
``"pos_embedding"`` ``(max_seq, d)`` for learned positions, with one block
per layer in ``cfg.layer_kinds`` order (the reference's scanned ``period``
stack, unstacked).  An MoE block's routed experts are rank-3 ``(E, K, N)``
linears, packed along K; its router stays float32 (``{"w"}``), as the
reference keeps it; a recurrent block's float leaves (``conv_w``,
``A_log``, ``D``, ``dt_bias``, ``norm_g``, ``lambda_p``) stay float32.
deepseek-v3's multi-token-prediction head (``"mtp": {"proj": {"w"}}``, a
``(2 d, d)`` linear) serves only the training loss: latent params carry
it, serving params none.  A model with a frontend has
``"encoder": {"stub_proj": {"w"}, ...}``, the stub projection kept float32,
plus ``"layers"`` (the encoder's blocks) and ``"final_norm"`` when it has
an encoder stack; then every decoder block carries ``ln_cross`` and
``cross_attn``.  With quantization off (``FLOAT_QUANT``) every linear is
``{"w"}`` in bf16.  Caches are ``{"layers": [cache, ...]}``, one per layer: an int8 (or bf16) KV cache, an MLA layer's latent
cache (``ckv``, ``k_rope``), or a recurrent layer's state (``models/ssm.py``:
``h`` / ``ssm`` and ``conv``, no rows axis); a ``"l"`` layer's cache holds
``min(max_len, window_size)`` rows (its ring buffer), every other
attention layer's ``max_len`` (``cache_rows``).  Every layer's cursor
``pos`` is absolute, so a decode step reads its positions from layer 0's,
whatever its kind.  A model with an encoder stack adds the bf16
``"encoder_out"`` leaf ``(batch, n_positions, d_model)``: a prefill with a
frontend stores the encoder's output there, and every decode step projects
its cross-attention keys and values from it.  Where ``"attn.qk"`` engages
bitwise attention, a GQA layer's ``k`` holds packed 1-bit rows (int32,
``ceil(d_head/32)`` words).

Entry points:

* ``init_params(seed, cfg)``           -- latent float32 params (on
  ``device="meta"``, a shape-only tree: ``prepare_serving_params`` and
  ``init_cache`` take it there too)
* ``prepare_serving_params(params)``   -- binarize, bit-pack, colsums
* ``init_serving_params(seed, cfg)``   -- the two above one layer at a time,
  so a full-width model never holds every latent weight at once
* ``init_cache`` / ``init_slot_cache`` / ``cache_insert`` / ``cache_reset``
* ``cache_rows`` / ``cache_geometry`` -- each layer's rows for a
  ``max_len`` (None for a recurrent layer's state), and the ``(batch,
  rows)`` a cache holds
* ``cache_copy`` / ``caches_equal`` -- a snapshot of a cache, and bitwise
  equality of two
* ``prefill`` (exact length, with an optional ``frontend``; or
  right-padded with ``length=``) / ``decode_step``, under the autotune phases ``"prefill"`` / ``"decode"``
  (``core/dispatch.py``)
* ``forward_logits`` / ``loss_fn`` -- the full-sequence forward on latent
  params in train mode (QAT) and the training loss: next-token for a
  causal model, the denoising copy (predict each input token) for an
  encoder such as bit-bert, plus the MoE layers' load-balance loss and
  deepseek-v3's depth-1 multi-token prediction.  Every block kind trains,
  and so do the frontends: a patch stub's projected rows spliced over the
  first positions, an encoder stack run in train mode on the frames and
  cross-attended to by every decoder block.  ``cfg.logits_dtype="bf16"``
  takes the loss's logits and ``log_softmax`` in bf16

Caches are updated IN PLACE: ``prefill``, ``decode_step``, ``cache_insert``
and ``cache_reset`` return the dict they were given, mutated.  Entry points
that create tensors take ``device="cuda"`` unless the caller asks for the
CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import dispatch
from repro_torch.core.constants import scalar
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

__all__ = [
    "init_params",
    "prepare_serving_params",
    "init_serving_params",
    "check_max_len",
    "cache_rows",
    "cache_geometry",
    "init_cache",
    "init_slot_cache",
    "cache_insert",
    "cache_reset",
    "cache_copy",
    "caches_equal",
    "prefill",
    "decode_step",
    "forward_logits",
    "loss_fn",
]


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on ``meta``: shapes and dtypes, no
    values (the counterpart of the reference's ``jax.eval_shape``)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _generator(seed: int, device) -> torch.Generator:
    if torch.device(device).type == "meta":
        return _MetaGenerator()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


#: top-level float tables, kept full precision and cast to bf16 for serving
_TABLES = ("embedding", "unembedding", "pos_embedding")


def check_max_len(cfg: ArchConfig, max_len: int) -> None:
    """Learned positions index a ``(max_seq, d)`` table, so no cache may hold
    more than ``cfg.max_seq`` positions: past it the reference's gather
    clamps, and an index on the card faults."""
    if cfg.pos_embedding == "learned" and max_len > cfg.max_seq:
        raise ValueError(
            f"max_len {max_len} exceeds {cfg.name}'s max_seq {cfg.max_seq} "
            "(learned positions)"
        )


def _init_top(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Embedding, untied unembedding and learned positions (std 0.02 each,
    drawn in that order) and the final norm gain."""
    def table(rows: int) -> torch.Tensor:
        return torch.randn((rows, cfg.d_model), generator=gen, device=gen.device) * 0.02

    top = {
        "embedding": table(cfg.vocab_size),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=gen.device),
    }
    if not cfg.tie_embeddings:
        top["unembedding"] = table(cfg.vocab_size)
    if cfg.pos_embedding == "learned":
        top["pos_embedding"] = table(cfg.max_seq)
    return top


def _serving_top(params: dict) -> dict:
    """The top-level leaves for serving: tables in bf16, the rest as they
    are, without the training-only MTP head."""
    return {
        k: v.to(torch.bfloat16) if k in _TABLES else v
        for k, v in params.items()
        if k not in ("layers", "encoder", "mtp")
    }


def _has_encoder_stack(cfg: ArchConfig) -> bool:
    return cfg.encoder is not None and cfg.encoder.n_layers > 0


def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    """The encoder stack's own config: ``encoder.n_layers`` global layers,
    non-causal, sinusoidal positions added at its input."""
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-encoder",
        n_layers=cfg.encoder.n_layers,
        prefix_layers=(),
        pattern_period=("g",),
        causal=False,
        pos_embedding="sinusoidal",
        encoder=None,
        mtp_depth=0,
    )


def _init_encoder(gen: torch.Generator, cfg: ArchConfig, block=lambda p: p) -> dict:
    """The frontend's latent params: the stub projection and, with an
    encoder stack, its blocks (each passed through ``block`` as it is
    drawn) and final norm."""
    enc = {"stub_proj": L.init_linear(gen, cfg.encoder.d_input or cfg.d_model, cfg.d_model)}
    if _has_encoder_stack(cfg):
        enc_cfg = _encoder_cfg(cfg)
        enc["layers"] = [block(T.init_block(gen, enc_cfg, kind)) for kind in enc_cfg.layer_kinds]
        enc["final_norm"] = torch.zeros((cfg.d_model,), dtype=torch.float32, device=gen.device)
    return enc


def init_params(seed: int, cfg: ArchConfig, device="cuda") -> dict:
    """Latent float32 params from ``torch.Generator(device).manual_seed(seed)``;
    on ``device="meta"`` the tree's shapes and dtypes alone, at any width."""
    gen = _generator(seed, device)
    p = _init_top(gen, cfg)
    cross = _has_encoder_stack(cfg)
    p["layers"] = [T.init_block(gen, cfg, kind, cross=cross) for kind in cfg.layer_kinds]
    if cfg.encoder is not None:
        p["encoder"] = _init_encoder(gen, cfg)
    if cfg.mtp_depth:
        p["mtp"] = {"proj": L.init_linear(gen, 2 * cfg.d_model, cfg.d_model)}
    return p


#: linears kept full precision in serving (the reference's ``_FP_LEAF_PATHS``)
_FP_LINEARS = ("router", "stub_proj")


def _pack_site(node: dict, cfg: ArchConfig) -> dict:
    """One latent linear ``{"w"}``: rank 2 packs as a linear, rank 3 as
    stacked experts."""
    if node["w"].ndim == 3:
        return M.pack_experts_for_serving(node, cfg.quant)
    return L.pack_linear_for_serving(node, cfg.quant)


def _pack_tree(node, cfg: ArchConfig, path=()):
    if isinstance(node, dict):
        if set(node) == {"w"}:
            if any(k in path for k in _FP_LINEARS):
                return {"w": node["w"].to(torch.float32)}
            return _pack_site(node, cfg)
        return {k: _pack_tree(v, cfg, path + (k,)) for k, v in node.items()}
    if isinstance(node, list):
        return [_pack_tree(v, cfg, path) for v in node]
    return node


def prepare_serving_params(params: dict, cfg: ArchConfig) -> dict:
    """Binarize and bit-pack every linear (stacked experts per expert);
    the embedding, unembedding and position tables go to bf16, norm gains,
    the MoE router and a frontend's stub projection stay float32, as in
    the reference.  The MTP head is left out (it serves only training)."""
    out = _serving_top(params)
    out["layers"] = _pack_tree(params["layers"], cfg)
    if "encoder" in params:
        out["encoder"] = _pack_tree(params["encoder"], cfg)
    return out


def init_serving_params(seed: int, cfg: ArchConfig, device="cuda") -> dict:
    """Serving params built one layer at a time: each layer's latent
    weights are drawn, packed at once and freed, so the peak holds one
    layer of float32 latents (about 0.9 GB at granite-8b width, 1.65 GB at
    gemma3-27b's) besides the packed model.  An MoE layer's routed experts
    are packed one site as soon as it is drawn (a (64, 2048, 1408) float32
    site is 0.74 GB at deepseek-v2-lite-16b's width)."""
    gen = _generator(seed, device)
    out = _serving_top(_init_top(gen, cfg))
    out["layers"] = []
    cross = _has_encoder_stack(cfg)
    for kind in cfg.layer_kinds:
        block = T.init_block(gen, cfg, kind, site=lambda p: _pack_site(p, cfg), cross=cross)
        out["layers"].append(_pack_tree(block, cfg))
    if cfg.encoder is not None:
        out["encoder"] = _init_encoder(gen, cfg, lambda b: _pack_tree(b, cfg))
    return out


def cache_rows(max_len: int, cfg: ArchConfig) -> list:
    """Rows of each layer's cache, in layer order, for ``max_len``
    positions; None for a recurrent layer, whose state has no rows.  A
    model with an encoder stack adds, last, its ``encoder_out`` leaf's
    ``n_positions``."""
    rows = [None if kind in T.RECURRENT_KINDS else A.cache_rows(max_len, cfg, kind)
            for kind in cfg.layer_kinds]
    return rows + ([cfg.encoder.n_positions] if _has_encoder_stack(cfg) else [])


def _layer_geometry(layer: dict) -> tuple:
    for rows in ("ckv", "k"):
        if rows in layer:
            return tuple(layer[rows].shape[:2])
    return (layer["pos"].shape[0], None)


def cache_geometry(cache: dict) -> list:
    """``(batch, rows)`` of each layer's cache, in layer order, read from
    the layer's own rows: ``ckv`` for an MLA layer, ``k`` for a GQA one; a
    recurrent layer's state has no rows, ``(batch, None)``.  Last, where
    the cache has one, ``encoder_out``'s ``(batch, n_positions)``."""
    enc = [tuple(cache["encoder_out"].shape[:2])] if "encoder_out" in cache else []
    return [_layer_geometry(layer) for layer in cache["layers"]] + enc


def init_cache(batch: int, max_len: int, cfg: ArchConfig, device="cuda") -> dict:
    check_max_len(cfg, max_len)
    cache = {
        "layers": [
            T.init_block_cache(batch, max_len, cfg, kind, device=device)
            for kind in cfg.layer_kinds
        ]
    }
    if _has_encoder_stack(cfg):
        cache["encoder_out"] = torch.zeros(
            (batch, cfg.encoder.n_positions, cfg.d_model), dtype=torch.bfloat16, device=device
        )
    return cache


def init_slot_cache(max_len: int, cfg: ArchConfig, device="cuda") -> dict:
    """A batch-1 cache for ``cache_insert``; shares ``max_len`` with the
    packed cache so every leaf lines up except the batch axis (ring layers
    included: their rows follow from ``max_len``)."""
    return init_cache(1, max_len, cfg, device=device)


def cache_insert(cache: dict, slot_cache: dict, slot: int) -> dict:
    """Copy a batch-1 ``slot_cache`` into row ``slot`` of a packed cache, in
    place -- including the per-row cursor and calibration affines, a
    recurrent layer's whole state, and the row's ``encoder_out``."""
    for dst, src in zip(cache["layers"], slot_cache["layers"]):
        idx = torch.tensor([slot], device=dst["pos"].device)
        for key, leaf in dst.items():
            leaf.index_copy_(0, idx, src[key].to(leaf.dtype))
    if "encoder_out" in cache:
        leaf = cache["encoder_out"]
        leaf.index_copy_(0, torch.tensor([slot], device=leaf.device), slot_cache["encoder_out"].to(leaf.dtype))
    return cache


def cache_reset(cache: dict, slot: int, cfg: ArchConfig, max_len: int) -> dict:
    """Reset row ``slot`` (cursor 0, identity affines, zero mantissas,
    recurrent state and ``encoder_out``)."""
    device = cache["layers"][0]["pos"].device
    return cache_insert(cache, init_slot_cache(max_len, cfg, device=device), slot)


def cache_copy(cache: dict) -> dict:
    """A copy of every leaf of ``cache``, at new addresses."""
    out = {"layers": [{k: v.clone() for k, v in layer.items()} for layer in cache["layers"]]}
    if "encoder_out" in cache:
        out["encoder_out"] = cache["encoder_out"].clone()
    return out


def _leaves_equal(x: dict, y: dict) -> bool:
    return x.keys() == y.keys() and all(
        x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]) for k in x
    )


def caches_equal(a: dict, b: dict) -> bool:
    """Whether two caches hold the same leaves, bit for bit and of the same
    dtypes."""
    top = {k: v for k, v in a.items() if k != "layers"}
    return (
        len(a["layers"]) == len(b["layers"])
        and _leaves_equal(top, {k: v for k, v in b.items() if k != "layers"})
        and all(_leaves_equal(x, y) for x, y in zip(a["layers"], b["layers"]))
    )


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """float32 ``[sin, cos]`` position rows (..., d) of an encoder's input,
    frequencies ``exp(-i * log(10000) / (d/2 - 1))``."""
    half = d // 2
    dev = positions.device
    step = torch.log(scalar(10000.0, torch.float32, dev)) / (half - 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=dev) * step)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed_inputs(params: dict, tokens: torch.Tensor, cfg: ArchConfig, positions,
                  frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled bf16 token embedding plus, for learned positions, the bf16
    position rows added in bf16 (``positions`` < ``cfg.max_seq``: the
    caches are sized so).  A patch frontend is projected in bf16 and its
    rows replace the first positions."""
    x = L.embed(params, tokens, cfg.d_model)
    if cfg.pos_embedding == "learned":
        x = x + params["pos_embedding"][positions].to(x.dtype)
    if frontend is not None and cfg.encoder.kind == "patch_stub":
        patches = L.float_linear(params["encoder"]["stub_proj"], frontend.to(x.dtype))
        x = torch.cat([patches.to(x.dtype), x[:, patches.shape[1]:]], dim=1)
    return x.to(torch.bfloat16)


def _run_encoder(params: dict, frontend: torch.Tensor, cfg: ArchConfig, mode: str = "serve",
                 remat: bool = False) -> torch.Tensor:
    """The encoder over stub frame embeddings, in the frontend's dtype:
    the float projection (in either mode, as the reference keeps it),
    sinusoidal positions, the non-causal stack without caches in ``mode``
    (train mode: latent weights, each layer checkpointed under ``remat``),
    final norm.  Returns (B, T, d_model)."""
    enc = params["encoder"]
    x = L.float_linear(enc["stub_proj"], frontend)
    b, t = x.shape[:2]
    pos = torch.arange(t, device=x.device).broadcast_to(b, t)
    x = x + _sinusoidal(pos, cfg.d_model).to(x.dtype)
    x, _ = T.stack_apply(enc["layers"], x, _encoder_cfg(cfg), pos, mode=mode, remat=remat)
    return L.rmsnorm(enc["final_norm"], x, cfg.norm_eps)


def _check_frontend(cfg: ArchConfig, tokens: torch.Tensor, frontend: torch.Tensor,
                    exact: bool = True) -> None:
    """A frontend's shape against the model's: an encoder stack's frames
    are ``(B, n_positions, d_input)`` (any number of frames in training,
    ``exact=False``, as the reference's encoder takes them), a patch
    stub's at most the prompt's length."""
    enc = cfg.encoder
    if enc is None:
        raise ValueError(f"{cfg.name} has no frontend")
    b, s = tokens.shape
    if _has_encoder_stack(cfg):
        want = (b, enc.n_positions if exact else frontend.shape[1], enc.d_input or cfg.d_model)
        if tuple(frontend.shape) != want:
            raise ValueError(f"frontend of shape {tuple(frontend.shape)}, {cfg.name} takes {want}")
    if enc.kind == "patch_stub" and frontend.shape[1] > s:
        raise ValueError(f"a prompt of {s} tokens is shorter than its {frontend.shape[1]} patch "
                         "embeddings, which replace the prompt's first positions")


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig, cache: dict,
            frontend: Optional[torch.Tensor] = None,
            length: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
    """Process whole prompts from an empty cache.

    tokens: (B, S) int.  ``frontend``: stub embeddings of a model with an
    encoder config -- patches (B, P <= S, d_input) spliced over the first P
    positions, or frames (B, n_positions, d_input or d_model) through the
    encoder, whose output the decoder cross-attends to and the cache keeps
    (as bf16) for the decode steps.  The prefill's cross-attention reads
    the encoder's output in the frontend's own dtype, as the reference
    does.  Returns (last-position logits (B, V) float32, cache).

    ``length``: optional (B,) prompt lengths of a RIGHT-padded batch (a
    bucketed prefill): logits are taken at ``length - 1`` in each row, and
    every layer's cursor is rewound to ``length``, so decode overwrites the
    pad rows.  Pads sit at causally later positions, but this is exact only
    for float full-attention caches: an int8 cache's calibration sees the
    pads, a ring evicts real tokens once the padded length reaches its
    window, and a recurrent state integrates the pads.  Exact length
    (``length=None``) is the default and what the engine admits with.
    """
    with dispatch.tuning_phase("prefill"):
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).broadcast_to(b, s)
        encoder_out = None
        if frontend is not None:
            _check_frontend(cfg, tokens, frontend)
            if _has_encoder_stack(cfg):
                encoder_out = _run_encoder(params, frontend, cfg)
                cache["encoder_out"].copy_(encoder_out)
        x = _embed_inputs(params, tokens, cfg, positions, frontend)
        x, _ = T.stack_apply(params["layers"], x, cfg, positions, cache["layers"], encoder_out)
        if length is None:
            x_last = x[:, -1:]
        else:
            rows = torch.as_tensor(length, device=x.device).reshape(-1).to(torch.int64)
            x_last = x[torch.arange(b, device=x.device), rows - 1][:, None]
            _set_stack_pos(cache, rows)
        x = L.rmsnorm(params["final_norm"], x_last, cfg.norm_eps)
        return L.unembed(params, x, cfg.tie_embeddings)[:, 0], cache


def _set_stack_pos(cache: dict, rows: torch.Tensor) -> None:
    """Overwrite every layer's ``pos`` cursor with per-row values (B,), in
    place."""
    for layer in cache["layers"]:
        layer["pos"].copy_(rows.to(layer["pos"].dtype).broadcast_to(layer["pos"].shape))


def decode_step(params: dict, tokens: torch.Tensor, cfg: ArchConfig, cache: dict) -> Tuple[torch.Tensor, dict]:
    """One decode step.  tokens (B,) -> logits (B, V) float32 + cache.
    Cross-attention, where the model has it, reads the cache's
    ``encoder_out``: zeros until a prefill with a frontend fills it."""
    with dispatch.tuning_phase("decode"):
        b = tokens.shape[0]
        # a copy: the first layer advances its cursor in place
        positions = cache["layers"][0]["pos"].to(torch.int64, copy=True).reshape(b, 1)
        x = _embed_inputs(params, tokens[:, None], cfg, positions)
        x, _ = T.stack_apply(params["layers"], x, cfg, positions, cache["layers"],
                             cache.get("encoder_out"))
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return L.unembed(params, x, cfg.tie_embeddings)[:, 0], cache


# ---------------------------------------------------------------------------
# training (QAT)
# ---------------------------------------------------------------------------


def _forward_hidden(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                    frontend: Optional[torch.Tensor] = None, remat: bool = False):
    """Full-sequence train-mode forward on latent params to the final
    (normed) hidden states, bf16 (B, S, D), and the auxiliary loss (the
    MoE layers' load-balance losses summed in layer order, else 0).  A
    ``frontend`` is a patch stub's rows, spliced over the first positions
    (the token embeddings they cover get no gradient), or an encoder
    stack's frames, run in train mode and cross-attended to by every
    decoder block; a model with an encoder stack and no frontend skips
    cross-attention, as the reference does."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).broadcast_to(b, s)
    encoder_out = None
    if frontend is not None:
        _check_frontend(cfg, tokens, frontend, exact=False)
        if _has_encoder_stack(cfg):
            encoder_out = _run_encoder(params, frontend, cfg, "train", remat)
    x = _embed_inputs(params, tokens, cfg, positions, frontend)
    x, aux = T.stack_apply(params["layers"], x, cfg, positions, None, encoder_out, mode="train",
                           remat=remat)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def forward_logits(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                   frontend: Optional[torch.Tensor] = None, remat: bool = False):
    """Full-sequence train-mode forward.  Returns (logits (B, S, V)
    float32, aux)."""
    x, aux = _forward_hidden(params, tokens, cfg, frontend, remat)
    return L.unembed(params, x, cfg.tie_embeddings), aux


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood of ``targets`` under
    ``logits``, in their dtype (``log_softmax`` as the reference's)."""
    return -L.log_softmax(logits).gather(-1, targets[..., None].to(torch.int64))[..., 0]


def _mtp_loss(params: dict, hidden: torch.Tensor, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """deepseek-v3's depth-1 multi-token prediction: token ``t + 2`` from
    ``[h_t ; emb(t + 1)]`` in float32, through the train-mode ``mtp.proj``
    and the shared unembedding; its mean NLL, float32."""
    h_t = hidden[:, :-2].to(torch.float32)
    emb_next = L.embed(params, tokens[:, 1:-1], cfg.d_model).to(torch.float32)
    h_mtp = L.qlinear(params["mtp"]["proj"], torch.cat([h_t, emb_next], dim=-1), cfg.quant, mode="train")
    logits = L.unembed(params, h_mtp, cfg.tie_embeddings)
    return _nll(logits, tokens[:, 2:]).mean()


def loss_fn(params: dict, batch: dict, cfg: ArchConfig, aux_weight: float = 0.01,
            remat: bool = False):
    """The training loss and its metrics ``{"loss", "aux", "nll"}``.

    batch: ``{"tokens": (B, S) int}``, and ``"frontend"`` for a model with
    one (``_forward_hidden``).  A causal model predicts token ``t + 1``
    from the positions up to ``t``; a non-causal one (BERT family) the
    input token at every position (the reference's denoising copy).  The
    logits and their ``log_softmax`` are in ``cfg.logits_dtype`` (float32,
    or bf16: a bf16 product and every step rounded), the mean NLL float32.
    A causal model with an MTP head (``cfg.mtp_depth`` and
    ``params["mtp"]``) adds 0.3 times its mean NLL into ``loss``, as the
    reference reports it; the total adds ``aux_weight * aux``."""
    tokens = batch["tokens"]
    hidden, aux = _forward_hidden(params, tokens, cfg, batch.get("frontend"), remat)
    logits = L.unembed(params, hidden, cfg.tie_embeddings,
                       torch.bfloat16 if cfg.logits_dtype == "bf16" else torch.float32)
    if cfg.causal:
        pred, tgt = logits[:, :-1], tokens[:, 1:]
    else:
        pred, tgt = logits, tokens
    loss = _nll(pred, tgt).to(torch.float32).mean()
    if cfg.mtp_depth and "mtp" in params and cfg.causal:
        loss = loss + 0.3 * _mtp_loss(params, hidden, tokens, cfg)
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux, "nll": loss}

"""Architecture / quantization config schema (port of ``repro.configs.base``).

A copy, not an import: the port never imports the JAX package.  Field names
and defaults match the reference so one config means the same model on
both sides.  The port serves dense GQA decoders and encoders (block kinds
``"g"``, global attention, and ``"l"``, sliding-window attention over
``window_size`` positions), the deepseek family (``"Md"``: multi-head
latent attention with a dense FFN, ``"Mm"``: MLA with a mixture of
experts; ``MLAConfig``, ``MoEConfig``) and the recurrent families
(``"r"``: an RG-LRU block with a dense FFN, as recurrentgemma has it;
``"s"``: a Mamba-2 SSD mixer alone, geometry in ``SSMConfig``).  A model
with no attention layer may set ``pos_embedding="none"`` and
``quant.quantize_attention=False`` (mamba2); attention layers still refuse
a float cache.  ``EncoderConfig`` describes a stub frontend: precomputed
patch embeddings spliced over the first positions (internvl2), or frame
embeddings under a transformer encoder that the decoder cross-attends to
(whisper).
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Dict, Optional, Tuple

__all__ = [
    "QuantConfig",
    "FLOAT_QUANT",
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "EncoderConfig",
    "ArchConfig",
    "InputShape",
    "LM_SHAPES",
    "SHAPES_BY_NAME",
    "register",
    "get_config",
    "list_configs",
]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """BETA quantization spec: which QMMs are quantized and how.

    ``backend`` names an integer-MM backend of the PORT's registry
    (``repro_torch.core.backend_registry``).  The names are the reference's,
    so one string selects the same path on both sides:

    * ``"mxu"``    -- plain PyTorch integer product (exact), the default;
    * ``"popcount"`` -- plain PyTorch bit-serial AND-popcount over packed
      planes of the raw unsigned mantissas;
    * ``"pallas"`` -- the staged hand-written kernels: ``popcount_qmm`` (K3)
      at W1A1, ``binary_qmm`` (K1) at W1A2..A8, ``bitserial_qmm`` (K4) for
      multi-bit act x act, each returning the integer product, and the
      affine epilogue after it;
    * ``"fused"``  -- the hand-written ``fused_qmm`` kernel (K2): bit-serial
      AND-popcount core plus the affine epilogue in one launch;
    * ``"auto"``   -- measured dispatch (``repro_torch.core.dispatch``): the
      fastest eligible backend for each shape, timed once and cached.

    The scores-only names ``"binary"`` (the hand-written AND-popcount
    scores kernel, its core picked by ``"auto"`` over the scores family)
    and ``"float"`` (the float-dot core) engage bitwise attention where a
    site override names them: ``(("attn.qk", "binary"),)`` binarizes Q and K
    and packs the K cache, ``(("attn.qk_latent", "binary"),)`` runs MLA's
    absorbed decode scores bitwise.
    """

    enabled: bool = True
    weight_bits: int = 1
    act_bits: int = 8
    attn_act_bits: int = 8
    quantize_attention: bool = True
    kv_cache_bits: int = 8
    backend: str = "mxu"
    # ((fnmatch pattern over the site name, backend), ...): first match wins.
    backend_overrides: Tuple[Tuple[str, str], ...] = ()
    # multi-device QAT: binarize and pack each QMM weight on its shard
    # before the gather (runtime/train_loop.py::prebinarize_params); train
    # mode then takes the sites' weights as they come
    prebinarize_gather: bool = False

    @staticmethod
    def known_backends() -> Tuple[str, ...]:
        from repro_torch.core import backend_registry

        return ("auto",) + backend_registry.backend_names()

    def __post_init__(self):
        known = self.known_backends()
        if self.backend not in known:
            raise ValueError(f"unknown backend {self.backend!r}; valid: {known}")
        for pattern, b in self.backend_overrides:
            if b not in known:
                raise ValueError(
                    f"backend_overrides[{pattern!r}] names unknown backend "
                    f"{b!r}; valid: {known}"
                )

    @property
    def mode_name(self) -> str:
        return f"W{self.weight_bits}A{self.act_bits}"

    def backend_for(self, layer_name: str = "") -> str:
        """Backend for a named site ("ffn.up", "attn.o", ...)."""
        if layer_name:
            for pattern, b in self.backend_overrides:
                if fnmatch.fnmatchcase(layer_name, pattern):
                    return b
        return self.backend


#: Full-precision serving: bf16 weights, float products, bf16 KV caches.
FLOAT_QUANT = QuantConfig(enabled=False)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    n_shared: int
    top_k: int
    d_expert_ff: int
    d_shared_ff: int = 0  # defaults to d_expert_ff * n_shared
    capacity_factor: float = 1.25
    router_scoring: str = "softmax"  # "softmax" | "sigmoid" (deepseek-v3)
    route_scale: float = 1.0

    @property
    def shared_ff(self) -> int:
        return self.d_shared_ff or self.d_expert_ff * self.n_shared


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention geometry."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 -> direct q projection (v2-lite)
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD mixer geometry."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Stub frontend of the enc-dec (whisper) and VLM (internvl2) archs.

    The caller supplies precomputed frame or patch embeddings ``(batch,
    n_positions, d_input or d_model)``, projected in by one float linear
    (``stub_proj``); with ``n_layers`` a non-causal transformer encoder runs
    on top and the decoder cross-attends to its output.
    """

    kind: str  # "audio_stub" | "patch_stub"
    n_positions: int  # 1500 audio frames / vision patches per image
    n_layers: int = 0  # transformer layers on top of the stub (whisper: 4)
    d_input: int = 0  # stub embedding dim before projection (0 -> d_model)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    pattern_period: Tuple[str, ...] = ("g",)
    prefix_layers: Tuple[str, ...] = ()
    window_size: int = 0
    qk_norm: bool = False
    ffn_type: str = "silu_glu"  # "gelu" | "silu_glu" | "gelu_glu"
    rope_theta: float = 10000.0
    local_rope_theta: float = 0.0  # gemma3 uses a different theta locally
    pos_embedding: str = "rope"  # "rope" | "learned" | "sinusoidal" | "none"
    causal: bool = True
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    quant: QuantConfig = QuantConfig()
    # compute dtypes of the full-sequence attention scores and of the
    # training loss's logits: "f32" (default) or "bf16", as the reference's
    # variants set them through ``dataclasses.replace``
    attn_scores_dtype: str = "f32"
    logits_dtype: str = "f32"
    mtp_depth: int = 0  # deepseek-v3 multi-token prediction heads (training only)
    max_seq: int = 131072
    source: str = ""

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        for field in ("attn_scores_dtype", "logits_dtype"):
            if getattr(self, field) not in ("f32", "bf16"):
                raise ValueError(f"{self.name}: {field} {getattr(self, field)!r} is not 'f32' or 'bf16'")
        n_pattern = self.n_layers - len(self.prefix_layers)
        if n_pattern < 0 or (
            len(self.pattern_period) and n_pattern % len(self.pattern_period)
        ):
            raise ValueError(
                f"{self.name}: {self.n_layers} layers does not decompose into "
                f"prefix {self.prefix_layers} + k * period {self.pattern_period}"
            )

    @property
    def n_periods(self) -> int:
        return (self.n_layers - len(self.prefix_layers)) // len(self.pattern_period)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return self.prefix_layers + self.pattern_period * self.n_periods

    @property
    def is_sub_quadratic(self) -> bool:
        """True when no layer attends over the whole sequence (recurrent or
        bounded-window layers only)."""
        return all(k in ("l", "r", "s") for k in self.layer_kinds)

    @property
    def has_decoder(self) -> bool:
        return self.family != "encoder"

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for
        MODEL_FLOPS = 6*N*D accounting; the reference's arithmetic."""
        d, ff = self.d_model, self.d_ff
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds:
            if kind in ("g", "l"):
                attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
                attn += self.n_heads * self.d_head * d
                total += attn + self._ffn_params(ff)
            elif kind in ("Md", "Mm"):
                m = self.mla
                q = (
                    d * m.q_lora_rank
                    + m.q_lora_rank * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                    if m.q_lora_rank
                    else d * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                )
                kv = d * (m.kv_lora_rank + m.qk_rope_dim) + m.kv_lora_rank * self.n_heads * (
                    m.qk_nope_dim + m.v_head_dim
                )
                total += q + kv + self.n_heads * m.v_head_dim * d
                if kind == "Md":
                    total += self._ffn_params(ff)
                else:
                    e = self.moe
                    total += e.n_routed * self._ffn_params(e.d_expert_ff)
                    total += self._ffn_params(e.shared_ff)
                    total += d * e.n_routed  # router
            elif kind == "r":
                di = self.d_model  # RG-LRU width = d_model (recurrentgemma)
                total += 2 * d * di + di * d + 3 * di  # in / gate / out + gates
                total += self._ffn_params(ff)
            elif kind == "s":
                s = self.ssm
                di = s.d_inner(d)
                nh = s.n_heads(d)
                total += d * (2 * di + 2 * s.n_groups * s.d_state + nh)  # in_proj
                total += di * d  # out_proj
                total += di * s.d_conv + nh * 2  # conv + A, D
        return total

    def _ffn_params(self, ff: int) -> int:
        mult = 3 if self.ffn_type.endswith("glu") else 2
        return mult * self.d_model * ff

    def active_param_count(self) -> int:
        """Parameters a token uses (MoE: the routed top-k and the shared)."""
        total = self.param_count()
        if self.moe is None:
            return total
        e = self.moe
        n_moe_layers = sum(1 for k in self.layer_kinds if k == "Mm")
        return total - n_moe_layers * (e.n_routed - e.top_k) * self._ffn_params(e.d_expert_ff)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


#: The LM shape grid of the reference's dry-run sweep.
LM_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4096, 256, "train"),
    InputShape("prefill_32k", 32768, 32, "prefill"),
    InputShape("decode_32k", 32768, 128, "decode"),
    InputShape("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME: Dict[str, InputShape] = {s.name: s for s in LM_SHAPES}

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from repro_torch import configs as _pkg  # noqa: F401  (registers every config)

    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}") from None


def list_configs() -> Tuple[str, ...]:
    from repro_torch import configs as _pkg  # noqa: F401  (registers every config)

    return tuple(sorted(_REGISTRY))

"""The paper's own benchmark models: BiT / BinaryBERT / BiBERT (BERT-base).

[paper Table II benchmarks]  12L d_model=768 12H d_ff=3072 vocab=30522,
bidirectional encoder over learned positions (max_seq 512), gelu FFN,
untied unembedding; MNLI-m prompts of 128 tokens.  The activation
precision is the engine's knob: W1A1 (``bit-bert-base``), W1A2, W1A4,
W1A8.  Same values as ``repro/configs/bit_bert.py``.
"""

from repro_torch.configs.base import ArchConfig, QuantConfig, register


def _bert(name: str, act_bits: int) -> ArchConfig:
    return ArchConfig(
        name=name,
        family="encoder",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=30522,
        pattern_period=("g",),
        ffn_type="gelu",
        pos_embedding="learned",
        causal=False,
        quant=QuantConfig(act_bits=act_bits, attn_act_bits=act_bits, kv_cache_bits=8),
        max_seq=512,
        source="[paper Table II benchmarks]",
    )


CONFIG = register(_bert("bit-bert-base", 1))
CONFIG_W1A2 = register(_bert("bit-bert-base-a2", 2))
CONFIG_W1A4 = register(_bert("bit-bert-base-a4", 4))
CONFIG_W1A8 = register(_bert("bit-bert-base-a8", 8))

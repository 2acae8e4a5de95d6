"""gemma3-27b -- dense decoder with a 5:1 local:global attention interleave.

[hf:google/gemma-3-1b-pt; unverified]  62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144, qk-norm, sliding window 1024 on local layers,
rope theta 1M global / 10k local.  62 = 6*10 + 2 -> (l,l,l,l,l,g) x10 with
an (l,l) prefix.  Same values as ``repro/configs/gemma3_27b.py``, which is
a structural subset of the published model: no post-attention / post-FFN
norms and no query pre-attention scalar (scores scale by 1/sqrt(d_head)).
"""

from repro_torch.configs.base import ArchConfig, QuantConfig, register

CONFIG = register(
    ArchConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        d_head=128,
        d_ff=21504,
        vocab_size=262144,
        prefix_layers=("l", "l"),
        pattern_period=("l", "l", "l", "l", "l", "g"),
        window_size=1024,
        qk_norm=True,
        ffn_type="gelu_glu",
        rope_theta=1000000.0,
        local_rope_theta=10000.0,
        tie_embeddings=True,
        quant=QuantConfig(act_bits=8, attn_act_bits=8),
        max_seq=131072,
        source="[hf:google/gemma-3-1b-pt; unverified]",
    )
)

"""deepseek-v2-lite-16b -- MLA + 64-expert MoE (2 shared + 64 routed, top-6).

[arXiv:2405.04434; hf]  27L d_model=2048 16H d_ff(expert)=1408
vocab=102400.  First layer dense (d_ff 10944), the other 26 MoE.  MLA:
kv_lora 512, q projected directly (no q LoRA), qk_nope 128, qk_rope 64,
v_head 128.  Softmax router, top-6.  Same values as
``repro/configs/deepseek_v2_lite_16b.py``.
"""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, QuantConfig, register

CONFIG = register(
    ArchConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=10944,  # dense first layer
        vocab_size=102400,
        prefix_layers=("Md",),
        pattern_period=("Mm",),
        ffn_type="silu_glu",
        rope_theta=10000.0,
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=0,
            qk_nope_dim=128,
            qk_rope_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            n_routed=64,
            n_shared=2,
            top_k=6,
            d_expert_ff=1408,
            router_scoring="softmax",
        ),
        quant=QuantConfig(act_bits=8, attn_act_bits=8),
        max_seq=163840,
        source="[arXiv:2405.04434; hf]",
    )
)

"""deepseek-v3-671b -- MLA + 256-expert MoE (1 shared + 256 routed, top-8) + MTP.

[arXiv:2412.19437; hf]  61L d_model=7168 128H d_ff(expert)=2048
vocab=129280.  First 3 layers dense (d_ff 18432), the other 58 MoE.  MLA:
kv_lora 512, q_lora 1536, qk_nope 128, qk_rope 64, v_head 128.  Router:
sigmoid scores, top-8 of 256 routed, ``route_scale`` 2.5, + 1 shared
expert.  ``mtp_depth`` 1: the multi-token-prediction head serves only the
reference's training loss, so serving carries no MTP params.  Same values
as ``repro/configs/deepseek_v3_671b.py``.
"""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, QuantConfig, register

CONFIG = register(
    ArchConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_head=128,
        d_ff=18432,  # the 3 dense layers; experts use moe.d_expert_ff
        vocab_size=129280,
        prefix_layers=("Md", "Md", "Md"),
        pattern_period=("Mm",),
        ffn_type="silu_glu",
        rope_theta=10000.0,
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=1536,
            qk_nope_dim=128,
            qk_rope_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            n_routed=256,
            n_shared=1,
            top_k=8,
            d_expert_ff=2048,
            router_scoring="sigmoid",
            route_scale=2.5,
        ),
        mtp_depth=1,
        quant=QuantConfig(act_bits=8, attn_act_bits=8),
        max_seq=131072,
        source="[arXiv:2412.19437; hf]",
    )
)

"""whisper-tiny -- encoder-decoder ASR transformer, conv frontend stubbed.

[arXiv:2212.04356; unverified]  4L encoder + 4L decoder, d_model=384 6H
(kv=6) d_ff=1536 (gelu) vocab=51865 tied.  The conv1d mel frontend is a
STUB: the caller supplies precomputed frame embeddings (1500 frames x 384,
after the conv stack's 2x downsampling of 3000 mel frames); the encoder
(sinusoidal positions, non-causal) and the decoder (learned positions,
cross-attention onto the encoder's output) are real.  Same values as
``repro/configs/whisper_tiny.py``.
"""

from repro_torch.configs.base import ArchConfig, EncoderConfig, QuantConfig, register

CONFIG = register(
    ArchConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,  # decoder layers; encoder depth in EncoderConfig
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        pattern_period=("g",),
        ffn_type="gelu",
        pos_embedding="learned",
        tie_embeddings=True,
        encoder=EncoderConfig(kind="audio_stub", n_positions=1500, n_layers=4),
        quant=QuantConfig(act_bits=8, attn_act_bits=8),
        max_seq=448,
        source="[arXiv:2212.04356; unverified]",
    )
)

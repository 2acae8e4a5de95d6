"""End-to-end QAT on the PyTorch/CUDA port: train the ~100M-parameter binary
LM of ``examples/train_binary_lm.py`` and watch the loss drop (the paper's
benchmark models are produced by this recipe: latent float32 weights, STE
binarization, quantized activations).

    PYTHONPATH=src python examples/torch_train_binary_lm.py [--steps 200]              # on the card
    PYTHONPATH=src python examples/torch_train_binary_lm.py --steps 20 --device cpu

8 layers x d_model 512 x ffn 2048, vocab 32000 (llama-style dense blocks,
W1A8; 64.2 M parameters by ``ArchConfig.param_count``), on one device.  A
checkpoint at half the steps and at the end (params, AdamW state, data
cursor) under ``--ckpt-dir``; a rerun with the same directory resumes from
it, and SIGTERM checkpoints and exits.
"""

import argparse
import os
import tempfile
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig, QuantConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.optim import adamw
from repro_torch.runtime import fault_tolerance as FT
from repro_torch.runtime import train_loop as TL


def build_cfg(d_model=512, layers=8, vocab=32000) -> ArchConfig:
    return ArchConfig(
        name="binary-lm-100m",
        family="dense",
        n_layers=layers,
        d_model=d_model,
        n_heads=8,
        n_kv_heads=4,
        d_ff=4 * d_model,
        vocab_size=vocab,
        pattern_period=("g",),
        ffn_type="silu_glu",
        quant=QuantConfig(act_bits=8, attn_act_bits=8),
        max_seq=2048,
    )


def run(cfg, steps: int, device="cuda", batch: int = 4, seq: int = 128, lr: float = 6e-4,
        ckpt_dir: str = "") -> list:
    """Train ``steps`` steps (resuming from ``ckpt_dir``); returns the
    runner's logged history."""
    print(f"[example] binary LM: {cfg.param_count()/1e6:.1f}M params, mode {cfg.quant.mode_name}, "
          f"on {device}")
    tcfg = TL.TrainConfig(optimizer=adamw.AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps))
    step = TL.make_train_step(cfg, tcfg, device=device)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))
    params, opt = TL.init_train_state(0, cfg, device=device)
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch-binary-lm")
    runner = FT.TrainingRunner(
        step, pipe, CheckpointManager(ckpt_dir, keep=2),
        FT.RunnerConfig(total_steps=steps, checkpoint_every=max(steps // 2, 1),
                        log_every=max(steps // 10, 1)),
    )
    runner.install_signal_handlers()
    try:
        start, params, opt = runner.try_restore(params, opt)
        t0 = time.time()
        params, opt, hist = runner.run(params, opt, start)
    finally:
        runner.restore_signal_handlers()
    if hist:
        print(
            f"[example] QAT loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
            f"in {time.time()-t0:.0f}s "
            f"({'DECREASED' if hist[-1]['loss'] < hist[0]['loss'] else 'did not decrease'})"
        )
    return hist


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    run(build_cfg(), args.steps, args.device, args.batch, args.seq, args.lr, args.ckpt_dir)


if __name__ == "__main__":
    main()

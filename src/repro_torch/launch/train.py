"""QAT training entry point of the port (``repro.launch.train``'s counterpart).

  PYTHONPATH=src python -m repro_torch.launch.train --arch bit-bert-base \
      --smoke --device cpu --steps 50 --batch 8 --seq 64 --ckpt-dir DIR
  PYTHONPATH=src python -m repro_torch.launch.train --arch bit-bert-base \
      --steps 30 --batch 32 --seq 128 --lr 1e-3 --ckpt-dir DIR

Trains a model's latent weights from a seed on the synthetic token stream
(``data/pipeline.py``) with straight-through QAT and AdamW (warm-up over a
tenth of ``--steps``, a cosine to ``--steps``), on one device: the card
unless ``--device cpu``.  ``--smoke`` selects the reduced config.  A
checkpoint every ``--ckpt-every`` steps holds params, optimizer state and
the data cursor; SIGTERM or SIGINT checkpoints at the next step and exits,
and a relaunch with the same flags resumes from the latest checkpoint bit
for bit.  Every family trains: the dense GQA and BERT-encoder families,
deepseek's MLA and MoE (with the MoE layers' balance loss, and
deepseek-v3's MTP head), the recurrent families, and the frontends -- the
stream then also carries a float32 stub frontend per row
(``encoder.n_positions`` x ``d_input``): internvl2-2b's patch rows,
whisper-tiny's frames through its encoder and the decoder's
cross-attention.
"""

import argparse
import os
import tempfile

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.smoke import smoke_variant
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.optim import adamw
from repro_torch.runtime import fault_tolerance as FT
from repro_torch.runtime import train_loop as TL


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=list(list_configs()))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    tcfg = TL.TrainConfig(
        optimizer=adamw.AdamWConfig(
            lr=args.lr, warmup_steps=max(args.steps // 10, 1), total_steps=args.steps
        ),
        accum_steps=args.accum,
    )
    enc = cfg.encoder
    pipe = TokenPipeline(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
                   seed=args.seed, frontend_positions=enc.n_positions if enc else 0,
                   frontend_dim=(enc.d_input or cfg.d_model) if enc else 0)
    )
    step = TL.make_train_step(cfg, tcfg, device=args.device)
    params, opt = TL.init_train_state(args.seed, cfg, device=args.device)

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), f"repro_torch-ckpt-{args.arch}")
    manager = CheckpointManager(ckpt_dir, keep=2)
    runner = FT.TrainingRunner(
        step,
        pipe,
        manager,
        FT.RunnerConfig(
            total_steps=args.steps,
            checkpoint_every=args.ckpt_every,
            log_every=max(args.steps // 20, 1),
        ),
        log_fn=lambda msg: print(msg, flush=True),
    )
    runner.install_signal_handlers()
    start, params, opt = runner.try_restore(params, opt)
    try:
        params, opt, hist = runner.run(params, opt, start)
    finally:
        runner.restore_signal_handlers()
    if hist:
        first, last = hist[0]["loss"], hist[-1]["loss"]
        print(f"[train] loss {first:.4f} -> {last:.4f} over {args.steps} steps")
    print(f"[train] p50 step {runner.p50*1e3:.0f} ms, p99 {runner.p99*1e3:.0f} ms")


if __name__ == "__main__":
    main()

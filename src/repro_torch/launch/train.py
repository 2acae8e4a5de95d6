"""QAT training entry point of the port (``repro.launch.train``'s counterpart).

  PYTHONPATH=src python -m repro_torch.launch.train --arch bit-bert-base \
      --smoke --device cpu --steps 50 --batch 8 --seq 64 --ckpt-dir DIR
  PYTHONPATH=src python -m repro_torch.launch.train --arch bit-bert-base \
      --steps 30 --batch 32 --seq 128 --lr 1e-3 --ckpt-dir DIR
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
      --smoke --device cpu --devices 4 --mesh 2x2 --steps 100

Trains a model's latent weights from a seed on the synthetic token stream
(``data/pipeline.py``) with straight-through QAT and AdamW (warm-up over a
tenth of ``--steps``, a cosine to ``--steps``): on the card unless
``--device cpu``.  ``--smoke`` selects the reduced config.  A checkpoint
every ``--ckpt-every`` steps holds params, optimizer state and the data
cursor; SIGTERM or SIGINT checkpoints at the next step and exits, and a
relaunch with the same flags resumes from the latest checkpoint bit for
bit.  Every family trains: the dense GQA and BERT-encoder families,
deepseek's MLA and MoE (with the MoE layers' balance loss, and
deepseek-v3's MTP head), the recurrent families, and the frontends -- the
stream then also carries a float32 stub frontend per row
(``encoder.n_positions`` x ``d_input``): internvl2-2b's patch rows,
whisper-tiny's frames through its encoder and the decoder's
cross-attention.

``--devices N --mesh DxM`` spawns N ranks (``torch.multiprocessing``) and
trains over a ``D x M`` mesh (``data`` x ``model``; ``launch/mesh.py``)
the global-batch step of ``runtime/train_loop.py``: FSDP storage, each
leaf gathered for the forward, global fake-quant ranges and loss, and an
MoE model's routing (capacity, drops, expert buffer, balance loss) over
the global microbatch.  Every
rank draws the whole global batch and keeps its rows.  The backend is
gloo with ``--device cpu``; on the card NCCL, one card a rank, when N is
at most the cards there are, else gloo with the ranks sharing the cards
(a CUDA tensor's collective staged through the host).  Rank 0 prints and
writes the checkpoints (the gathered leaves), so a run resumes on any
mesh.  Without ``--devices`` the run is one process on one device.
"""

import argparse
import os
import signal
import sys
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.smoke import smoke_variant
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.optim import adamw
from repro_torch.runtime import fault_tolerance as FT
from repro_torch.runtime import train_loop as TL


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=list(list_configs()))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--devices", type=int, default=0, help="ranks to spawn (0: one process)")
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 2x2")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _mesh_shape(text: str):
    data, model = (int(x) for x in text.split("x"))
    return data, model


def train(args, rank: int = 0, device=None) -> None:
    """One rank's run (the whole run without ``--devices``)."""
    device = device or args.device
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    data, model = _mesh_shape(args.mesh)
    mesh = shardings = None
    if args.devices:
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(data, model, device=str(device))
        if mesh.get_coordinate() is None:
            return  # a rank past the mesh
    elif data * model > 1:
        raise ValueError(f"mesh {data}x{model} exceeds 1 devices (pass --devices)")
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
    step = TL.make_train_step(cfg, tcfg, device=device, mesh=mesh)
    params, opt = TL.init_train_state(args.seed, cfg, device=device, mesh=mesh)
    if mesh is not None:
        p_sh, o_sh = TL.train_shardings(cfg, mesh)
        shardings = {"params": p_sh, "opt": o_sh}

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), f"repro_torch-ckpt-{args.arch}")
    manager = CheckpointManager(ckpt_dir, keep=2, writer=rank == 0)
    runner = FT.TrainingRunner(
        step,
        pipe,
        manager,
        FT.RunnerConfig(
            total_steps=args.steps,
            checkpoint_every=args.ckpt_every,
            log_every=max(args.steps // 20, 1),
        ),
        log_fn=say,
        shardings=shardings,
    )
    runner.install_signal_handlers()
    start, params, opt = runner.try_restore(params, opt)
    try:
        params, opt, hist = runner.run(params, opt, start)
    finally:
        runner.restore_signal_handlers()
    if hist:
        first, last = hist[0]["loss"], hist[-1]["loss"]
        say(f"[train] loss {first:.4f} -> {last:.4f} over {args.steps} steps")
    say(f"[train] p50 step {runner.p50*1e3:.0f} ms, p99 {runner.p99*1e3:.0f} ms")


def backend_for(device: str, n: int) -> str:
    """gloo on the CPU; NCCL when each rank has a card of its own; gloo
    with the ranks sharing the cards otherwise (NCCL refuses two ranks on
    one GPU)."""
    if not str(device).startswith("cuda"):
        return "gloo"
    return "nccl" if n <= torch.cuda.device_count() else "gloo"


def _rank(rank: int, argv, world: int, init_file: str, backend: str) -> None:
    import torch.distributed as dist

    args = parse_args(argv)
    device = args.device
    if str(device).startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs a CUDA device")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank, world_size=world)
    try:
        train(args, rank, device)
    finally:
        dist.destroy_process_group()


def spawn(argv, n: int) -> None:
    """Run ``n`` ranks of ``argv``'s training and wait for them; SIGTERM /
    SIGINT are passed on to every rank (each checkpoints at the same next
    step and exits)."""
    import torch.multiprocessing as mp

    args = parse_args(argv)
    backend = backend_for(args.device, n)
    with tempfile.TemporaryDirectory(prefix="repro_torch-rdzv-") as tmp:
        ctx = mp.spawn(_rank, args=(argv, n, os.path.join(tmp, "init"), backend), nprocs=n, join=False)

        def forward(signum, frame):
            for p in ctx.processes:
                if p.is_alive():
                    os.kill(p.pid, signum)

        prev = {s: signal.signal(s, forward) for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            while not ctx.join():
                pass
        finally:
            for s, h in prev.items():
                signal.signal(s, h)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.devices:
        spawn(argv, args.devices)
    else:
        train(args)


if __name__ == "__main__":
    main()

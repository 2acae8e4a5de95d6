"""Batched serving entry point of the port (``repro.launch.serve``'s counterpart).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --requests 8 --max-new 16

Builds a model's serving params from a seed (binarize -> bit-pack ->
colsum fold, one layer at a time: ``model_zoo.init_serving_params``) and
serves a queue of requests through the slot-managed continuous-batching
engine.  Runs on the card unless ``--device cpu``; on the card a config
whose backend is a plain PyTorch core (``mxu``, ``popcount``) serves
through the hand-written K1 kernel (``pallas``) instead.

Two request sources:

* fixed queue (default): ``--requests`` prompts of ``--prompt-len``
  tokens, all arriving at t=0;
* open-loop traffic (``--traffic``): seeded Poisson arrivals with uniform
  prompt / output length ranges (``runtime/traffic.py``); ``--bench-out``
  writes the serve-bench record.

Robustness:

* ``--fault-plan '{"decode_fail_ticks": [3]}'`` -- a deterministic failure
  schedule (``runtime.faults.FaultPlan`` JSON);
* ``--deadline-s 2.0`` -- per-request deadline from arrival;
* ``--snapshot-every 8 --snapshot-dir DIR`` -- snapshot the engine's state
  every 8 decode ticks.

Crash recovery: a killed process's in-flight requests finish token for
token as an uninterrupted run would::

  # serving process (killed mid-batch: SIGKILL, OOM, preemption, ...)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --requests 8 --max-new 24 --snapshot-every 4 --snapshot-dir DIR

  # replacement process: same arch / seed / slots / max-len, --resume
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --snapshot-dir DIR --resume
"""

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config, list_configs
from repro_torch.configs.smoke import smoke_variant
from repro_torch.core import backend_registry
from repro_torch.models import model_zoo as Z
from repro_torch.runtime.faults import parse_fault_plan
from repro_torch.runtime.serve_loop import Request, ServeEngine
from repro_torch.runtime.traffic import TrafficConfig, generate_requests, save_bench, summarize_bench


def _latent_nbytes(node) -> int:
    """Bytes of the float32 latents that serving params were packed from:
    a packed linear's ``K x N`` (K from its packed words, whole words of
    32) beside every other leaf at 4 bytes an element."""
    if isinstance(node, dict):
        if "w_packed" in node:
            *lead, kw, n = node["w_packed"].shape
            return int(np.prod(lead, dtype=np.int64)) * kw * 32 * n * 4
        return sum(_latent_nbytes(v) for v in node.values())
    if isinstance(node, list):
        return sum(_latent_nbytes(v) for v in node)
    return node.numel() * 4


def _nbytes(node) -> int:
    if isinstance(node, dict):
        return sum(_nbytes(v) for v in node.values())
    if isinstance(node, list):
        return sum(_nbytes(v) for v in node)
    return node.numel() * node.element_size()


def serving_config(name: str, smoke: bool, device: str):
    """The config ``main`` serves: the registry's (its smoke variant with
    ``smoke``), on the card with a plain core's backend swapped for K1's."""
    cfg = get_config(name)
    if smoke:
        cfg = smoke_variant(cfg)
    q = cfg.quant
    plain = q.backend != "auto" and not backend_registry.get_backend(q.backend).cuda_kernel
    if device != "cpu" and q.enabled and plain:
        cfg = dataclasses.replace(cfg, quant=dataclasses.replace(q, backend="pallas"))
    return cfg


def fixed_queue(args, vocab_size: int):
    """``--requests`` prompts drawn from ``default_rng(--seed)``."""
    rng = np.random.default_rng(args.seed)
    return [
        Request(
            prompt=rng.integers(0, vocab_size, size=(args.prompt_len,)).astype(np.int32),
            max_new_tokens=args.max_new,
            temperature=args.temperature,
            deadline_s=args.deadline_s,
        )
        for _ in range(args.requests)
    ]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as slots emit them (per-request callbacks)")
    ap.add_argument("--autotune-cache", default=None,
                    help="JSON path for persisted QMM autotune verdicts")
    # open-loop traffic mode
    ap.add_argument("--traffic", action="store_true",
                    help="Poisson open-loop workload instead of the fixed queue")
    ap.add_argument("--rate", type=float, default=8.0)
    ap.add_argument("--bench-out", default=None, help="write the serve-bench record here")
    # robustness
    ap.add_argument("--fault-plan", default=None,
                    help="JSON FaultPlan (runtime.faults) injected into the run")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline in seconds from arrival")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot engine state every K decode ticks (0 = off)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="CheckpointManager directory for engine snapshots")
    ap.add_argument("--resume", action="store_true",
                    help="resume in-flight requests from --snapshot-dir instead "
                         "of serving a fresh queue")
    return ap


def main(argv=None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    if args.resume and not args.snapshot_dir:
        ap.error("--resume requires --snapshot-dir")

    cfg = serving_config(args.arch, args.smoke, args.device)
    serving = Z.init_serving_params(args.seed, cfg, device=args.device)
    full, packed = _latent_nbytes(serving), _nbytes(serving)
    print(f"[serve] weights: fp32 latent {full/1e6:.1f} MB -> packed {packed/1e6:.1f} MB"
          f" ({full/packed:.1f}x)", flush=True)

    engine = ServeEngine(
        cfg,
        serving,
        batch_slots=args.slots,
        max_len=args.max_len,
        seed=args.seed,
        device=args.device,
        autotune_cache_path=args.autotune_cache,
        fault_plan=parse_fault_plan(args.fault_plan),
        snapshot_every=args.snapshot_every,
        snapshot_dir=args.snapshot_dir,
    )
    if args.resume:
        t0 = time.perf_counter()
        done = engine.resume()
        dt = time.perf_counter() - t0
    else:
        if args.traffic:
            tc = TrafficConfig(
                n_requests=args.requests,
                rate_rps=args.rate,
                prompt_len=(max(1, args.prompt_len // 2), args.prompt_len),
                new_tokens=(max(1, args.max_new // 2), args.max_new),
                temperature=args.temperature,
                deadline_s=args.deadline_s,
                seed=args.seed,
            )
            reqs = generate_requests(tc, cfg.vocab_size)
        else:
            reqs = fixed_queue(args, cfg.vocab_size)
        if args.stream:
            for i, r in enumerate(reqs):
                r.on_token = lambda tok, i=i: print(f"  [stream] req{i} -> {tok}")
        t0 = time.perf_counter()
        done = engine.run(reqs)
        dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in done)
    print(f"[serve] {len(done)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s incl. capture)")
    for i, r in enumerate(done[:4]):
        print(f"  req{i}: prompt[:4]={np.asarray(r.prompt)[:4].tolist()} -> out[:8]={r.output[:8]}")
    if args.bench_out:
        summary = summarize_bench(
            done, dt,
            {"arch": args.arch, "smoke": bool(args.smoke), "device": args.device,
             "batch_slots": args.slots, "max_len": args.max_len, "traffic": args.traffic},
            events=engine.last_events,
        )
        save_bench(args.bench_out, summary)
        print(f"[serve] bench summary -> {args.bench_out} "
              f"(rps={summary['rps']:.2f}, p50={summary['p50_ms']:.1f}ms, "
              f"p99={summary['p99_ms']:.1f}ms)")


if __name__ == "__main__":
    main()

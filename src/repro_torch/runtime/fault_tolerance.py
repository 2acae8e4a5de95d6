"""Preemption-safe training runner (port of ``repro.runtime.fault_tolerance``).

* **Preemption**: SIGTERM / SIGINT request a checkpoint at the next step
  boundary, after which the loop exits cleanly; a restart resumes bit for
  bit (params, optimizer state and the data cursor are all in the
  checkpoint).  The handlers chain to whatever the host process had
  installed and are put back by ``restore_signal_handlers``.
* **Elastic rescale**: checkpoints hold whole tensors.  A sharded run
  (``shardings=``, the ``{"params", "opt"}`` tree of ``NamedSharding``)
  saves the global leaves, gathered to the mesh's first rank alone, which
  writes them, and restores each rank's slice, so a job saved on one mesh
  resumes on another (``CheckpointManager``).
* **Stragglers**: the runner keeps every step's time and exposes its
  ``p50`` / ``p99``, so an orchestrator can evict a slow worker.

A step's time is taken on the host clock around the step and a
synchronisation of its device, so it covers the device work.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import TokenPipeline

__all__ = ["RunnerConfig", "TrainingRunner"]


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    keep_checkpoints: int = 3
    log_every: int = 10


class TrainingRunner:
    """Step loop, checkpoint / restore and preemption handling.

    ``train_step``: ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` (``runtime.train_loop.make_train_step``).  The runner knows
    nothing of the model: it moves state through steps and persists it.
    """

    def __init__(
        self,
        train_step: Callable,
        pipeline: TokenPipeline,
        manager: CheckpointManager,
        cfg: RunnerConfig,
        log_fn: Callable[[str], None] = print,
        shardings=None,
    ):
        self.train_step = train_step
        self.pipeline = pipeline
        self.manager = manager
        self.cfg = cfg
        self.log = log_fn
        self.shardings = shardings
        self._preempted = False
        self._prev_handlers: Dict[int, object] = {}
        self.step_times: List[float] = []

    # -- preemption ------------------------------------------------------
    def install_signal_handlers(self) -> None:
        """Request a checkpoint-and-exit on SIGTERM / SIGINT.

        The previous handlers are saved and CHAINED: whatever the host had
        installed still runs after the runner marks itself preempted.
        Idempotent: a second install keeps the originals saved by the first.
        """
        if self._prev_handlers:
            return

        def handler(signum, frame):
            self.log(f"[runner] signal {signum}: checkpoint at next boundary")
            self._preempted = True
            prev = self._prev_handlers.get(signum)
            if callable(prev):  # SIG_DFL / SIG_IGN are not callables
                prev(signum, frame)

        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev_handlers[sig] = signal.signal(sig, handler)

    def restore_signal_handlers(self) -> None:
        """Reinstall the handlers that were active before ``install``."""
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
        self._prev_handlers = {}

    # -- resume ----------------------------------------------------------
    def try_restore(self, params, opt_state):
        """(start step, params, opt_state) from the latest checkpoint, each
        leaf on its template's device; ``(0, params, opt_state)`` if none."""
        step = self.manager.latest_step()
        if step is None:
            return 0, params, opt_state
        step, tree, extras = self.manager.restore(step, like={"params": params, "opt": opt_state},
                                                  shardings=self.shardings)
        self.pipeline.restore(extras["pipeline"])
        self.log(f"[runner] resumed from step {step}")
        return step, tree["params"], tree["opt"]

    def _save(self, step: int, params, opt_state) -> None:
        extras = {"pipeline": self.pipeline.state(), "step": step}
        tree = {"params": params, "opt": opt_state}
        if self.shardings is None:
            path = self.manager.save(step, tree, extras)
        else:
            # the global leaves to the mesh's first rank alone, which
            # writes; every rank waits for the commit
            from repro_torch.runtime import collectives as C
            from repro_torch.runtime import sharding as SH

            path = self.manager.save(step, tree, extras, gather=lambda t: SH.gather_tree_to(t, self.shardings))
            mesh = leaves(self.shardings)[0].mesh
            C.barrier([mesh.get_group(a) for a in mesh.mesh_dim_names], leaves(params)[0].device)
        self.log(f"[runner] checkpoint step {step} -> {path}")

    # -- main loop -------------------------------------------------------
    def run(self, params, opt_state, start_step: int = 0):
        metrics_hist: List[Dict[str, float]] = []
        step = start_step
        while step < self.cfg.total_steps:
            batch = {k: torch.from_numpy(v) for k, v in self.pipeline.next().items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = self.train_step(params, opt_state, batch)
            if metrics["loss"].is_cuda:
                torch.cuda.synchronize(metrics["loss"].device)
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            step += 1
            if step % self.cfg.log_every == 0 or step == self.cfg.total_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step_time_s"] = dt
                metrics_hist.append({"step": step, **m})
                self.log(
                    f"[runner] step {step} loss {m['loss']:.4f} "
                    f"({dt*1e3:.0f} ms, p50 {self.p50*1e3:.0f} ms)"
                )
            stop = self._stop()
            if step % self.cfg.checkpoint_every == 0 or stop:
                self._save(step, params, opt_state)
                if stop:
                    self.log("[runner] exiting after preemption checkpoint")
                    break
        return params, opt_state, metrics_hist

    def _stop(self) -> bool:
        """Whether to checkpoint and exit now: this process was signalled,
        or, in a sharded run, any rank of the mesh was (one all-reduce a
        step, so every rank stops at the same step)."""
        if self.shardings is None:
            return self._preempted
        from repro_torch.runtime import collectives as C

        mesh = leaves(self.shardings)[0].mesh
        flag = torch.tensor([float(self._preempted)])
        for axis in mesh.mesh_dim_names:
            flag = C.all_reduce(flag, "max", group=mesh.get_group(axis))
        return bool(flag.item())

    @property
    def p50(self) -> float:
        return float(np.median(self.step_times)) if self.step_times else 0.0

    @property
    def p99(self) -> float:
        return float(np.percentile(self.step_times, 99)) if self.step_times else 0.0

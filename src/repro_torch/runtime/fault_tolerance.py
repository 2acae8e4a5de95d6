"""Preemption-safe training runner (port of ``repro.runtime.fault_tolerance``).

* **Preemption**: SIGTERM / SIGINT request a checkpoint at the next step
  boundary, after which the loop exits cleanly; a restart resumes bit for
  bit (params, optimizer state and the data cursor are all in the
  checkpoint).  The handlers chain to whatever the host process had
  installed and are put back by ``restore_signal_handlers``.
* **Elastic rescale**: checkpoints hold whole tensors, so a job restarts on
  another shard geometry with ``TokenPipeline.reshard`` (one device here:
  the reference's re-sharding restore has no counterpart).
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
    ):
        self.train_step = train_step
        self.pipeline = pipeline
        self.manager = manager
        self.cfg = cfg
        self.log = log_fn
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
        step, tree, extras = self.manager.restore(step, like={"params": params, "opt": opt_state})
        self.pipeline.restore(extras["pipeline"])
        self.log(f"[runner] resumed from step {step}")
        return step, tree["params"], tree["opt"]

    def _save(self, step: int, params, opt_state) -> None:
        extras = {"pipeline": self.pipeline.state(), "step": step}
        path = self.manager.save(step, {"params": params, "opt": opt_state}, extras)
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
            if step % self.cfg.checkpoint_every == 0 or self._preempted:
                self._save(step, params, opt_state)
                if self._preempted:
                    self.log("[runner] exiting after preemption checkpoint")
                    break
        return params, opt_state, metrics_hist

    @property
    def p50(self) -> float:
        return float(np.median(self.step_times)) if self.step_times else 0.0

    @property
    def p99(self) -> float:
        return float(np.percentile(self.step_times, 99)) if self.step_times else 0.0

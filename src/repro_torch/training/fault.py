"""Fault-tolerant training loop: preemption-safe, auto-resume, straggler
watchdog.

* checkpoint every ``ckpt_every`` steps through the async saver; SIGTERM
  (preemption notice) triggers a final synchronous save before exit;
* on start, the loop always tries to resume from the latest checkpoint —
  restarts are the recovery path for node failures;
* a step-time watchdog flags stragglers: steps slower than
  ``straggler_factor`` x the running median raise a callback (offline it
  logs).

A step's time runs from taking its batch to the loss being ready on the
device (the reference waits with ``jax.block_until_ready``; here the loss
is read back, which waits for the step's kernels).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from . import checkpoint as ckpt
from .optimizer import AdamWState


class SimulatedPreemption(Exception):
    """Raised by tests/examples to emulate a SIGTERM mid-run."""


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    keep_last: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


class TrainLoop:
    def __init__(self, loop_cfg: LoopConfig, train_step: Callable,
                 params: Any, opt_state: AdamWState, batches: Iterable[dict],
                 pipeline=None,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 log: Callable[[str], None] = print):
        self.cfg = loop_cfg
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.batches = iter(batches)
        self.pipeline = pipeline
        self.on_straggler = on_straggler or (
            lambda step, t: log(f"[straggler] step {step} took {t:.3f}s"))
        self.log = log
        self.saver = ckpt.AsyncSaver()
        self.step = 0
        self.step_times: List[float] = []
        self.losses: List[float] = []
        self._preempted = False

    # ---------------------------------------------------------- lifecycle
    def _install_signal_handler(self):
        def handler(_sig, _frm):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass            # non-main thread (tests)

    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state._asdict()}

    def try_resume(self) -> bool:
        last = ckpt.latest_step(self.cfg.ckpt_dir)
        if last is None:
            return False
        tree, step, extra = ckpt.restore(self.cfg.ckpt_dir,
                                         self._state_tree())
        self.params = tree["params"]
        self.opt_state = AdamWState(**tree["opt"])
        self.step = step
        if self.pipeline is not None and "pipeline" in extra:
            self.pipeline.restore_state(extra["pipeline"])
        self.log(f"[resume] restored step {step} from {self.cfg.ckpt_dir}")
        return True

    def _save(self, sync: bool = False):
        extra = {}
        if self.pipeline is not None:
            extra["pipeline"] = self.pipeline.checkpoint_state()
        if sync:
            ckpt.save(self.cfg.ckpt_dir, self.step, self._state_tree(), extra)
        else:
            self.saver.save_async(self.cfg.ckpt_dir, self.step,
                                  self._state_tree(), extra)
        ckpt.cleanup(self.cfg.ckpt_dir, self.cfg.keep_last)

    # --------------------------------------------------------------- run
    def run(self, max_steps: Optional[int] = None) -> Dict[str, Any]:
        """Resume if a checkpoint exists, then step to ``total_steps`` (or
        ``max_steps`` more).  Appends each step's seconds to
        ``step_times`` and its loss to ``losses``."""
        self._install_signal_handler()
        self.try_resume()
        end = min(self.cfg.total_steps,
                  self.step + (max_steps or self.cfg.total_steps))
        metrics = {}
        try:
            while self.step < end:
                batch = next(self.batches)
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])      # waits for the step
                dt = time.perf_counter() - t0
                self.step += 1
                self.step_times.append(dt)
                self.losses.append(loss)
                med = float(np.median(self.step_times[-50:]))
                if (len(self.step_times) > 5
                        and dt > self.cfg.straggler_factor * med):
                    self.on_straggler(self.step, dt)
                if self.step % self.cfg.log_every == 0:
                    self.log(f"[step {self.step}] loss={loss:.4f} "
                             f"({dt*1e3:.0f} ms)")
                if self.step % self.cfg.ckpt_every == 0:
                    self._save()
                if self._preempted:
                    raise SimulatedPreemption
        except SimulatedPreemption:
            self.log(f"[preempt] saving at step {self.step} and exiting")
            self.saver.wait()
            self._save(sync=True)
            raise
        self.saver.wait()
        self._save(sync=True)
        return metrics

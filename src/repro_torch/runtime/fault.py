"""Fault tolerance: checkpoint/restart supervision, failure injection,
straggler detection (counterpart of ``repro.runtime.fault``).

The supervisor (a) checkpoints every K steps (async, atomic rename), (b) on
a failure restores the latest checkpoint into the layout of the state it
holds and replays the deterministic data stream from the saved step, and
(c) watches per-step wall time against an EMA to flag stragglers.

``dt`` is taken around ``step_fn`` alone, before the metrics are read, as in
the reference. The port's step issues its work to the card and returns; so
on the card ``dt`` is the step's host issue time, and the wait for the
device falls into the metrics' read that follows.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.checkpoint import latest_step, restore, save


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministically fail at given steps, each once."""
    fail_at_steps: tuple[int, ...] = ()
    seen: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self.seen:
            self.seen.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


@dataclass
class StragglerMonitor:
    """EMA step-time watchdog. threshold x EMA -> straggler event."""
    ema: float | None = None
    beta: float = 0.9
    threshold: float = 3.0
    events: list = field(default_factory=list)
    on_straggler: Callable[[int, float, float], None] | None = None

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = self.ema is not None and dt > self.threshold * self.ema
        if is_straggler:
            self.events.append((step, dt, self.ema))
            if self.on_straggler:
                self.on_straggler(step, dt, self.ema)
        # a straggler's sample enters the EMA clipped to threshold x EMA
        sample = min(dt, (self.ema or dt) * self.threshold)
        self.ema = sample if self.ema is None else self.beta * self.ema + (1 - self.beta) * sample
        return is_straggler


def _wait(pending: list) -> None:
    while pending:
        pending.pop(0).result()


@dataclass
class TrainSupervisor:
    """Run the train loop with checkpoint/restart fault tolerance."""
    step_fn: Callable           # (state, batch) -> (state, metrics)
    pipeline: Any               # .next_batch(step)
    ckpt_dir: str
    ckpt_every: int = 50
    max_restarts: int = 10
    monitor: StragglerMonitor = field(default_factory=StragglerMonitor)
    injector: FailureInjector | None = None
    async_ckpt: bool = True

    def run(self, state, n_steps: int, start_step: int = 0):
        """Steps ``start_step`` to ``n_steps - 1``. Returns (state, history):
        a row per executed step, replays included."""
        history = []
        step = start_step
        restarts = 0
        pending = []   # async saves in flight
        while step < n_steps:
            try:
                batch = self.pipeline.next_batch(step)
                if self.injector:
                    self.injector.check(step)
                t0 = time.monotonic()
                state, metrics = self.step_fn(state, batch)
                dt = time.monotonic() - t0
                self.monitor.observe(step, dt)
                history.append({"step": step, "dt": dt,
                                **{k: float(v) for k, v in metrics.items()}})
                step += 1
                if self.ckpt_every and step % self.ckpt_every == 0:
                    saved = save(state, self.ckpt_dir, step, blocking=not self.async_ckpt,
                                 metadata={"step": step})
                    if self.async_ckpt:
                        pending.append(saved)
            except InjectedFailure:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                # the writer threads outlive an injected failure in this
                # process: the restart point is the last save made, not the
                # last save that happened to be on disk already
                _wait(pending)
                last = latest_step(self.ckpt_dir)
                if last is None:
                    step = start_step
                    continue   # from scratch, with the state as it stands
                state, _ = restore(self.ckpt_dir, last, state)
                step = last
        _wait(pending)
        return state, history

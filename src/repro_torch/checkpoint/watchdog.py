"""Step watchdog: straggler detection + liveness heartbeat.

At fleet scale a hung host rarely crashes loudly — it just stops making
progress, or makes it 10x slower than its peers. The watchdog gives the
training loop two cheap defenses:

  * **Straggler detection** — records per-step wall times and flags any
    step slower than ``threshold`` x the trailing median. The launcher
    logs the flag; an external supervisor (or the elastic-restart path)
    decides whether to evict the host. A real deployment feeds this
    per-host; here it guards the single-process loop and is exercised
    by failure-injection tests.
  * **Heartbeat file** — atomically rewritten every step with
    {step, time}; an external process-level supervisor declares the job
    dead when the heartbeat goes stale and restarts from the newest
    checkpoint (CheckpointManager.latest_step + restore — the auto-
    resume path in launch/train.py).
"""
from __future__ import annotations

import json
import os
import statistics
import tempfile
import time


class StepWatchdog:
    def __init__(self, heartbeat_path: str | None = None,
                 threshold: float = 3.0, window: int = 32):
        self.heartbeat_path = heartbeat_path
        self.threshold = threshold
        self.window = window
        self.times: list[float] = []
        self.stragglers: list[int] = []
        self._t0: float | None = None
        self._step = 0

    def start_step(self, step: int) -> None:
        self._step = step
        self._t0 = time.monotonic()

    def end_step(self) -> bool:
        """Returns True if this step was a straggler."""
        if self._t0 is None:
            return False
        dt = time.monotonic() - self._t0
        self._t0 = None
        straggler = False
        if len(self.times) >= 5:
            med = statistics.median(self.times[-self.window:])
            straggler = dt > self.threshold * med
        self.times.append(dt)
        if straggler:
            self.stragglers.append(self._step)
        self._heartbeat()
        return straggler

    def _heartbeat(self) -> None:
        if not self.heartbeat_path:
            return
        payload = json.dumps({"step": self._step, "time": time.time()})
        d = os.path.dirname(os.path.abspath(self.heartbeat_path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d)
        with os.fdopen(fd, "w") as f:
            f.write(payload)
        os.replace(tmp, self.heartbeat_path)          # atomic

    @staticmethod
    def heartbeat_age(path: str) -> float | None:
        """Seconds since the last heartbeat, or None if absent/corrupt.
        The external supervisor's liveness probe."""
        try:
            with open(path) as f:
                return time.time() - json.load(f)["time"]
        except (OSError, ValueError, KeyError):
            return None

    def median_step_s(self) -> float | None:
        return statistics.median(self.times) if self.times else None

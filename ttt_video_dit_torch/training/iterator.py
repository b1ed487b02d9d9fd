"""Training iterator: the step loop with an EMA step timer, interval
checkpoints and a timeout-aware checkpoint (port of
ttt_video_dit_tpu/training/iterator.py).

A checkpoint is due at every multiple of ``checkpoint_interval``, and once
when the job's wall clock (``timeout_minutes``) has less left than one EMA
step plus a 6-minute margin; at the end, a final one when the interval does
not divide the last step.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class TrainingIterator:
    SAVE_TIME_MARGIN_S = 6 * 60

    def __init__(self, start_step: int, num_steps: int, checkpoint_interval: int = 0, timeout_minutes: int = 0,
                 on_checkpoint: Optional[Callable[[int, bool], None]] = None):
        self.step = start_step
        self.num_steps = num_steps
        self.checkpoint_interval = checkpoint_interval
        self.timeout_minutes = timeout_minutes
        self.on_checkpoint = on_checkpoint
        self._start_time = time.monotonic()
        self._last_step_time: Optional[float] = None
        self._ema_step_s: Optional[float] = None
        self._timeout_saved = False

    def _update_ema(self) -> None:
        now = time.monotonic()
        if self._last_step_time is not None:
            dt = now - self._last_step_time
            self._ema_step_s = dt if self._ema_step_s is None else 0.9 * self._ema_step_s + 0.1 * dt
        self._last_step_time = now

    @property
    def ema_step_seconds(self) -> Optional[float]:
        return self._ema_step_s

    def _should_timeout_save(self) -> bool:
        if self.timeout_minutes <= 0 or self._timeout_saved or self._ema_step_s is None:
            return False
        remaining = self.timeout_minutes * 60 - (time.monotonic() - self._start_time)
        return remaining < self._ema_step_s + self.SAVE_TIME_MARGIN_S

    def _maybe_checkpoint(self) -> None:
        if self.on_checkpoint is None:
            return
        interval_due = self.checkpoint_interval > 0 and self.step % self.checkpoint_interval == 0
        timeout_due = self._should_timeout_save()
        if interval_due or timeout_due:
            self.on_checkpoint(self.step, timeout_due)
            if timeout_due:
                self._timeout_saved = True

    def __iter__(self):
        while self.step < self.num_steps:
            self.step += 1
            self._update_ema()
            yield self.step
            self._maybe_checkpoint()
        if self.on_checkpoint is not None and self.checkpoint_interval > 0 and self.step % self.checkpoint_interval:
            self.on_checkpoint(self.step, False)

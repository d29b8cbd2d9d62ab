"""Profiler trace capture for any loop (training, datagen, benchmarks).

Counterpart of ``swirlfem_tpu/utils/profiling.py`` on ``torch.profiler``:
`trace(logdir)` records what runs inside it; `PeriodicProfile` records a
`num_steps`-step window and repeats it every `every_steps` steps, so that
late regressions (leaks, input stalls, checkpoint hiccups) show up, which
a single start-of-run window would miss.  Each window writes a Chrome
trace (``trace.json``, viewable in Perfetto or ``chrome://tracing``) into
its directory.  The CUDA activity is recorded where a card is present.
The NiLES trainer opens a `PeriodicProfile` where ``config.profile_dir``
is set.  For the per-kernel tables and the device's busy share of a
stepping loop see `niles.profile_datagen` (`profile_steps`,
`StepProfiler`, `device_busy`), whose windows open here
(`start_profiler`).
"""

from __future__ import annotations

import contextlib
import os

import torch


def _activities():
  acts = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    acts.append(torch.profiler.ProfilerActivity.CUDA)
  return acts


def start_profiler():
  """A started ``torch.profiler.profile`` of the host and, where a card is
  present, of its CUDA activity: the one set-up of every profiler window
  here and in `niles.profile_datagen.StepProfiler`."""
  prof = torch.profiler.profile(activities=_activities())
  prof.__enter__()
  return prof


def _start(logdir: str):
  os.makedirs(logdir, exist_ok=True)
  return start_profiler()


def _stop(prof, logdir: str) -> str:
  prof.__exit__(None, None, None)
  path = os.path.join(logdir, 'trace.json')
  prof.export_chrome_trace(path)
  return path


@contextlib.contextmanager
def trace(logdir: str):
  """Records a profiler trace of the body into ``logdir/trace.json``."""
  prof = _start(logdir)
  try:
    yield prof
  finally:
    _stop(prof, logdir)


class PeriodicProfile:
  """Repeatedly captures `num_steps`-step profiler trace windows.

  The first window covers steps ``[start_step, start_step + num_steps)``;
  later windows repeat every `every_steps` steps (0: one window only).
  Each window lands in its own ``step_<N>`` subdirectory.  Call the object
  with the step number at the top of every step, and `close` after the
  loop.
  """

  def __init__(self, logdir: str, start_step: int = 10,
               num_steps: int = 5, every_steps: int = 1000):
    self.logdir = logdir
    self.start = start_step
    self.num_steps = num_steps
    self.every = every_steps
    self._stop_at = -1
    self._active = None
    self.paths: list[str] = []

  def _should_start(self, step: int) -> bool:
    if step < self.start:
      return False
    if step == self.start:
      return True
    return self.every > 0 and (step - self.start) % self.every == 0

  def __call__(self, step: int) -> None:
    if self._active is not None and step >= self._stop_at:
      self.close()
    if self._active is None and self.logdir and self._should_start(step):
      window = os.path.join(self.logdir, f'step_{step}')
      self._active = (_start(window), window)
      self._stop_at = step + self.num_steps

  def close(self) -> None:
    """Stops an in-flight window and writes its trace (a run whose last
    step lands inside a window would otherwise leave it unwritten)."""
    if self._active is not None:
      prof, window = self._active
      self.paths.append(_stop(prof, window))
      self._active = None

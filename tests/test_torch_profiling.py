"""The port's profiler helpers (`utils.profiling`) write traces on the CPU:
`trace` one window, `PeriodicProfile` its windows at the JAX package's
step schedule (``swirlfem_tpu/utils/profiling.py:46-52``)."""

import json
import os

import torch

from swirlfem_tpu.utils.profiling import PeriodicProfile as JPeriodicProfile
from swirlfem_tpu_torch.utils import profiling
import torch_port_threads  # noqa: F401  pylint: disable=unused-import


def test_trace_writes_a_chrome_trace(tmp_path):
  logdir = str(tmp_path / 'trace')
  with profiling.trace(logdir):
    torch.matmul(torch.ones(32, 32), torch.ones(32, 32)).sum()
  with open(os.path.join(logdir, 'trace.json'), encoding='utf-8') as f:
    events = json.load(f)['traceEvents']
  assert any('matmul' in e.get('name', '') for e in events)


def test_periodic_windows_follow_the_jax_schedule(tmp_path):
  logdir = str(tmp_path / 'periodic')
  prof = profiling.PeriodicProfile(logdir, start_step=2, num_steps=2,
                                   every_steps=3)
  jprof = JPeriodicProfile(logdir, start_step=2, num_steps=2, every_steps=3)
  starts = [s for s in range(12) if jprof._should_start(s)]  # pylint: disable=protected-access
  for step in range(12):
    prof(step)
    torch.ones(8).add_(1.0)
  prof.close()
  assert starts == [2, 5, 8, 11]
  assert prof.paths == [os.path.join(logdir, f'step_{s}', 'trace.json')
                        for s in starts]
  assert all(os.path.getsize(p) > 0 for p in prof.paths)
  prof.close()  # closing again is a no-op


def test_no_logdir_no_windows():
  prof = profiling.PeriodicProfile('', start_step=0, num_steps=1)
  for step in range(3):
    prof(step)
  prof.close()
  assert not prof.paths

"""Profiles the el datagen step on a CUDA device.

At the reference config, times 20 steps with CUDA events (no profiler),
then records 20 more under `torch.profiler` and prints the device kernels by
self time, the kernel launches per step and the device's busy share of the
profiled wall time.  Run from the repository root on a GPU host:

    python -m swirlfem_tpu_torch.niles.profile_datagen [--certified]
"""

from __future__ import annotations

import argparse
import time

import torch

from swirlfem_tpu_torch.niles import datagen


def _self_device_us(evt) -> float:
  return float(getattr(evt, 'self_device_time_total', None)
               or getattr(evt, 'self_cuda_time_total', 0.0))


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--certified', action='store_true',
                      help='FDM-seeded viscous CG instead of exact solves')
  args = parser.parse_args(argv)
  steps, warmup, rows = 20, 50, 25

  device = torch.device('cuda', 0)
  cfg = datagen.DatagenConfig()
  sem = datagen.build_solver(cfg, device=device, dtype=torch.float32)
  step = datagen.make_one_step(sem, cfg, exact_solves=not args.certified)
  state = datagen.initial_state(sem, cfg)

  def run(count, state):
    us, ps, cus = state
    for _ in range(count):
      u, p, cu, _ = step(us, ps, cus)
      us, ps, cus = us[1:] + (u,), ps[1:] + (p,), cus[1:] + (cu,)
    return us, ps, cus

  state = run(warmup, state)
  torch.cuda.synchronize(device)
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  t0 = time.perf_counter()
  start.record()
  state = run(steps, state)
  end.record()
  torch.cuda.synchronize(device)
  host_ms = (time.perf_counter() - t0) / steps * 1e3
  print(f'{cfg.resolution}x{cfg.resolution} order {cfg.order}, '
        f'{"certified" if args.certified else "exact"} solves: '
        f'{start.elapsed_time(end) / steps:.4f} ms/step (CUDA events), '
        f'{host_ms:.4f} ms/step (host clock)')

  profile_steps(lambda: run(steps, state), steps, device, rows=rows)


def profile_steps(run, steps: int, device, rows: int = 25) -> dict | None:
  """Runs `run` (which advances `steps` steps) under `torch.profiler`.

  Prints the device kernels by self time, the kernel launches per step and
  the device's busy share of the profiled wall time, and returns those
  numbers (None when the profiler saw no device kernel).
  """
  window = StepProfiler(steps, device, rows)
  window.start()
  run()
  return window.stop()


class StepProfiler:
  """`profile_steps` over a window that a running loop opens (`start`) and
  closes (`stop`, which returns the numbers) at its own step boundaries."""

  def __init__(self, steps: int, device, rows: int = 25):
    self.steps, self.device, self.rows = steps, device, rows
    self._prof = self._t0 = None

  def start(self) -> None:
    self._prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
    self._prof.__enter__()
    self._t0 = time.perf_counter()

  def stop(self) -> dict | None:
    torch.cuda.synchronize(self.device)
    wall_us = (time.perf_counter() - self._t0) * 1e6
    self._prof.__exit__(None, None, None)
    steps, rows = self.steps, self.rows
    kernels = [e for e in self._prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _self_device_us(e) > 0]
    if not kernels:
      print('device kernel time: not measured (the profiler saw no kernels)')
      return None
    busy_us = sum(_self_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f'profiled {steps} steps: wall {wall_us / 1e3:.3f} ms, device '
          f'busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), '
          f'{launches / steps:.1f} kernel launches/step, '
          f'{busy_us / launches:.2f} us/kernel on average')
    kernels.sort(key=_self_device_us, reverse=True)
    print(f'{"self device us/step":>20} {"share":>6} {"calls/step":>10}  '
          f'kernel')
    for e in kernels[:rows]:
      print(f'{_self_device_us(e) / steps:20.2f} '
            f'{100 * _self_device_us(e) / busy_us:5.1f}% '
            f'{e.count / steps:10.1f}  {e.key[:110]}')
    return {'wall_ms_per_step': wall_us / 1e3 / steps,
            'busy_ms_per_step': busy_us / 1e3 / steps,
            'busy_share': busy_us / wall_us,
            'launches_per_step': launches / steps,
            'by_kernel_us_per_step': {e.key: _self_device_us(e) / steps
                                      for e in kernels[:rows]}}


def device_busy(run, device) -> dict | None:
  """The device's busy time while `run` runs, under `torch.profiler` with
  the CUDA activity alone, summed from the raw trace's device events.

  For runs of very many launches (a NiLES train step makes ~500k): the
  per-op tables of `profile_steps` take minutes to build there.  Returns
  the wall and busy ms, their ratio and the device events counted (kernels
  and copies), or None when the profiler saw no device event.
  """
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize(device)
    wall_ns = (time.perf_counter() - t0) * 1e9
  events = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]
  if not events:
    return None
  busy_ns = sum(e.duration_ns() for e in events)
  return {'wall_ms': wall_ns / 1e6, 'busy_ms': busy_ns / 1e6,
          'busy_share': busy_ns / wall_ns, 'device_events': len(events)}


if __name__ == '__main__':
  main()

"""How much a kernel's time depends on where its fields lie in device memory.

Times the general FP32 3D stiffness (``csrc/stiffness3d_general.cu``, row 7
of ``PERF.md`` section 6) at the Taylor-Green shape (16^3 elements, order
7, C = 3, random fields and D, float32) with CUDA events
(``kernel_checks.time_ms``), after allocating and keeping 0, 2, 4, ...
MB more padding each run, so that each run's fields start at other
addresses.
The kernel is the same in every run; the spread is the placement's.  Then
the nine fields carved from one buffer at shifts of 0 to 1.5 MB between
them, and the same call timed before and after a ``torch.profiler``
session in the process.  Run
from the root of a checkout on a GPU host, or with ``--tree DIR`` to time
another unpacked tree's kernel (one tree a process: two libraries with the
same kernel symbols in one process fail at launch):

    python tests/torch_port_placement_timing.py [--tree DIR]
"""

import argparse
import pathlib
import subprocess
import sys

import numpy as np
import torch

_ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
  parser = argparse.ArgumentParser()
  parser.add_argument('--tree', type=pathlib.Path, default=_ROOT,
                      help='the checkout whose kernels to time')
  args = parser.parse_args()
  if not torch.cuda.is_available():
    print('needs a CUDA device')
    return 1
  sys.path.insert(0, str(args.tree.resolve()))
  from swirlfem_tpu_torch.ops import cuda_stiffness3d  # pylint: disable=import-outside-toplevel
  from swirlfem_tpu_torch.ops import kernel_checks  # pylint: disable=import-outside-toplevel
  dev = torch.device('cuda', 0)
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=False).stdout.strip())
  k, num_e = 8, 16 ** 3
  rng = np.random.default_rng(0)
  dmat = torch.as_tensor(rng.standard_normal((k, k)), dtype=torch.float32,
                         device=dev)
  times, pads = [], []
  for pad_mb in range(0, 18, 2):
    # The padding stays allocated and the cache is emptied, so that each
    # run's fields come from fresh allocations past it.
    pads.append(torch.empty(pad_mb * 2 ** 18, dtype=torch.float32,
                            device=dev))
    fields = [kernel_checks.random_field((k, k, k, num_e), dtype=torch.float32,
                                         device=dev, seed=s) for s in range(9)]
    us, gs = tuple(fields[:3]), tuple(fields[3:])
    t = kernel_checks.time_ms(
        lambda: cuda_stiffness3d.stiffness3d_general(us, gs, dmat),
        device=dev) * 1e3
    times.append(t)
    print(f'{args.tree.name or "."}: padding {pad_mb:2d} MB, fields at '
          f'{fields[0].data_ptr() % 2 ** 30:#012x}: stiffness3d_general '
          f'{t:.2f} us', flush=True)
    del fields, us, gs
    torch.cuda.empty_cache()
  print(f'{args.tree.name or "."}: min {min(times):.2f}, median '
        f'{float(np.median(times)):.2f}, max {max(times):.2f} us')
  # The nine fields carved from one buffer, each `shift` bytes past the end
  # of the one before (chip_smoke.py's fields come from the allocator's
  # cached segments, at such offsets).
  field_values = k ** 3 * num_e
  for shift in (0, 512, 4096, 2 ** 15, 2 ** 16, 2 ** 20, 3 * 2 ** 19):
    stride = field_values + shift // 4
    buf = torch.empty(9 * stride, dtype=torch.float32, device=dev)
    carved = [buf[i * stride:i * stride + field_values].view(k, k, k, num_e)
              for i in range(9)]
    for i, f in enumerate(carved):
      f.copy_(kernel_checks.random_field((k, k, k, num_e), dtype=torch.float32,
                                         device=dev, seed=i))
    t = kernel_checks.time_ms(
        lambda: cuda_stiffness3d.stiffness3d_general(
            tuple(carved[:3]), tuple(carved[3:]), dmat), device=dev) * 1e3
    print(f'{args.tree.name or "."}: fields {shift} bytes apart in one '
          f'buffer: stiffness3d_general {t:.2f} us', flush=True)
    del buf, carved
    torch.cuda.empty_cache()
  # The same fields timed before and after a torch.profiler session in the
  # process (chip_smoke.py opens one in phase 7, before phase 12 times
  # this kernel).
  fields = [kernel_checks.random_field((k, k, k, num_e), dtype=torch.float32,
                                       device=dev, seed=s) for s in range(9)]
  call = lambda: cuda_stiffness3d.stiffness3d_general(
      tuple(fields[:3]), tuple(fields[3:]), dmat)
  before = kernel_checks.time_ms(call, device=dev) * 1e3
  traced = kernel_checks.kernel_us(call, 'stiffness3d_general_kernel',
                                   device=dev)
  after = kernel_checks.time_ms(call, device=dev) * 1e3
  print(f'{args.tree.name or "."}: before a profiler session {before:.2f} '
        f'us, the profiler\'s duration {traced} us, after it {after:.2f} us')
  return 0


if __name__ == '__main__':
  sys.exit(main())

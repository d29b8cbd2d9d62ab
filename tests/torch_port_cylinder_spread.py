"""Run-to-run spread of the cylinder comparisons of `chip_smoke.py` phases
34 and 35 on a CUDA card.

The pressure carries float32 rounding through the Schur operator's
conditioning, so a difference in the order of any sum shows in it.  With
scatters that add in no fixed order (``index_add_`` on CUDA), repeated runs
of the same code read different errors; the scatters now add in a fixed
order (`topology.ScatterTable`), and repeated runs should read one value.
This script repeats each comparison to measure that spread (the gates of
the two phases sit about 3x above the largest readings):

- ``--phase 35``: 20 steps of the small cylinder (122 elements, order 3)
  on the card in float32 against the CPU in float64, on the generic and the
  E-last path, six runs each with the card's default algorithms and six
  with `torch.use_deterministic_algorithms(True)`, then the CPU in float32;
- ``--phase 34``: the default cylinder (228 elements, order 5), 410 steps
  of the E-last and the generic path with the same solves (no history),
  five runs of each, every E-last run against every generic run.

Run from the repository root on a GPU host::

    python tests/torch_port_cylinder_spread.py --phase 35
    python tests/torch_port_cylinder_spread.py --phase 34
"""

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from swirlfem_tpu_torch.examples import cylinder as cyl  # pylint: disable=wrong-import-position

SMALL = dict(ns=4, nr=3, nx_down=10)


def rel(a, b) -> float:
  a, b = a.double().cpu(), b.double().cpu()
  return float((a - b).abs().max() / b.abs().max())


def phase35(device) -> None:
  for name, kw, ekw in (('generic', {}, {}),
                        ('el', dict(use_projection=False),
                         dict(unstructured_el_ops=True))):
    cpu = cyl.make_cylinder_sem(3, **SMALL, device='cpu',
                                dtype=torch.float64, **ekw)
    card = cyl.make_cylinder_sem(3, **SMALL, device=device,
                                 dtype=torch.float32, **ekw)

    def run(sem, kw=kw):
      return cyl.run_cylinder_scan(sem, dt=5e-4, num_steps=20,
                                   steps_per_dispatch=10, kick_steps=10,
                                   tol=1e-6, **kw)

    ref = run(cpu)
    for det in (False, True):
      torch.use_deterministic_algorithms(det)
      for rep in range(6):
        t0 = time.perf_counter()
        out = run(card)
        dp = out[1].double().cpu() - ref[1]
        dp = dp - dp.mean()
        print(f'{name} deterministic={det} rep {rep}: u rel '
              f'{rel(out[0], ref[0]):.3e} p rel {rel(out[1], ref[1]):.3e} '
              f'p rel without the mean offset '
              f'{float(dp.abs().max() / ref[1].abs().max()):.3e} '
              f'({time.perf_counter() - t0:.2f} s)', flush=True)
    torch.use_deterministic_algorithms(False)
    out = run(cyl.make_cylinder_sem(3, **SMALL, device='cpu',
                                    dtype=torch.float32, **ekw))
    print(f'{name} CPU float32: u rel {rel(out[0], ref[0]):.3e} p rel '
          f'{rel(out[1], ref[1]):.3e}', flush=True)


def phase34(device, reps: int = 5) -> None:
  dt = 2.5e-4
  sem = cyl.make_cylinder_sem(device=device, dtype=torch.float32)
  sem_el = cyl.make_cylinder_sem(device=device, dtype=torch.float32,
                                 unstructured_el_ops=True)
  pre = sem.dense_pressure_preconditioner(dt, 2)
  outs = {'el': [], 'generic': []}
  for rep in range(reps):
    t0 = time.perf_counter()
    for name, s in (('el', sem_el), ('generic', sem)):
      outs[name].append(cyl.run_cylinder_scan(
          s, dt=dt, num_steps=410, steps_per_dispatch=10,
          compute_forces=True, pressure_preconditioner=pre,
          use_projection=False)[:2])
    e, g = outs['el'][-1], outs['generic'][-1]
    e0, g0 = outs['el'][0], outs['generic'][0]
    print(f'rep {rep}: el vs generic u rel {rel(e[0], g[0]):.3e} p rel '
          f'{rel(e[1], g[1]):.3e}; el vs el rep 0 u {rel(e[0], e0[0]):.3e} '
          f'p {rel(e[1], e0[1]):.3e}; generic vs rep 0 u '
          f'{rel(g[0], g0[0]):.3e} p {rel(g[1], g0[1]):.3e} '
          f'({time.perf_counter() - t0:.1f} s)', flush=True)
  for i in range(reps):
    print('el', i, 'vs generic', ' '.join(
        f'{rel(outs["el"][i][1], outs["generic"][j][1]):.2e}'
        for j in range(reps)))


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--phase', type=int, choices=(34, 35), required=True)
  args = parser.parse_args()
  print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, check=True).stdout.strip())
  device = torch.device('cuda')
  (phase34 if args.phase == 34 else phase35)(device)


if __name__ == '__main__':
  main()

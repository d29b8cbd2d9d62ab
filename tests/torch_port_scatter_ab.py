"""Phases 33-34 of `chip_smoke.py` in two trees, in turns, on one CUDA card.

Measures what a change to the unstructured path's scatters costs a cylinder
step: for each ``--tree`` in the order given (for a parent ``_parent`` and
the change ``.``: parent, change, change, parent), runs that tree's own
``chip_smoke.run_cylinder_phases`` (phases 32-35: the default cylinder, 228
elements, order 5, 410 steps on the generic path with the Fischer history,
on the E-last path and on the generic path without it) in a process of its
own from the tree's root, and prints each run's ms/step (host clock over
steps 11-400) and launches a step with the device's busy share (profiler
over steps 401-410), then one JSON line of every run.

Run from the repository root on a GPU host, with the parent unpacked into an
ignored directory (``git archive <parent> | tar -x -C _parent``)::

    python tests/torch_port_scatter_ab.py --tree _parent --tree . \\
        --tree . --tree _parent
"""

import argparse
import json
import os
import re
import subprocess
import sys

CODE = """
import sys
import torch
sys.path.insert(0, '.')
import chip_smoke
from swirlfem_tpu_torch.ops import cuda_build, kernel_checks
cuda_build.library()
chip_smoke.run_cylinder_phases(torch, torch.device('cuda', 0), kernel_checks,
                               {'stiffness2d_general': {}}, {})
"""

STEP = re.compile(r'\[3[34]\] cylinder (generic, no history|generic|el): '
                  r'\d+ steps, ([\d.]+) ms/step')
PROFILE = re.compile(r'\[33/34\] cylinder (generic|el): ([\d.]+) launches a '
                     r'step, device busy ([\d.]+) %')


def run_tree(tree: str) -> dict:
  proc = subprocess.run([sys.executable, '-c', CODE], cwd=tree,
                        capture_output=True, text=True, check=False)
  reading = {'tree': tree, 'rc': proc.returncode}
  for line in proc.stdout.splitlines():
    if STEP.search(line) or PROFILE.search(line) or '[34] E-last vs' in line:
      print(f'{tree}: {line.strip()}', flush=True)
    if m := STEP.search(line):
      reading[f'{m.group(1)} ms_per_step'] = float(m.group(2))
    if m := PROFILE.search(line):
      reading[f'{m.group(1)} launches_per_step'] = float(m.group(2))
      reading[f'{m.group(1)} busy_percent'] = float(m.group(3))
  if proc.returncode:
    print(proc.stderr[-3000:], flush=True)
  return reading


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--tree', action='append', required=True,
                      help='a checkout to run (repeat, in the order wanted)')
  args = parser.parse_args()
  print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, check=True).stdout.strip(), flush=True)
  readings = [run_tree(os.path.abspath(tree)) for tree in args.tree]
  print(json.dumps(readings))


if __name__ == '__main__':
  main()

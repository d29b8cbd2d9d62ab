"""Runs `chip_smoke.py`'s training phases alone on a GPU host: 29-31 and 45.

Builds the kernels, runs one 500-step datagen cycle at the reference
configuration (phase 4's), then phases 29-30 (rows 1 and 2 at the training
shapes, batched too; training at the config's batch of 128 on three
cycles' frames), phase 31 (the tiny train step, card against the CPU) and
phase 45 (4 data-parallel ranks sharing the card against the single
process), with `chip_smoke.py`'s gates.  From the root of the checkout:

    python tests/torch_port_training_phases.py [--out train.json]

`--out` writes phase 30's and 45's numbers as JSON.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

import torch  # noqa: E402  pylint: disable=wrong-import-position

import chip_smoke  # noqa: E402  pylint: disable=wrong-import-position
from swirlfem_tpu_torch.niles import datagen  # noqa: E402  pylint: disable=wrong-import-position
from swirlfem_tpu_torch.ops import cuda_build  # noqa: E402  pylint: disable=wrong-import-position
from swirlfem_tpu_torch.ops import kernel_checks  # noqa: E402  pylint: disable=wrong-import-position


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--out', default=None)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    print('no CUDA device', file=sys.stderr)
    return 1
  device = torch.device('cuda', 0)
  smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, check=True).stdout.strip()
  chip_smoke.log(f'card: {smi}; torch {torch.__version__}')
  cuda_build.library()
  cfg = datagen.DatagenConfig(num_cycles=1)
  frames = []
  walls, sem, state = datagen.run_simulation(None, cfg, device=device,
                                             dtype=torch.float32,
                                             frames_out=frames)
  chip_smoke.log(f'datagen cycle {walls[0]:.2f} s')
  dgen = {'sem': sem, 'cfg': cfg, 'state': state}
  t0 = time.perf_counter()
  training = chip_smoke.run_training_phases(torch, device, kernel_checks,
                                            frames, dgen)
  chip_smoke.run_tiny_train_phase(torch, device)
  dp = chip_smoke.run_data_parallel_phase(torch, device, training)
  chip_smoke.log(f'phases 29-31 and 45: {time.perf_counter() - t0:.1f} s')
  if args.out:
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w', encoding='utf-8') as f:
      json.dump({'card': smi, 'dp': dp, **{
          k: v for k, v in training.items() if k != 'les'}}, f, default=str)
  return 0


if __name__ == '__main__':
  sys.exit(main())

"""NiLES training command line.

Counterpart of ``swirlfem_tpu/niles/main.py`` on `argparse`: runs
`train.train_and_evaluate` with the configuration of `niles.config`
(or of ``--config FILE``, a Python file defining ``get_config()``), each
``--set key=value`` applied on top (dotted keys, Python literals)::

  python -m swirlfem_tpu_torch.niles.main --workdir runs/kolmogorov \\
      --set dataset_dir=data/les --set batch_size=16

``--ranks R`` trains data-parallel on R ranks, one process each
(`parallel.spmd.launch`): rank r runs on ``cuda:r`` where there are R
cards and on ``cuda:0`` where there are fewer (the ranks then share the
card, and every collective crosses host memory: that measures the layer,
not a multi-GPU speed), or on the CPU with ``--device cpu``.  R must
divide the config's batch size.
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import logging

import torch

from swirlfem_tpu_torch.niles import config as niles_config
from swirlfem_tpu_torch.niles import train

# Seconds that one collective, and the whole run, may take with --ranks.
RANK_TIMEOUT = 7 * 86400.0


def load_config(path: str | None, overrides=()):
  """The config of `path` (or the default), with ``key=value`` overrides."""
  if path:
    spec = importlib.util.spec_from_file_location('niles_user_config', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    cfg = module.get_config()
  else:
    cfg = niles_config.get_config()
  fields = {}
  for item in overrides:
    key, _, text = item.partition('=')
    try:
      fields[key] = ast.literal_eval(text)
    except (ValueError, SyntaxError):
      fields[key] = text
  return niles_config.set_fields(cfg, fields)


def rank_devices(device: str, ranks: int) -> list[str]:
  """Each rank's device: ``cuda:r`` where there are `ranks` cards, else
  ``cuda:0`` for all (`device` 'cuda'); `device` itself otherwise."""
  if device != 'cuda':
    return [device] * ranks
  if torch.cuda.device_count() >= ranks:
    return [f'cuda:{r}' for r in range(ranks)]
  return ['cuda:0'] * ranks


def main(argv=None):
  """Parses `argv` and trains; returns the final TrainState (one rank) or
  each rank's `train.rank_train_and_evaluate` result (``--ranks``)."""
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--workdir', required=True,
                      help='Directory for checkpoints and metrics.jsonl.')
  parser.add_argument('--config', default=None,
                      help='Python file defining get_config().')
  parser.add_argument('--set', action='append', default=[],
                      metavar='KEY=VALUE', help='Config override.')
  parser.add_argument('--device', default='cuda')
  parser.add_argument('--ranks', type=int, default=1,
                      help='Data-parallel ranks, one process each.')
  args = parser.parse_args(argv)
  logging.basicConfig(level=logging.INFO)
  if args.device.startswith('cuda') and not torch.cuda.is_available():
    parser.error(f'--device {args.device}: no CUDA device here; pass '
                 '--device cpu to train on the CPU')
  config = load_config(args.config, args.set)
  if args.ranks == 1:
    return train.train_and_evaluate(config, args.workdir, device=args.device)
  if config.batch_size % args.ranks:
    parser.error(f'--ranks {args.ranks} must divide the batch size '
                 f'{config.batch_size}')
  from swirlfem_tpu_torch.parallel import spmd
  if args.device.startswith('cuda'):
    from swirlfem_tpu_torch.ops import cuda_build
    cuda_build.library()  # built once here, not by every rank
  return spmd.launch(train.rank_train_and_evaluate,
                     rank_devices(args.device, args.ranks),
                     timeout=RANK_TIMEOUT, config=config,
                     workdir=args.workdir)


if __name__ == '__main__':
  main()

"""NiLES training command line.

Counterpart of ``swirlfem_tpu/niles/main.py`` on `argparse`: runs
`train.train_and_evaluate` with the configuration of `niles.config`
(or of ``--config FILE``, a Python file defining ``get_config()``), each
``--set key=value`` applied on top (dotted keys, Python literals)::

  python -m swirlfem_tpu_torch.niles.main --workdir runs/kolmogorov \\
      --set dataset_dir=data/les --set batch_size=16
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import logging

from swirlfem_tpu_torch.niles import config as niles_config
from swirlfem_tpu_torch.niles import train


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


def main(argv=None) -> train.TrainState:
  """Parses `argv` and trains; returns the final TrainState."""
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--workdir', required=True,
                      help='Directory for checkpoints and metrics.jsonl.')
  parser.add_argument('--config', default=None,
                      help='Python file defining get_config().')
  parser.add_argument('--set', action='append', default=[],
                      metavar='KEY=VALUE', help='Config override.')
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  logging.basicConfig(level=logging.INFO)
  return train.train_and_evaluate(load_config(args.config, args.set),
                                  args.workdir, device=args.device)


if __name__ == '__main__':
  main()

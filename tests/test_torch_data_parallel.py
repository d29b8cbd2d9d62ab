"""Data-parallel NiLES training over ranks, on the CPU.

The counterpart of the JAX trainer's ``('batch',)`` mesh
(``tests/test_niles.py:448-511`` holds two sharded train steps against the
single-device ones): 2 ranks through `parallel.spmd.launch`, each on its
rows of a global batch of 4 with its rows of the global draws, for 2 train
steps of the tiny configuration with the solver and the model in float64,
against the single-process trainer on the whole batch: the losses within
1e-12 relative, the parameters within 1e-10 of their scale, and bitwise
equal on both ranks (one psum of the gradients a step, added in rank
order).  Also `niles.main --ranks 2` on the debug split: both ranks end on
the same parameters, and rank 0 alone writes the metrics and checkpoints.
"""

import json
import os

import numpy as np
import torch

from swirlfem_tpu_torch.niles import config as niles_config
from swirlfem_tpu_torch.niles import input_pipeline
from swirlfem_tpu_torch.niles import main as niles_main
from swirlfem_tpu_torch.niles import train
from swirlfem_tpu_torch.parallel import spmd

import torch_port_ranks
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

SEED, LR, STEPS = 5, 1e-2, 2


def _config():
  cfg = niles_config.set_fields(niles_config.get_config(), {
      **niles_config.tiny_fields(), 'model.dtype': 'float32',
      'batch_size': 4})
  return cfg


def _single_process(cfg, batch):
  torch.manual_seed(SEED)
  model = train.create_model(cfg).double()
  state = train.create_train_state(model, cfg)
  sem = train.build_solver(cfg, device='cpu', dtype=torch.float64)
  preconds = train.make_solver_preconds(sem, cfg)
  tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
  kl_fn = train.create_kl_penalty_fn(cfg, 100)
  losses = []
  for step in range(STEPS):
    state, metrics, _ = train.train_step(
        state, tbatch, train.make_draws_fn(model, cfg.batch_size, SEED, step,
                                           'cpu'),
        lambda _: LR, kl_fn, sem, cfg, preconds)
    losses.append(float(metrics['loss']))
  return np.asarray(losses), torch.cat(
      [p.detach().reshape(-1) for p in model.parameters()]).numpy()


def test_data_parallel_steps_match_the_single_process_trainer():
  cfg = _config()
  batch = next(input_pipeline.create_split(cfg.batch_size, True, cfg,
                                           prefetch=0))
  batch = {k: np.asarray(v, np.float64) for k, v in batch.items()}
  ranks = torch_port_ranks.in_background(
      spmd.launch, torch_port_ranks.data_parallel_train, [None, None],
      timeout=240.0, config=cfg, batch=batch, steps=STEPS, seed=SEED, lr=LR)
  want_losses, want_params = _single_process(cfg, batch)
  outs = ranks.result()
  for out in outs:
    assert out['no_jax']
    np.testing.assert_allclose(out['losses'], want_losses, rtol=1e-12,
                               atol=0)
    scale = np.abs(want_params).max()
    assert np.abs(out['params'] - want_params).max() <= 1e-10 * scale
    # One psum of the gradients and one all_gather of the metrics a step.
    assert out['stats']['collectives'] == 2 * STEPS
  assert np.array_equal(outs[0]['params'], outs[1]['params'])
  assert not np.array_equal(outs[0]['params'], want_params)


def test_main_trains_on_two_ranks(tmp_path, monkeypatch):
  """``--ranks 2 --device cpu`` at the tiny config (its own bfloat16
  model, batch 2: one sample a rank): two steps, each followed by one
  eval; the ranks end bitwise equal; one metrics line a step and one
  checkpoint, from rank 0."""
  workdir = str(tmp_path / 'run')
  fields = {**niles_config.tiny_fields(), 'num_train_steps': 2,
            'log_every_steps': 1, 'eval_every_epochs': 0.0,
            'steps_per_eval': 1}
  argv = ['--workdir', workdir, '--device', 'cpu', '--ranks', '2']
  monkeypatch.setattr(niles_main, 'RANK_TIMEOUT', 240.0)
  for key, value in fields.items():
    argv += ['--set', f'{key}={value!r}']
  outs = niles_main.main(argv)
  assert [o['step'] for o in outs] == [2, 2]
  assert np.array_equal(outs[0]['params'], outs[1]['params'])
  with open(os.path.join(workdir, 'metrics.jsonl'), encoding='utf-8') as f:
    lines = [json.loads(line) for line in f]
  assert [x['step'] for x in lines if 'train_loss' in x] == [1, 2]
  assert [x['step'] for x in lines if 'eval_mse' in x] == [1, 2]
  assert all(np.isfinite(v) for x in lines for v in x.values())
  assert os.listdir(os.path.join(workdir, 'checkpoints')) == ['ckpt_2.pt']

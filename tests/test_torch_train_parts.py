"""Parts of the port's NiLES trainer, at the tiny configuration.

`remat` (``torch.utils.checkpoint`` of each rollout step) against no remat:
loss and every gradient equal to 1e-12 relative; the no-model eval
baseline independent of the parameters; the spectrum loss's uniform-grid
transfer, TKE fields and log-spectrum error against the JAX functions
(1e-10 relative, float64), and the spectrum term entering the training
loss.  The command line (`niles.main`) trains two steps on the debug
split, writes its metrics and checkpoint, and a second run resumes from
that checkpoint and takes no more steps.  The port's tiny fields are the
JAX package's test configuration.
"""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from swirlfem_tpu.niles import train as jtrain
from swirlfem_tpu.nse.solver import StokesSEM as JStokesSEM
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch.niles import config as niles_config
from swirlfem_tpu_torch.niles import input_pipeline
from swirlfem_tpu_torch.niles import main as niles_main
from swirlfem_tpu_torch.niles import train

from test_niles import tiny_config as jax_tests_tiny_config
from torch_niles_configs import jax_tiny_config, torch_tiny_config
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

F32 = {'model.dtype': 'float32'}


@functools.lru_cache(maxsize=None)
def _setup():
  cfg = torch_tiny_config(**F32)
  torch.manual_seed(0)
  model = train.create_model(cfg)
  with torch.no_grad():  # signal through the zero-initialised heads
    for p in model.parameters():
      p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(p.numel())))
  sem = train.build_solver(cfg, device='cpu', dtype=torch.float64)
  batch = next(input_pipeline.create_split(cfg.batch_size, True, cfg,
                                           prefetch=0))
  batch = {k: torch.tensor(v, dtype=torch.float64) for k, v in batch.items()}
  return cfg, model, sem, batch


def _draws(model, batch_size):
  return train.make_draws_fn(model, batch_size, seed=0, step=0, device='cpu')


def _loss_and_grads(cfg, model, sem, batch, to_grid=None):
  loss, aux = train.compute_mse_loss(
      batch, lambda x, d: model(x, draws=d), _draws(model, cfg.batch_size),
      1e-3, sem, to_grid, cfg, train=True,
      preconds=train.make_solver_preconds(sem, cfg))
  grads = torch.autograd.grad(loss, list(model.parameters()),
                              allow_unused=True)
  return loss, aux, grads


def test_remat_matches_no_remat():
  cfg, model, sem, batch = _setup()
  l0, _, g0 = _loss_and_grads(cfg, model, sem, batch)
  cfg_r = torch_tiny_config(remat=True, **F32)
  l1, _, g1 = _loss_and_grads(cfg_r, model, sem, batch)
  assert abs(float(l1) - float(l0)) <= 1e-12 * abs(float(l0))
  nonzero = 0
  for a, b in zip(g0, g1):
    assert (a is None) == (b is None)
    if a is not None:
      assert torch.allclose(a, b, rtol=1e-12, atol=1e-12 * float(
          a.abs().max()))
      nonzero += bool(a.abs().max() > 0)
  assert nonzero > 10


def test_eval_baseline_is_independent_of_the_model():
  cfg, model, sem, batch = _setup()
  cfg_b = torch_tiny_config(eval_baseline=True, **F32)
  state = train.create_train_state(model, cfg_b)
  kl_fn = train.create_kl_penalty_fn(cfg_b, 100)
  preconds = train.make_solver_preconds(sem, cfg_b)
  m = train.metrics_to_host(train.eval_step(
      state, batch, _draws(model, cfg.batch_size), kl_fn, sem, None, cfg_b,
      preconds))
  assert np.isfinite(m['mse_baseline']) and 'mse_baseline@1to8' in m
  saved = {k: v.clone() for k, v in model.state_dict().items()}
  with torch.no_grad():
    for p in model.parameters():
      p.add_(0.03)
  m2 = train.metrics_to_host(train.eval_step(
      state, batch, _draws(model, cfg.batch_size), kl_fn, sem, None, cfg_b,
      preconds))
  model.load_state_dict(saved)
  assert m2['mse_baseline'] == m['mse_baseline']
  assert m2['mse'] != m['mse']


def test_spectrum_transfer_and_tke_match_jax():
  cfg = torch_tiny_config(**F32)
  jcfg = jax_tiny_config(**F32)
  _, _, sem, _ = _setup()
  jsem = JStokesSEM.create(
      junit_cube_mesh(jcfg.element_grid_size, periodic_dims=(0, 1)),
      boundary_conditions={}, order=jcfg.order)
  to_grid = train.make_uniform_transfer(sem, cfg)
  jto_grid = jtrain.make_uniform_transfer(jsem, jcfg)
  rng = np.random.default_rng(4)
  u = rng.standard_normal((2, cfg.num_nodes, 2))
  grid = to_grid(torch.tensor(u[0]))
  want = np.asarray(jto_grid(jnp.asarray(u[0])))
  assert grid.shape == want.shape == (8, 8, 2)
  np.testing.assert_allclose(grid.numpy(), want, rtol=0,
                             atol=1e-12 * np.abs(want).max())
  tke = torch.stack([train.get_tke(torch.tensor(x), to_grid) for x in u])
  jtke = np.stack([np.asarray(jtrain.get_tke(jnp.asarray(x), jto_grid))
                   for x in u])
  np.testing.assert_allclose(tke.numpy(), jtke, rtol=1e-10)
  err = train.log_spectrum_error(tke[:1], tke[1:])
  jerr = jtrain.log_spectrum_error(jnp.asarray(jtke[:1]),
                                   jnp.asarray(jtke[1:]))
  np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=1e-10)


def test_spectrum_loss_enters_the_training_loss():
  cfg, model, sem, batch = _setup()
  cfg_s = torch_tiny_config(spectrum_loss_weight=0.1, **F32)
  to_grid = train.make_uniform_transfer(sem, cfg_s)
  l0, a0, _ = _loss_and_grads(cfg, model, sem, batch)
  l1, a1, g1 = _loss_and_grads(cfg_s, model, sem, batch, to_grid)
  assert float(a1['spec_err']) > 0
  assert torch.allclose(a1['mse'], a0['mse'], rtol=1e-12)
  assert abs(float(l1) - float(l0)) > 1e-8
  assert all(g is None or torch.isfinite(g).all() for g in g1)


def test_tiny_fields_are_the_jax_tests_config():
  want = jax_tests_tiny_config()
  for key, value in niles_config.tiny_fields().items():
    target = want
    for name in key.split('.'):
      target = getattr(target, name)
    assert target == value, key


def test_main_trains_checkpoints_and_resumes(tmp_path):
  """Two steps at the tiny config (its own bfloat16 model), each followed
  by one eval; the second run restores ``ckpt_2.pt`` and stops."""
  workdir = str(tmp_path / 'run')
  fields = {**niles_config.tiny_fields(), 'num_train_steps': 2,
            'log_every_steps': 1, 'eval_every_epochs': 0.0,
            'steps_per_eval': 1}
  argv = ['--workdir', workdir, '--device', 'cpu']
  for key, value in fields.items():
    argv += ['--set', f'{key}={value!r}']
  state = niles_main.main(argv)
  assert state.step == 2
  assert state.model.multiscale_encoder.dtype == torch.bfloat16
  with open(os.path.join(workdir, 'metrics.jsonl'), encoding='utf-8') as f:
    lines = [json.loads(line) for line in f]
  train_lines = [x for x in lines if 'train_loss' in x]
  eval_lines = [x for x in lines if 'eval_mse' in x]
  assert [x['step'] for x in train_lines] == [1, 2]
  assert [x['step'] for x in eval_lines] == [1, 2]
  assert all(np.isfinite(v) for x in lines for v in x.values())
  ckpts = sorted(os.listdir(os.path.join(workdir, 'checkpoints')))
  assert ckpts == ['ckpt_2.pt']
  saved = torch.load(os.path.join(workdir, 'checkpoints', 'ckpt_2.pt'))
  assert saved['step'] == 2

  resumed = niles_main.main(argv)
  assert resumed.step == 2
  for key, value in resumed.model.state_dict().items():
    assert torch.equal(value, saved['model'][key]), key
  assert resumed.optimizer.state_dict()['state'].keys() == saved[
      'optimizer']['state'].keys()
  with open(os.path.join(workdir, 'metrics.jsonl'), encoding='utf-8') as f:
    assert len(f.readlines()) == len(lines)
  assert sorted(os.listdir(os.path.join(workdir, 'checkpoints'))) == ckpts

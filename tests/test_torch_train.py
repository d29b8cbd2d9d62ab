"""The port's NiLES train step against the JAX package's, on the CPU.

At the tiny configuration (4x4 elements, order 2, width 8, depth 4, two
SDE samples, 2-step rollouts with one pushforward step), from the same
flax parameters (perturbed so that the zero-initialised heads carry
signal, loaded through `interop.transformer_params_from_flax`), the same
debug batch and the JAX package's SDE draws, with the exact FDM
preconditioners, the solver in float64 and the model in float32:

* the loss and the metrics within 1e-5 relative (the model's float32);
* every parameter's gradient within 1e-4 of the largest entry of that
  gradient (1e-6 of the largest entry of all gradients where it is
  smaller), the CG iteration telemetry exactly;
* the parameters after one clipped AdamW step within 1e-6 of optax's
  update from the JAX gradients.

Also: the optimizer step against optax's on random gradients, the
schedules against optax's at several step counts, remat against no remat,
the no-model eval baseline, and the spectrum loss's transfer and TKE
against the JAX functions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from swirlfem_tpu.niles import input_pipeline as jpipeline
from swirlfem_tpu.niles import train as jtrain
from swirlfem_tpu.nse.solver import StokesSEM as JStokesSEM
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch import interop
from swirlfem_tpu_torch.niles import train

from torch_niles_configs import jax_draws
from torch_niles_configs import jax_tiny_config
from torch_niles_configs import perturbed
from torch_niles_configs import torch_tiny_config
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

F32 = {'model.dtype': 'float32'}
LR = 1e-2


def _rel(got, want):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _setup():
  jcfg = jax_tiny_config(**F32)
  cfg = torch_tiny_config(**F32)
  jmodel = jtrain.create_model(jcfg.model_name, jcfg.model)
  jstate = jtrain.create_train_state(jax.random.PRNGKey(0), jmodel,
                                     lambda step: LR, jcfg)
  jstate = jstate.replace(params=jax.tree.map(jnp.asarray,
                                              perturbed(jstate.params)))
  jsem = JStokesSEM.create(
      junit_cube_mesh(jcfg.element_grid_size, periodic_dims=(0, 1)),
      boundary_conditions={}, order=jcfg.order)
  batch = next(jpipeline.create_split(jcfg.batch_size, train=True,
                                      config=jcfg, prefetch=0))
  batch = {k: np.asarray(v, np.float64) for k, v in batch.items()}
  sem = train.build_solver(cfg, device='cpu', dtype=torch.float64)
  return jcfg, cfg, jmodel, jstate, jsem, batch, sem


def _port_state(cfg, params):
  model = train.create_model(cfg)
  interop.transformer_params_from_flax(params, model)
  return train.create_train_state(model, cfg)


def _jax_draws_fn(jcfg, step_rng, batch_size, seq_len):
  """Rollout step i's draws as the JAX loss makes them: fold_in(z_rng, i)."""
  _, z_rng = jax.random.split(step_rng)
  return lambda i: jax_draws(jcfg, jax.random.fold_in(z_rng, i), batch_size,
                             seq_len)


@functools.lru_cache(maxsize=None)
def _jax_reference():
  """JAX loss, metrics and gradients of one step, and optax's update."""
  jcfg, _, _, jstate, jsem, batch, _ = _setup()
  kl_fn = jtrain.create_kl_penalty_fn(jcfg, 100)
  preconds = jtrain.make_solver_preconds(jsem, jcfg)
  step_rng = jax.random.PRNGKey(3)

  def loss_fn(params):
    return jtrain.compute_mse_loss(
        jax.tree.map(jnp.asarray, batch), params, jstate.apply_fn, step_rng,
        kl_fn(0), jsem, None, jcfg, train=True, preconds=preconds)

  (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
      jstate.params)
  metrics = jtrain.compute_metrics(loss, aux, train=True)
  new_state = jstate.apply_gradients(grads=grads)
  return (float(loss), {k: np.asarray(v) for k, v in metrics.items()},
          jax.tree.map(np.asarray, grads),
          jax.tree.map(np.asarray, new_state.params), step_rng)


def _torch_layout(cfg, tree):
  """A flax-layout tree (parameters or gradients) in the port's layout, by
  `state_dict` name, through the same mapping as the weights."""
  model = train.create_model(cfg)
  interop.transformer_params_from_flax(tree, model)
  return {k: v.numpy() for k, v in model.state_dict().items()}


def test_train_step_matches_jax():
  jcfg, cfg, _, jstate, _, batch, sem = _setup()
  want_loss, want_metrics, want_grads, want_params, step_rng = (
      _jax_reference())
  state = _port_state(cfg, jax.tree.map(np.asarray, jstate.params))
  seq_len = state.model.tok_shape[0]
  tbatch = {k: torch.tensor(v) for k, v in batch.items()}
  kl_fn = train.create_kl_penalty_fn(cfg, 100)
  state, metrics, grads = train.train_step(
      state, tbatch, _jax_draws_fn(jcfg, step_rng, cfg.batch_size, seq_len),
      lambda step: LR, kl_fn, sem, cfg,
      preconds=train.make_solver_preconds(sem, cfg))
  assert state.step == 1
  assert abs(float(metrics['loss']) - want_loss) <= 1e-5 * abs(want_loss)
  for key in ('mse', 'kl', 'kl_q0', 'kl_path', 'z0_means', 'z1_means',
              'z1_stds'):
    assert _rel(float(metrics[key]), want_metrics[key]) <= 1e-5, key
  assert metrics['cg_max_iters'] == float(want_metrics['cg_max_iters'])
  assert metrics['cg_max_iters'] < 200

  names = [n for n, _ in state.model.named_parameters()]
  want_g = _torch_layout(cfg, want_grads)
  top = max(np.abs(g).max() for g in want_g.values())
  assert top > 0
  for name, g in zip(names, grads):
    want = want_g[name]
    scale = max(np.abs(want).max(), 1e-2 * top)
    err = np.abs(g.numpy() - want).max() / scale
    assert err <= 1e-4, (name, err)
  want_p = _torch_layout(cfg, want_params)
  for name, p in state.model.named_parameters():
    assert np.abs(p.detach().numpy() - want_p[name]).max() <= 1e-6, name


def test_optimizer_step_matches_optax():
  """Clipped AdamW, three steps on random gradients (clipping active on
  the first), against ``optax.chain(clip_by_global_norm, adamw)`` with the
  warmup-cosine schedule."""
  cfg = torch_tiny_config(**F32)
  jcfg = jax_tiny_config(**F32)
  rng = np.random.default_rng(0)
  shapes = [(4, 3), (3,), (2, 2, 2)]
  params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
  grads = [[(0.05 if i == 0 else 1e-3) * rng.standard_normal(s).astype(
      np.float32) for s in shapes] for i in range(3)]
  lr_fn = train.create_learning_rate_fn(cfg, 0.3, 2)
  jlr_fn = jtrain.create_learning_rate_fn(jcfg, 0.3, 2)
  tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip_norm),
                   optax.adamw(learning_rate=jlr_fn, b1=0.9, b2=0.95,
                               eps=1e-6, weight_decay=cfg.weight_decay))
  jp = [jnp.asarray(p) for p in params]
  opt_state = tx.init(jp)
  model = torch.nn.ParameterList([torch.nn.Parameter(torch.tensor(p))
                                  for p in params])
  state = train.create_train_state(model, cfg)
  for step, g in enumerate(grads):
    updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state,
                                   jp)
    jp = optax.apply_updates(jp, updates)
    state.apply_gradients([torch.tensor(x) for x in g], lr_fn(step))
    for got, want in zip(model, jp):
      np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                 rtol=0, atol=2e-6, err_msg=str(step))
  assert state.step == 3


def test_schedules_match_optax():
  cfg = torch_tiny_config(**F32)
  jcfg = jax_tiny_config(**F32)
  for spe in (1, 7, 40):
    for ours, theirs in (
        (train.create_learning_rate_fn(cfg, 0.0075 * 16 / 256, spe),
         jtrain.create_learning_rate_fn(jcfg, 0.0075 * 16 / 256, spe)),
        (train.create_kl_penalty_fn(cfg, spe),
         jtrain.create_kl_penalty_fn(jcfg, spe))):
      for step in (0, 1, spe - 1, spe, spe + 3, 5 * spe, 14 * spe, 15 * spe,
                   20 * spe):
        want = float(theirs(step))
        assert abs(ours(step) - want) <= 1e-6 * max(abs(want), 1e-8), (
            spe, step, ours(step), want)
  assert train.create_learning_rate_fn(cfg, 1.0, 10)(0) == 0.0

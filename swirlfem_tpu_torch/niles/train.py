"""NiLES trainer: differentiable-solver-in-the-loop closure learning.

Counterpart of ``swirlfem_tpu/niles/train.py``: the loss rolls the
spectral-element NSE solver forward ``config.num_steps`` steps with the
transformer predicting a nodal forcing correction each step (pushforward
trick: early steps' corrections are detached), MSE against the DNS
trajectory plus a scheduled KL penalty from the latent SDE, AdamW behind
global-norm clipping with warmup-cosine learning rate, and TKE /
energy-spectrum metrics on a uniform transfer grid.

Where the port differs in form:

* the rollout steps the whole batch in one batched solver step
  (`solve_batch_step`, ``StokesSEM.stokes_batch_step``), the counterpart
  of ``jax.vmap(solve_one_step)``: each sample's CG is its own, frozen by a
  select once it has stopped, as under vmap;
* data parallelism is a `parallel.spmd.Axis` of R ranks (one process each,
  `niles.main --ranks`) in place of the ``('batch',)`` device mesh: each
  rank holds a replica of the model and optimizer, reads its own slice of
  each shuffled epoch (`input_pipeline.create_split`'s rank arithmetic,
  the JAX per-host slices), takes its rows of the global batch's draws,
  and averages its gradients with the others' in one psum a step before
  the clipped AdamW update, so that every rank applies the same update;
  rank 0 alone writes checkpoints and metrics;
* gradients through both solves come from `linalg.linear_solve` (the
  ``lax.custom_linear_solve`` counterpart) and, on CUDA, through the
  exchange and stiffness kernels' autograd functions; the solver is built
  on the card with its kernels (no fallback: a kernel that fails raises);
* the SDE's randomness: each rollout step draws from a ``torch.Generator``
  seeded by (seed, step, rollout index), in place of ``fold_in``; the
  draws are made before the step, so that `remat`
  (``torch.utils.checkpoint``) recomputes the same step;
* checkpoints are synchronous ``torch.save`` files, metrics JSON lines in
  the workdir.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import logging
import math
import os
import time

import numpy as np
import torch
import torch.utils.checkpoint

from swirlfem_tpu_torch.core.quadrature import Nodes1D
from swirlfem_tpu_torch.core.quadrature import NodeType
from swirlfem_tpu_torch.core.refine import refine_premesh
from swirlfem_tpu_torch.core.tensor import BarycentricInterpolator
from swirlfem_tpu_torch.models import transformer
from swirlfem_tpu_torch.niles import input_pipeline
from swirlfem_tpu_torch.nse import solver as navier_stokes
from swirlfem_tpu_torch.utils.box import unit_cube_mesh

log = logging.getLogger(__name__)

# -- solver step with extrapolated advection + Kolmogorov forcing ------------


def kolmogorov_forcing(config, x, u):
  """Body force: sin(2 pi k y) in x plus linear drag (datagen parity)."""
  k = config.get('forcing_wavenumber', 4.0)
  f0 = torch.sin(2 * math.pi * k * x[..., 1])
  f = torch.stack([f0, torch.zeros_like(f0)], dim=-1)
  return f - config.drag_coeff * u


def _step_forcing(us, cus, f, sem, config):
  """The step's nodal covector: EXTk-extrapolated advection and the
  Kolmogorov body force added to the model's forcing `f`."""
  ext = [float(c) for c in navier_stokes.extk_coeffs(k=config.time_order - 1)]
  cu = sum(ext[-i] * cus[-i] for i in range(1, len(ext) + 1))
  f = f + kolmogorov_forcing(config, sem.nodal.velocity.mesh.node_coords,
                             us[-1])
  return -cu + sem.B(f)


def _step_kwargs(config):
  return dict(mu=1.0 / config.reynolds_number, dt=config.dt,
              alpha=config.alpha, time_order=config.time_order, tol=0.0,
              atol=1e-7, maxiter=200)


def solve_one_step(us, ps, cus, f, sem, config, preconds=None):
  """One NSE step of one sample with EXTk-extrapolated advection entering
  the forcing; nodal ``(N, 2)`` velocities, ``(P,)`` pressures.

  The per-sample function the JAX trainer vmaps; `solve_batch_step` steps
  a whole batch.  `preconds`: the ``(viscous, pressure)`` exact FDM
  inverses in nodal form (`make_nodal_preconds`); each CG, the transpose
  solves of the backward pass included, then certifies in 0-2 iterations.
  ``maxiter=200`` bounds a below-floor wander and is inert on the healthy
  path (the telemetry shows it).  Returns ``(u, p, C(u), cg_stats)``: the
  iteration counts as ints, the residuals as 0-d tensors.
  """
  vprecond, pprecond = preconds if preconds is not None else (None, None)
  u, p, aux = sem.stokes_one_step(
      list(us), list(ps), _step_forcing(us, cus, f, sem, config),
      viscous_preconditioner=vprecond, pressure_preconditioner=pprecond,
      **_step_kwargs(config))
  cg_stats = {
      'cg_u_iters': int(aux['u_star_info']['num_iterations']),
      'cg_p_iters': int(aux['dp_info']['num_iterations']),
      'cg_u_resid': aux['u_star_info']['residual'].detach().float(),
      'cg_p_resid': aux['dp_info']['residual'].detach().float(),
  }
  return u, p, sem.C(u), cg_stats


def solve_batch_step(us, ps, cus, f, sem, config, preconds=None):
  """`solve_one_step` on every sample of a batch in one batched solver
  step: ``(B, N, 2)`` velocities, ``(B, P)`` pressures, the counterpart of
  ``jax.vmap(solve_one_step)`` (``swirlfem_tpu/niles/train.py:252-255``).

  `preconds`: `make_solver_preconds`'s el-form inverses on the batched
  layout, fed to the solves directly.  Returns ``(u, p, C(u), cg_stats)``
  with per-sample ``(B,)`` iteration counts and residuals (float32) on the
  solver's device.
  """
  vprecond, pprecond = preconds if preconds is not None else (None, None)
  u, p, aux = sem.stokes_batch_step(
      list(us), list(ps), _step_forcing(us, cus, f, sem, config),
      viscous_preconditioner_el=vprecond, pressure_preconditioner_el=pprecond,
      **_step_kwargs(config))
  info_u, info_p = aux['u_star_info'], aux['dp_info']
  cg_stats = {
      'cg_u_iters': info_u['num_iterations'].float(),
      'cg_p_iters': info_p['num_iterations'].float(),
      'cg_u_resid': info_u['residual'].detach().float(),
      'cg_p_resid': info_p['residual'].detach().float(),
  }
  return u, p, sem.C(u), cg_stats


def make_solver_preconds(sem, config):
  """Exact FDM inverses for the training solver's two CG solves: the
  ``(viscous, pressure)`` el-form callables on the batched layout that
  `solve_batch_step` takes."""
  return sem.fdm_el_preconditioners(1.0 / config.reynolds_number, config.dt,
                                    config.time_order, batched=True)


def make_nodal_preconds(sem, config):
  """`make_solver_preconds`'s two inverses in nodal form, for the
  per-sample `solve_one_step` (the same operators to rounding)."""
  vprecond = sem.fdm_viscous_preconditioner(
      1.0 / config.reynolds_number, config.dt, config.time_order)
  pprecond = sem.best_pressure_preconditioner(config.dt, config.time_order)
  return vprecond, pprecond


def build_solver(config, *, device, dtype=torch.float32, use_kernels=True):
  """The training solver on the doubly periodic box, on `device`."""
  return navier_stokes.StokesSEM.create(
      unit_cube_mesh(config.element_grid_size, periodic_dims=(0, 1)),
      boundary_conditions={}, order=config.order, device=device,
      dtype=dtype, use_kernels=use_kernels)


# -- element permutation and uniform-grid transfer ---------------------------


def make_multiscale_perm(size=12, patch_sizes=(2, 3), factors=(2, 4)):
  """Element order placing spatially nearby elements adjacently in the
  token sequence."""

  def lex(n):
    return np.array(list(itertools.product(range(n), repeat=2)),
                    dtype=np.int32)

  p = lex(int(size / np.prod(patch_sizes)))
  for ps, factor in zip(patch_sizes, factors):
    shifts = lex(ps)
    p = np.concatenate([p + factor * s for s in shifts])
  return np.array([size * i + j for i, j in p], dtype=np.int32)


def transfer_perm(source_coords, target_coords):
  """Nearest-node permutation from source nodes to target nodes."""
  import scipy.spatial
  _, idx = scipy.spatial.KDTree(np.asarray(source_coords)).query(
      np.asarray(target_coords))
  return np.asarray(idx, dtype=np.int64)


def make_uniform_transfer(sem, config):
  """Returns fn: nodal GLL velocity (N, d) -> (n, n, d) uniform-grid field."""
  host = dict(device='cpu', dtype=torch.float64)
  uniform_mesh = refine_premesh(
      unit_cube_mesh(config.element_grid_size, periodic_dims=(0, 1)),
      Nodes1D.create(config.order + 1, NodeType.NEWTON_COTES)).finalize(
          **host)
  grid_mesh = unit_cube_mesh(
      config.element_grid_size * config.order).finalize(**host)
  perm = torch.as_tensor(transfer_perm(uniform_mesh.node_coords.numpy(),
                                       grid_mesh.node_coords.numpy()),
                         device=sem.device)
  vmesh = sem.nodal.velocity.mesh
  uniform_mesh = uniform_mesh.to(sem.device, sem.dtype)
  interp = BarycentricInterpolator(
      ndim=config.ndim, gridpoints_1d=vmesh.gridpoints_1d,
      evalpoints_1d=Nodes1D.create(config.order + 1, NodeType.NEWTON_COTES))
  multiplicity = uniform_mesh.scatter(torch.ones(
      uniform_mesh.elements.shape, dtype=sem.dtype, device=sem.device))
  side = config.resolution + 1

  def to_grid(u):
    comps = []
    for c in range(u.shape[-1]):
      vals = interp.interpolate(vmesh.gather(u[..., c].to(sem.dtype)))
      comps.append(uniform_mesh.scatter(vals) / multiplicity)
    nodal = torch.stack(comps, dim=-1)
    return nodal[perm].reshape(side, side, u.shape[-1])[:-1, :-1]

  return to_grid


def get_tke(u, to_grid):
  """Turbulent kinetic energy on the uniform grid."""
  u_grid = to_grid(u)
  u_hat = torch.stack([torch.fft.fftshift(torch.fft.fftn(u_grid[..., c])).abs()
                       for c in range(u_grid.shape[-1])], dim=-1)
  return 0.5 * torch.square(u_hat).sum(dim=-1)


@functools.lru_cache(maxsize=16)
def _spectrum_bins(n: int, num_bins: int):
  freqs = np.fft.fftshift(np.fft.fftfreq(n, 1.0 / n))
  kx, ky = np.meshgrid(freqs, freqs)
  k = np.sqrt(kx**2 + ky**2)
  bins = np.linspace(0, np.max(k), num=num_bins)
  onehot = np.stack([np.digitize(k, bins) == i
                     for i in range(1, num_bins - 1)]).astype(np.float64)
  return bins, onehot


def get_energy_spectrum(tke, num_bins: int = 20):
  """Radially binned energy spectrum of (..., n, n) TKE fields."""
  bins, onehot = _spectrum_bins(tke.shape[-1], num_bins)
  w = torch.as_tensor(onehot, dtype=tke.dtype, device=tke.device)
  return bins[1:-1], torch.einsum('...ij,bij->...b', tke, w)


def log_spectrum_error(pred_tke, target_tke):
  """Sum over radial bins of squared log-spectrum mismatch (per sample)."""
  _, pred_spec = get_energy_spectrum(pred_tke)
  _, target_spec = get_energy_spectrum(target_tke)
  eps = 1e-20  # spectra are sums of |u_hat|^2 >= 0; guard empty bins
  return torch.square(torch.log(pred_spec + eps)
                      - torch.log(target_spec + eps)).sum(-1)


def _tke_all(preds, to_grid):
  """(B, S, N, d) velocities -> (B, S, n, n) TKE fields."""
  return torch.stack([torch.stack([get_tke(u, to_grid) for u in sample])
                      for sample in preds])


# -- loss ----------------------------------------------------------------------


AUX_KEYS = ('kl_q0', 'kl_path', 'z0_means', 'z1_means', 'z1_stds')
CG_KEYS = ('cg_u_iters', 'cg_p_iters', 'cg_u_resid', 'cg_p_resid')


def compute_mse_loss(batch, model_apply_fn, draws_fn, kl_penalty, sem,
                     to_grid, config, train: bool, preconds=None):
  """Rollout loss: MSE of the predicted trajectory + KL penalty.

  `batch` holds ``'u'`` (B, W, N, 2) and ``'p'`` (B, W, P) tensors on the
  solver's device; ``model_apply_fn(inputs, draws) -> (forcing, aux)``;
  ``draws_fn(i)`` gives rollout step i's processor draws (or None).
  Returns ``(loss, aux)``; ``aux['cg_max_iters']`` is a float, the rest
  tensors.
  """
  tau = config.time_order
  us = tuple(batch['u'][:, i] for i in range(tau))
  ps = tuple(batch['p'][:, i] for i in range(tau))
  cus = tuple(sem.C(u) for u in us)
  batch_size = us[-1].shape[0]
  perm = invperm = None
  if config.permute_elements:
    perm = make_multiscale_perm(size=config.element_grid_size)
    invperm = torch.as_tensor(np.argsort(perm), device=sem.device)
    perm = torch.as_tensor(perm, device=sem.device)
  vel = sem.nodal.velocity
  vmesh = vel.mesh

  def body(us, ps, cus, i, draws):
    inputs = torch.vmap(vel.gather)(us[-1]).float()
    inputs = inputs.reshape(batch_size, vmesh.num_elements,
                            vmesh.num_nodes_per_element * vmesh.ndim)
    if perm is not None:
      inputs = inputs[:, perm]
    forcing, aux = model_apply_fn(inputs, draws)
    if train and 0 < config.num_pushforward_steps and (
        i < config.num_pushforward_steps):
      # Pushforward trick: only the last rollout steps carry gradients.
      forcing = forcing.detach()
    if invperm is not None:
      forcing = forcing[:, invperm]
    forcing = forcing.reshape(batch_size, vmesh.num_elements,
                              vmesh.num_nodes_per_element,
                              vmesh.ndim).to(us[-1].dtype)
    u, p, cu, cg = solve_batch_step(us, ps, cus, torch.vmap(vel.scatter)(
        forcing), sem, config, preconds)
    return u, p, cu, aux, cg

  num_solver_steps = config.num_steps if train else config.eval_num_steps
  zeros = torch.zeros(batch_size, dtype=torch.float32, device=sem.device)
  aux_sum = {k: zeros for k in AUX_KEYS}
  cg_max = {k: torch.zeros((), device=sem.device) for k in CG_KEYS}
  preds = []
  for i in range(num_solver_steps):
    draws = draws_fn(i)
    if config.get('remat', False) and torch.is_grad_enabled():
      # Recompute the rollout step in the backward pass instead of keeping
      # its activations and solver intermediates.
      u, p, cu, aux, cg = torch.utils.checkpoint.checkpoint(
          body, us, ps, cus, i, draws, use_reentrant=False)
    else:
      u, p, cu, aux, cg = body(us, ps, cus, i, draws)
    aux_sum = {k: (aux[k] + aux_sum[k] if k in ('kl_path', 'kl_q0')
                   else aux[k]) for k in AUX_KEYS}
    # Running max over rollout steps and batch of the CG telemetry.
    cg_max = {k: torch.maximum(cg_max[k], cg[k].max()) for k in CG_KEYS}
    us, ps, cus = us[1:] + (u,), ps[1:] + (p,), cus[1:] + (cu,)
    preds.append(u)
  preds = torch.stack(preds, dim=1)  # (batch, steps, nodes, ndim)

  targets = batch['u'][:, tau:tau + num_solver_steps]
  mse = 0.5 * torch.square(preds - targets)  # optax.l2_loss
  mse = mse.sum(dim=(-1, -2)).mean(dim=0)  # per-step, batch-averaged
  kl_q0 = aux_sum['kl_q0'].mean()
  kl_path = aux_sum['kl_path'].mean()
  kl = kl_q0 + kl_path
  loss = mse.sum() + kl_penalty * kl

  spectrum_weight = config.get('spectrum_loss_weight', 0.0)
  out_aux = {
      'kl_q0': kl_q0,
      'kl_path': kl_path,
      'mse': mse,
      'kl': kl_penalty * kl,
      'z0_means': aux_sum['z0_means'].abs().mean(),
      'z1_means': aux_sum['z1_means'].abs().mean(),
      'z1_stds': aux_sum['z1_stds'].abs().mean(),
      # Rollout-max CG telemetry (shows the maxiter=200 cap is inert).
      'cg_max_iters': float(torch.maximum(cg_max['cg_u_iters'],
                                          cg_max['cg_p_iters'])),
      'cg_max_resid': torch.maximum(cg_max['cg_u_resid'],
                                    cg_max['cg_p_resid']),
  }
  half = num_solver_steps // 2
  if train and to_grid is not None and spectrum_weight > 0:
    pred_tke = _tke_all(preds, to_grid)[:, half:].mean(dim=1)
    target_tke = _tke_all(targets, to_grid)[:, half:].mean(dim=1)
    spec_err = log_spectrum_error(pred_tke, target_tke).mean()
    loss = loss + spectrum_weight * spec_err
    out_aux['spec_err'] = spec_err

  if not train and to_grid is not None:
    pred_tke_all = _tke_all(preds, to_grid)
    target_tke_all = _tke_all(targets, to_grid)
    out_aux['tke_err'] = log_spectrum_error(
        pred_tke_all[:, half:].mean(dim=1),
        target_tke_all[:, half:].mean(dim=1)).mean()
    for horizon in (8, 16):
      if num_solver_steps >= horizon:
        out_aux[f'tke_err@{horizon}'] = log_spectrum_error(
            pred_tke_all[:, horizon - 1],
            target_tke_all[:, horizon - 1]).mean()
    eps = 1e-20
    _, pred_spec = get_energy_spectrum(pred_tke_all[:, half:].mean(dim=1))
    _, target_spec = get_energy_spectrum(
        target_tke_all[:, half:].mean(dim=1))
    out_aux['logspec_pred'] = torch.log(pred_spec + eps).mean(dim=0)
    out_aux['logspec_target'] = torch.log(target_spec + eps).mean(dim=0)
  elif not train:
    out_aux['tke_err'] = zeros.mean()
  return loss, out_aux


def compute_metrics(loss, aux, train: bool):
  metrics = {
      'loss': loss,
      'kl_q0': aux['kl_q0'],
      'kl_path': aux['kl_path'],
      'kl': aux['kl'],
      'mse': aux['mse'].mean(),
      'z0_means': aux['z0_means'],
      'z1_means': aux['z1_means'],
      'z1_stds': aux['z1_stds'],
  }
  for k in ('cg_max_iters', 'cg_max_resid'):
    if k in aux:
      metrics[k] = aux[k]
  if train and 'spec_err' in aux:
    metrics['spec_err'] = aux['spec_err']
  if not train:
    metrics['tke_err'] = aux['tke_err']
    for horizon in (8, 16):
      if f'tke_err@{horizon}' in aux:
        metrics[f'tke_err@{horizon}'] = aux[f'tke_err@{horizon}']
    for name in ('logspec_pred', 'logspec_target'):
      if name in aux:
        for i in range(aux[name].shape[0]):
          metrics[f'{name}_{i:02d}'] = aux[name][i]
    mse = aux['mse']
    metrics['mse@1to8'] = mse[:8].mean()
    for horizon in (8, 16, 32, 64):
      if mse.shape[0] >= horizon:
        metrics[f'mse@{horizon}'] = mse[horizon - 1]
  return metrics


def metrics_to_host(metrics) -> dict:
  """The metrics as floats (one device read each)."""
  return {k: float(v) for k, v in metrics.items()}


# -- schedules (optax's, step by step) ----------------------------------------


def linear_schedule(init_value, end_value, transition_steps):
  """``optax.linear_schedule``."""
  if transition_steps <= 0:
    return lambda count: init_value

  def schedule(count):
    frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
    return (init_value - end_value) * frac + end_value

  return schedule


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0):
  """``optax.cosine_decay_schedule``."""
  if not decay_steps > 0:
    raise ValueError('the cosine decay needs a positive decay_steps')

  def schedule(count):
    count = min(count, decay_steps)
    decayed = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
    return init_value * ((1 - alpha) * decayed + alpha)

  return schedule


def join_schedules(schedules, boundaries):
  """``optax.join_schedules``: schedule i + 1 from boundary i, counted from
  there."""

  def schedule(step):
    out = schedules[0](step)
    for boundary, sched in zip(boundaries, schedules[1:]):
      if step >= boundary:
        out = sched(step - boundary)
    return out

  return schedule


def create_learning_rate_fn(config, base_learning_rate, steps_per_epoch):
  warmup = linear_schedule(0.0, base_learning_rate,
                           config.warmup_epochs * steps_per_epoch)
  cosine_epochs = max(config.num_epochs - config.warmup_epochs, 1)
  cosine = cosine_decay_schedule(base_learning_rate,
                                 cosine_epochs * steps_per_epoch)
  return join_schedules([warmup, cosine],
                        [config.warmup_epochs * steps_per_epoch])


def create_kl_penalty_fn(config, steps_per_epoch):
  ramp = linear_schedule(0.0, config.kl_penalty,
                         config.kl_transition_epochs * steps_per_epoch)
  return join_schedules([lambda count: 0.0, ramp],
                        [config.kl_zero_epochs * steps_per_epoch])


# -- model and state ------------------------------------------------------------

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def create_model(config) -> transformer.Model:
  """The closure model of `config` (parameters from the current torch
  RNG; the trainer seeds it)."""
  if config.model_name != 'multiscale_transformer':
    raise ValueError(f'unsupported model {config.model_name!r}')
  m = config.model
  return transformer.Model(
      num_elements=config.num_elements, num_channels=config.num_channels,
      dtype=_DTYPES[m.get('dtype', 'float32')], depth=m.depth, width=m.width,
      use_residuals=m.use_residuals,
      freeze_encoder=m.get('freeze_encoder', False),
      mean_after_decoder=m.mean_after_decoder,
      processor_config=m.processor_config,
      num_initial_heads=m.num_initial_heads,
      pooling_layers=tuple(m.pooling_layers),
      pooling_kernel=tuple(m.pooling_kernel),
      pooling_strides_q=tuple(m.pooling_strides_q),
      initial_kv_pooling_strides=tuple(m.initial_kv_pooling_strides),
      qkv_tile_reps=tuple(m.qkv_tile_reps))


@dataclasses.dataclass
class TrainState:
  """The model, its AdamW state and the step count."""
  model: transformer.Model
  optimizer: torch.optim.Optimizer
  step: int
  grad_clip_norm: float | None

  def apply_gradients(self, grads, learning_rate: float) -> None:
    """optax's ``chain(clip_by_global_norm, adamw)`` update, in place."""
    params = [p for p in self.model.parameters()]
    if self.grad_clip_norm is not None:
      g_norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
      clipped = g_norm >= self.grad_clip_norm
      scale = torch.where(clipped, self.grad_clip_norm / g_norm,
                          torch.ones_like(g_norm))
      grads = [g * scale for g in grads]
    for p, g in zip(params, grads):
      p.grad = g
    for group in self.optimizer.param_groups:
      group['lr'] = learning_rate
    self.optimizer.step()
    self.optimizer.zero_grad(set_to_none=True)
    self.step += 1


def create_train_state(model, config) -> TrainState:
  """AdamW (b1 0.9, b2 0.95, eps 1e-6, weight decay on every parameter);
  the learning rate is set per step from the schedule."""
  optimizer = torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.95),
                                eps=1e-6, weight_decay=config.weight_decay)
  return TrainState(model=model, optimizer=optimizer, step=0,
                    grad_clip_norm=config.grad_clip_norm)


def slice_draws(draws, batch_size: int, rows: slice):
  """The draws of samples `rows` of a batch of `batch_size`: every tensor's
  leading axis holds ``batch_size`` blocks of equal size (the SDE's
  samples of each input are adjacent), and the blocks of `rows` are
  kept."""
  if draws is None:
    return None
  out = {}
  for key, x in draws.items():
    per = x.shape[0] // batch_size
    out[key] = x[rows.start * per:rows.stop * per]
  return out


def make_draws_fn(model, batch_size: int, seed: int, step: int, device,
                  rows: slice | None = None):
  """Rollout step i's processor draws from a generator seeded by
  (seed, step, i): the counterpart of ``fold_in(step_rng, i)``.

  `rows`: a data-parallel rank's samples of the global batch of
  `batch_size`; the global batch's draws are made and sliced, so that each
  sample's noise is the single-process run's."""
  def draws_fn(i):
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, step, i]).generate_state(
        1)[0]))
    draws = model.sample_draws(batch_size, generator=g, device=device)
    return draws if rows is None else slice_draws(draws, batch_size, rows)

  return draws_fn


def _model_apply(model):
  return lambda inputs, draws: model(inputs, draws=draws)


def average_gradients(grads, axis):
  """Every rank's gradients averaged across `axis`, in one psum of one flat
  buffer (added in rank order: bitwise the same on every rank)."""
  flat = axis.psum(torch.cat([g.reshape(-1) for g in grads])) / axis.size
  out, start = [], 0
  for g in grads:
    out.append(flat[start:start + g.numel()].reshape(g.shape))
    start += g.numel()
  return out


def reduce_metrics(metrics: dict, axis) -> dict:
  """Metrics of every rank's shard combined across `axis` in one
  all_gather: the CG telemetry (``cg_max*``) by their maximum, the rest by
  their mean (equal shards: the global batch's mean)."""
  keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)
          or k.startswith('cg_max')]
  device = next(v.device for v in metrics.values()
                if isinstance(v, torch.Tensor))
  local = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float64,
                                       device=device).reshape(())
                       for k in keys])
  every = axis.all_gather(local)  # (ranks, keys)
  out = dict(metrics)
  for j, k in enumerate(keys):
    col = every[:, j]
    out[k] = col.max() if k.startswith('cg_max') else col.mean()
  return out


def train_step(state: TrainState, batch, draws_fn, learning_rate_fn,
               kl_penalty_fn, sem, config, preconds=None, to_grid=None,
               axis=None):
  """One train step: loss and gradients through the rollout, then the
  clipped AdamW update.  Returns ``(state, metrics, grads)``.

  `axis`: a data-parallel `parallel.spmd.Axis`; `batch` and `draws_fn`
  are then this rank's shard of the global batch (`slice_draws`), the
  gradients of the rank's mean loss are averaged across the ranks
  (`average_gradients`) before the update, and the metrics are the global
  batch's (`reduce_metrics`)."""
  kl_penalty = kl_penalty_fn(state.step)
  params = list(state.model.parameters())
  loss, aux = compute_mse_loss(batch, _model_apply(state.model), draws_fn,
                               kl_penalty, sem, to_grid, config, train=True,
                               preconds=preconds)
  grads = torch.autograd.grad(loss, params, allow_unused=True)
  grads = [torch.zeros_like(p) if g is None else g
           for p, g in zip(params, grads)]
  metrics = compute_metrics(
      loss.detach(), {k: v.detach() if isinstance(v, torch.Tensor) else v
                      for k, v in aux.items()}, train=True)
  if axis is not None:
    grads = average_gradients(grads, axis)
    metrics = reduce_metrics(metrics, axis)
  lr = learning_rate_fn(state.step)
  metrics['learning_rate'] = lr
  metrics['kl_penalty'] = kl_penalty
  state.apply_gradients(grads, lr)
  return state, metrics, grads


def _zero_model_apply(inputs, draws=None):
  """No-model baseline: zero forcing, zero latent stats (the raw coarse
  solver's trajectory)."""
  del draws
  zeros = torch.zeros(inputs.shape[0], dtype=torch.float32,
                      device=inputs.device)
  return torch.zeros_like(inputs), {k: zeros for k in AUX_KEYS}


@torch.no_grad()
def eval_step(state: TrainState, batch, draws_fn, kl_penalty_fn, sem,
              to_grid, config, preconds=None):
  loss, aux = compute_mse_loss(batch, _model_apply(state.model), draws_fn,
                               kl_penalty_fn(state.step), sem, to_grid,
                               config, train=False, preconds=preconds)
  metrics = compute_metrics(loss, aux, train=False)
  if config.get('eval_baseline', False):
    # Zero-forcing rollout on the same windows: the yardstick any learned
    # correction must beat.
    _, aux0 = compute_mse_loss(batch, _zero_model_apply, draws_fn, 0.0, sem,
                               to_grid, config, train=False,
                               preconds=preconds)
    base = compute_metrics(torch.zeros(()), aux0, train=False)
    metrics.update({f'mse_baseline{k[3:]}': v for k, v in base.items()
                    if k.startswith('mse')})
    for k, v in base.items():
      if k.startswith('tke_err'):
        metrics[k.replace('tke_err', 'tke_err_baseline', 1)] = v
      elif k.startswith('logspec_pred'):
        metrics[k.replace('logspec_pred', 'logspec_baseline', 1)] = v
  return metrics


# -- checkpoints and metrics ----------------------------------------------------


def save_checkpoint(workdir: str, state: TrainState) -> None:
  """Synchronous ``torch.save`` of the model, optimizer and step; a failed
  save is logged and the run goes on."""
  path = os.path.join(workdir, 'checkpoints', f'ckpt_{state.step}.pt')
  try:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({'model': state.model.state_dict(),
                'optimizer': state.optimizer.state_dict(),
                'step': state.step}, path)
  except Exception:  # pylint: disable=broad-except
    log.exception('checkpoint save failed at step %d; continuing', state.step)


def restore_checkpoint(workdir: str, state: TrainState) -> TrainState:
  """Loads the latest checkpoint under `workdir` into `state`, if any."""
  ckpt_dir = os.path.join(workdir, 'checkpoints')
  steps = sorted(int(f[5:-3]) for f in os.listdir(ckpt_dir)
                 if f.startswith('ckpt_') and f.endswith('.pt')) if (
                     os.path.isdir(ckpt_dir)) else []
  if not steps:
    return state
  blob = torch.load(os.path.join(ckpt_dir, f'ckpt_{steps[-1]}.pt'),
                    map_location=next(state.model.parameters()).device)
  state.model.load_state_dict(blob['model'])
  state.optimizer.load_state_dict(blob['optimizer'])
  state.step = int(blob['step'])
  return state


class MetricWriter:
  """Scalars as JSON lines in ``workdir/metrics.jsonl``."""

  def __init__(self, workdir: str):
    os.makedirs(workdir, exist_ok=True)
    self.path = os.path.join(workdir, 'metrics.jsonl')

  def write_scalars(self, step: int, scalars: dict) -> None:
    with open(self.path, 'a', encoding='utf-8') as f:
      f.write(json.dumps({'step': step, **{k: float(v) for k, v in
                                           scalars.items()}}) + '\n')


def _summary(metrics_list):
  return {k: (np.max if k.startswith('cg_max') else np.mean)(
      [m[k] for m in metrics_list]) for k in metrics_list[0]}


# -- top-level loop ---------------------------------------------------------------


def train_and_evaluate(config, workdir: str, *, device='cuda',
                       axis=None) -> TrainState:
  """Runs training + periodic evaluation; returns the final TrainState.

  The data come from ``config.dataset_dir`` (HDF5 or ``.npz`` shards at
  the training resolution) or the synthetic debug split.  A run resumes
  from the latest checkpoint under `workdir`.

  `axis`: this rank's `parallel.spmd.Axis` of a data-parallel run (the JAX
  package's ``('batch',)`` mesh, ``swirlfem_tpu/niles/train.py:566-579``):
  its size must divide ``config.batch_size``; the rank reads its own
  slice of each epoch, holds a replica of the state, and rank 0 alone
  writes checkpoints and metrics.
  """
  device = torch.device(device)
  num_ranks = 1 if axis is None else axis.size
  rank = 0 if axis is None else axis.index
  if config.batch_size % num_ranks:
    raise ValueError(f'batch size {config.batch_size} must be divisible by '
                     f'the rank count {num_ranks}')
  local_batch = config.batch_size // num_ranks
  rows = (None if axis is None
          else slice(rank * local_batch, (rank + 1) * local_batch))
  lead = rank == 0
  writer = MetricWriter(workdir) if lead else None
  torch.manual_seed(config.get('seed', 0))
  shard = dict(rank=rank, num_ranks=num_ranks)
  train_iter = input_pipeline.create_split(local_batch, True, config, **shard)
  eval_iter = input_pipeline.create_split(local_batch, False, config, **shard)
  steps_per_epoch = input_pipeline.get_num_examples(
      config.dataset_dir, True, config.train_window_size,
      config.train_window_stride, debug=config.debug) // config.batch_size
  num_steps = (int(steps_per_epoch * config.num_epochs)
               if config.num_train_steps <= 0 else config.num_train_steps)
  steps_per_checkpoint = (
      int(config.get('checkpoint_every_steps', 0))
      or max(1, int(steps_per_epoch * config.checkpoint_epochs)))
  eval_every_steps = max(1, int(steps_per_epoch * config.eval_every_epochs))

  base_learning_rate = config.learning_rate * config.batch_size / 256.0
  model = create_model(config).to(device)
  learning_rate_fn = create_learning_rate_fn(config, base_learning_rate,
                                             steps_per_epoch)
  kl_penalty_fn = create_kl_penalty_fn(config, steps_per_epoch)
  state = restore_checkpoint(workdir, create_train_state(model, config))
  if lead:
    log.info('model: %d parameters',
             sum(p.numel() for p in model.parameters()))

  sem = build_solver(config, device=device)
  preconds = make_solver_preconds(sem, config)
  to_grid = make_uniform_transfer(sem, config)
  train_to_grid = (to_grid if config.get('spectrum_loss_weight', 0.0) > 0
                   else None)
  seed = config.get('seed', 0)

  def put(batch):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

  def evaluate(it, step_seed, count, batch_size):
    evals = []
    for i in range(count):
      batch = put(next(it))
      draws = make_draws_fn(
          model, batch_size, seed + 1, step_seed + i, device,
          None if axis is None else slice(rank * batch['u'].shape[0],
                                          (rank + 1) * batch['u'].shape[0]))
      metrics = eval_step(state, batch, draws, kl_penalty_fn, sem, to_grid,
                          config, preconds)
      if axis is not None:
        metrics = reduce_metrics(metrics, axis)
      evals.append(metrics_to_host(metrics))
    return _summary(evals)

  profile = None
  if config.get('profile_dir') and lead:
    from swirlfem_tpu_torch.utils.profiling import PeriodicProfile
    profile = PeriodicProfile(config.profile_dir)

  train_metrics, last_t = [], time.time()
  if lead:
    log.info('starting training: %d steps on %d rank(s)', num_steps,
             num_ranks)
  for step in range(state.step, num_steps):
    if profile is not None:
      profile(step)
    batch = put(next(train_iter))
    state, metrics, _ = train_step(
        state, batch, make_draws_fn(model, config.batch_size, seed, step,
                                    device, rows),
        learning_rate_fn, kl_penalty_fn, sem, config, preconds,
        train_to_grid, axis=axis)
    if config.log_every_steps:
      train_metrics.append(metrics_to_host(metrics))
      if (step + 1) % config.log_every_steps == 0:
        stacked = _summary(train_metrics)
        stacked['steps_per_second'] = config.log_every_steps / (
            time.time() - last_t)
        if lead:
          log.info('step %d: %s', step + 1, stacked)
          writer.write_scalars(step + 1,
                               {f'train_{k}': v for k, v in stacked.items()})
        train_metrics, last_t = [], time.time()
    if (step + 1) % eval_every_steps == 0:
      summary = evaluate(eval_iter, step * config.steps_per_eval,
                         config.steps_per_eval, config.batch_size)
      if lead:
        log.info('eval at step %d: %s', step + 1,
                 {k: v for k, v in summary.items()
                  if k.startswith('mse') or k == 'tke_err'})
        writer.write_scalars(step + 1,
                             {f'eval_{k}': v for k, v in summary.items()})
    if lead and ((step + 1) % steps_per_checkpoint == 0
                 or step + 1 == num_steps):
      save_checkpoint(workdir, state)
  if profile is not None:
    profile.close()

  fe_batch = config.get('final_eval_batch_size', 0)
  if fe_batch:
    try:
      # Clamp to the eval split's size: a batch it can never fill becomes
      # the whole split (each rank's share of it).
      avail = input_pipeline.get_num_examples(
          config.dataset_dir, False, config.eval_window_size,
          config.eval_window_stride, debug=config.debug)
      fe_local = min(fe_batch // num_ranks, avail // num_ranks)
      fe_eff = fe_local * num_ranks
      fe_iter = input_pipeline.create_split(fe_local, False, config, **shard)
      summary = evaluate(fe_iter, 10**6, config.steps_per_eval, fe_eff)
      if lead:
        log.info('final eval (batch %d, requested %d): %s', fe_eff,
                 fe_batch, summary)
        writer.write_scalars(num_steps + 1, {
            f'eval_final{fe_eff}_{k}': v for k, v in summary.items()})
    except Exception:  # pylint: disable=broad-except
      # Every rank takes this branch alike: a failure is the split's.
      log.exception('final batch eval failed; continuing')
  return state


def rank_train_and_evaluate(axis, device, config, workdir: str) -> dict:
  """One rank of a data-parallel `train_and_evaluate` (`niles.main
  --ranks`, through `parallel.spmd.launch`); returns the final step and the
  rank's parameters, flat, so that the launcher can see them equal."""
  state = train_and_evaluate(config, workdir, device=device, axis=axis)
  return {'step': state.step,
          'params': torch.cat([p.detach().reshape(-1).cpu()
                               for p in state.model.parameters()])}

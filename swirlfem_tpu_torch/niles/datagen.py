"""DNS data generation: 2D Kolmogorov flow on the doubly periodic square.

Counterpart of ``swirlfem_tpu/niles/datagen.py`` (el path): order-8
spectral elements on a 64x64 grid at Re 20,000, BDF3, dt 1e-4, one frame
every `snapshot_every` steps written to an HDF5 shard per cycle, with CFL
logging.  States stay in element-local E-last form across steps and both
solves are the exact FDM inverses.  A cycle is a plain Python loop over
eager steps, in place of the JAX package's ``jit`` + ``scan``.

Shards have the JAX package's layout: ``u`` (frames, num_nodes, ndim),
``p`` (frames, num_pnodes), ``t`` (frames,).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from swirlfem_tpu_torch.linalg.cg import tree_map
from swirlfem_tpu_torch.nse import solver as navier_stokes
from swirlfem_tpu_torch.utils.box import unit_cube_mesh

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DatagenConfig:
  resolution: int = 64          # elements per dimension
  order: int = 8
  time_order: int = 3
  reynolds_number: float = 20000.0
  num_cycles: int = 500
  num_steps_per_cycle: int = 500
  dt: float = 1e-4
  drag_coeff: float = 0.05
  forcing_wavenumber: float = 4.0
  snapshot_every: int = 10
  split: str = 'train'
  seed: int = 0  # perturbs the initial condition (ensemble generation)
  # Cycles advanced before the first written snapshot (spin-up).
  warmup_cycles: int = 0


def u_init(x: np.ndarray, l: float = 2.0) -> np.ndarray:
  """Initial Kolmogorov velocity field (Taylor-Green-like), (N, 2)."""
  u0 = np.cos(2 * l * np.pi * x[..., 0]) * np.sin(2 * l * np.pi * x[..., 1])
  u1 = -np.sin(2 * l * np.pi * x[..., 0]) * np.cos(2 * l * np.pi * x[..., 1])
  return np.stack([u0, u1], axis=-1)


def kolmogorov_el_forcing(cfg: DatagenConfig, wmass_el, fbody_el, u, cu):
  """Mass-weighted el-form forcing covector: body force - drag, minus the
  extrapolated convection."""
  ux, uy = u
  return (wmass_el * (fbody_el - cfg.drag_coeff * ux) - cu[0],
          wmass_el * (-cfg.drag_coeff * uy) - cu[1])


def min_node_spacing(mesh) -> float:
  """Minimum distance between nodes within any element (CFL scale)."""
  coords = mesh.element_coords().cpu()
  dx = np.inf
  for start in range(0, coords.shape[0], 256):  # bounded pairwise buffers
    x = coords[start:start + 256]
    # Direct differences (no |x|^2 + |y|^2 - 2xy expansion): exact distances.
    pair = torch.cdist(x, x, compute_mode='donot_use_mm_for_euclid_dist')
    pair.diagonal(dim1=1, dim2=2).fill_(np.inf)
    dx = min(dx, float(pair.min()))
  return dx


def _sync(t: torch.Tensor) -> None:
  if t.is_cuda:
    torch.cuda.synchronize(t.device)


def make_one_step(sem, cfg: DatagenConfig, exact_solves: bool = True):
  """The el datagen step ``(us, ps, cus) -> (u, p, cu, aux)``.

  `exact_solves=True` is the datagen step (FDM inverses trusted outright);
  False seeds the viscous CG with the FDM inverse and certifies it, which
  runs the stiffness apply.
  """
  if sem.fast_ops is None or not sem._fully_periodic:  # pylint: disable=protected-access
    raise NotImplementedError(
        'the datagen step runs on fully periodic structured boxes (the el '
        'path); walled boxes take StokesSEM.stokes_one_step')
  mu = 1.0 / cfg.reynolds_number
  ext = [float(c) for c in navier_stokes.extk_coeffs(k=cfg.time_order - 1)]
  ops = sem.fast_ops
  info = ops.vinfo
  kk = info.order + 1
  n = info.num_elements_per_dim
  eshape = (n,) * info.ndim
  num_e = n ** info.ndim
  wmass_el = ops.wmass.reshape((kk,) * info.ndim + eshape)
  coords = sem.velocity.mesh.node_coords
  fbody_el = sem.velocity_to_el(
      (torch.sin(2 * np.pi * cfg.forcing_wavenumber * coords[..., 1]),))[0]
  vp_el, pp_el = sem.fdm_el_preconditioners(mu, cfg.dt, cfg.time_order)

  def conv_el(ut):
    flat = [c.reshape((kk,) * info.ndim + (num_e,)) for c in ut]
    outs = ops.convection_el(*flat)
    return tuple(o.reshape((kk,) * info.ndim + eshape) for o in outs)

  def one_step(us, ps, cus):
    cu = tree_map(
        lambda *xs: sum(e * x for e, x in zip(ext[::-1], xs[::-1])), *cus)
    f_el = kolmogorov_el_forcing(cfg, wmass_el, fbody_el, us[-1], cu)
    u, p, aux = sem.stokes_one_step_el(
        list(us), list(ps), f_el, mu=mu, dt=cfg.dt,
        time_order=cfg.time_order, tol=1e-5, atol=1e-4,
        pressure_preconditioner_el=pp_el, viscous_preconditioner_el=vp_el,
        exact_solves=exact_solves)
    return u, p, conv_el(u), aux

  one_step.conv_el = conv_el
  return one_step


def make_step_fn(sem, cfg: DatagenConfig, exact_solves: bool = True):
  """``advance(us, ps, cus) -> ((us, ps, cus), (u_frames, p_frames))``.

  Runs one cycle of `num_steps_per_cycle` steps and keeps the state after
  every `snapshot_every` steps as a frame (device tensors).
  """
  one_step = make_one_step(sem, cfg, exact_solves=exact_solves)

  def advance(us, ps, cus):
    u_frames, p_frames = [], []
    for i in range(cfg.num_steps_per_cycle):
      u, p, cu, _ = one_step(us, ps, cus)
      us, ps, cus = us[1:] + (u,), ps[1:] + (p,), cus[1:] + (cu,)
      if (i + 1) % cfg.snapshot_every == 0:
        u_frames.append(u)
        p_frames.append(p)
    return (us, ps, cus), (u_frames, p_frames)

  advance.one_step = one_step
  return advance


def one_cycle(sem, cfg: DatagenConfig, advance, start_step, us, ps, cus,
              workdir: str | None):
  """Runs one cycle; writes its frames to an HDF5 shard under `workdir`.

  With `workdir=None` nothing is written.  Returns
  ``(us, ps, cus, wall_seconds, frames)`` where `frames` holds the host
  arrays ``t``, ``u``, ``p`` of the shard.
  """
  def u_np(u):
    return np.stack([c.cpu().numpy() for c in sem.velocity_from_el(u)],
                    axis=-1)

  def p_np(p):
    return sem.pressure_from_el(p).cpu().numpy()

  t = start_step * cfg.dt
  us_init_u, ps_init_p = us[-1], ps[-1]
  _sync(ps[-1])
  start_time = time.perf_counter()
  (us, ps, cus), (u_frames, p_frames) = advance(us, ps, cus)
  _sync(ps[-1])
  wall = time.perf_counter() - start_time
  log.info('one cycle walltime %f seconds', wall)
  frames = {'t': [t], 'u': [u_np(us_init_u)], 'p': [p_np(ps_init_p)]}
  for u, p in zip(u_frames, p_frames):
    t += cfg.snapshot_every * cfg.dt
    frames['t'].append(t)
    frames['u'].append(u_np(u))
    frames['p'].append(p_np(p))
  frames = {key: np.stack(val) for key, val in frames.items()}

  if workdir is not None:
    write_shard(workdir, cfg, start_step, frames)
  return us, ps, cus, wall, frames


def write_shard(workdir: str, cfg: DatagenConfig, start_step: int,
                frames: dict) -> str:
  """Writes one cycle's frames (``t``, ``u``, ``p``) to its HDF5 shard."""
  import h5py  # only the shard writer needs it
  end_step = start_step + cfg.num_steps_per_cycle
  path = os.path.join(
      workdir,
      f'{cfg.split}_kolmogorov_grid_{cfg.resolution}_order_{cfg.order}'
      f'_step_{start_step}_{end_step}.h5')
  with h5py.File(path, 'w') as f:
    for key, val in frames.items():
      f[key] = val
  log.info('wrote %s', path)
  return path


def initial_state(sem, cfg: DatagenConfig):
  """The el-form history ``(us, ps, cus)`` of the deterministic start.

  `cfg.seed` adds a 1e-3 perturbation drawn with numpy from that seed.
  """
  coords = sem.velocity.mesh.node_coords.cpu().numpy()
  u0 = u_init(coords)
  if cfg.seed:
    rng = np.random.default_rng(cfg.seed)
    u0 = u0 + 1e-3 * rng.standard_normal(u0.shape)
  u0 = sem.velocity_to_el((u0[:, 0], u0[:, 1]))
  p0 = sem.pressure_to_el(np.zeros(sem.pressure.pspace.mesh.num_nodes))
  ops, info = sem.fast_ops, sem.fast_ops.vinfo
  num_e = info.num_elements_per_dim ** info.ndim
  kk = info.order + 1
  flat = [c.reshape((kk,) * info.ndim + (num_e,)) for c in u0]
  c0 = tuple(o.reshape(u0[0].shape) for o in ops.convection_el(*flat))
  return ((u0,) * cfg.time_order, (p0,) * cfg.time_order,
          (c0,) * cfg.time_order)


def build_solver(cfg: DatagenConfig, *, device: torch.device | str,
                 dtype: torch.dtype):
  """The datagen solver: built on the host, its step fields on `device`."""
  premesh = unit_cube_mesh(cfg.resolution, ndim=2, periodic_dims=(0, 1))
  return navier_stokes.StokesSEM.create(premesh, boundary_conditions={},
                                        order=cfg.order, device=device,
                                        dtype=dtype)


def run_simulation(workdir: str | None, cfg: DatagenConfig | None = None, *,
                   device: torch.device | str, dtype: torch.dtype,
                   frames_out: list | None = None):
  """Full DNS run: `num_cycles` cycles of `num_steps_per_cycle` steps.

  Builds the solver on the host and moves its step fields to `device`.
  Returns ``(cycle_walls, sem, state)``: the per-cycle walltimes in seconds
  (excluding the host-side frame conversion and HDF5 write), the solver,
  and the final el-form history ``(us, ps, cus)``.  `workdir=None` writes
  no shards.  `frames_out`, a list, receives each cycle's frames (the
  shard's ``t``, ``u``, ``p`` arrays), which the training input pipeline
  reads in memory.
  """
  cfg = cfg or DatagenConfig()
  sem = build_solver(cfg, device=device, dtype=dtype)
  dx = min_node_spacing(sem.velocity.mesh)
  log.info('mesh: %d nodes, %d elements, dx=%f',
           sem.velocity.mesh.num_nodes, sem.velocity.mesh.num_elements, dx)
  us, ps, cus = initial_state(sem, cfg)
  advance = make_step_fn(sem, cfg)
  if workdir is not None:
    os.makedirs(workdir, exist_ok=True)
  for _ in range(cfg.warmup_cycles):
    (us, ps, cus), _ = advance(us, ps, cus)
  if cfg.warmup_cycles:
    log.info('warmup: %d cycles (t = %f) discarded', cfg.warmup_cycles,
             cfg.warmup_cycles * cfg.num_steps_per_cycle * cfg.dt)
  cycle_walls = []
  for cycle in range(cfg.warmup_cycles, cfg.warmup_cycles + cfg.num_cycles):
    us, ps, cus, wall, frames = one_cycle(sem, cfg, advance,
                                          cycle * cfg.num_steps_per_cycle,
                                          us, ps, cus, workdir)
    cycle_walls.append(wall)
    if frames_out is not None:
      frames_out.append(frames)
    u_last = sem.velocity_from_el(us[-1])
    cfl = max(float(c.abs().max()) for c in u_last) * cfg.dt / dx
    log.info('cycle %d: CFL %f', cycle, cfl)
  log.info('datagen complete')
  return cycle_walls, sem, (us, ps, cus)


def main(argv=None):
  import argparse
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--workdir', required=True,
                      help='Output directory for HDF5 shards.')
  args = parser.parse_args(argv)
  logging.basicConfig(level=logging.INFO)
  run_simulation(args.workdir, device='cuda', dtype=torch.float32)


if __name__ == '__main__':
  main()

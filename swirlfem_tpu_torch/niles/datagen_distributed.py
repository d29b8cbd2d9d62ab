"""Distributed DNS data generation: Kolmogorov flow on slab-sharded ranks.

Counterpart of ``swirlfem_tpu/niles/datagen_distributed.py``.  The
single-device datagen (`niles.datagen`) steps the whole element grid on
one device; this module shards the same workload over P ranks through
`nse.distributed`: the solver is built once on the host, each rank gets
its slab (`split_box`) and runs the halo-exchange fractional step with the
slab-decomposed exact FDM solves, in an eager loop (in place of the JAX
package's two ``lax.scan``s).  Frames come back to the host once the run
ends, are joined (`unshard_el`) and written to the shard format the input
pipeline reads.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from swirlfem_tpu_torch.linalg.cg import tree_map
from swirlfem_tpu_torch.niles import datagen
from swirlfem_tpu_torch.nse import solver as navier_stokes
from swirlfem_tpu_torch.nse.distributed import DistributedStokesBox
from swirlfem_tpu_torch.nse.distributed import shard_el
from swirlfem_tpu_torch.nse.distributed import split_box
from swirlfem_tpu_torch.nse.distributed import unshard_el
from swirlfem_tpu_torch.parallel import spmd

log = logging.getLogger(__name__)


def make_distributed_step_fn(dist: DistributedStokesBox,
                             cfg: datagen.DatagenConfig, fbody_el,
                             exact_solves: bool = True):
  """``advance(us, ps, cus) -> ((us, ps, cus), (u_frames, p_frames))`` on
  this rank's slabs: one cycle of `num_steps_per_cycle` steps, keeping the
  state after every `snapshot_every` steps.

  The step of ``datagen.make_one_step``: extrapolated dealiased convection
  plus the Kolmogorov body force `fbody_el` minus drag, as a mass-weighted
  el covector, then the distributed fractional step with exact FDM solves
  (or, with `exact_solves=False`, FDM-seeded CG, which runs the stiffness
  on every rank).
  """
  mu = 1.0 / cfg.reynolds_number
  ext = [float(c) for c in navier_stokes.extk_coeffs(k=cfg.time_order - 1)]
  wmass_el = dist.wmass_el()
  step = dist.make_step(mu=mu, dt=cfg.dt, time_order=cfg.time_order,
                        tol=1e-5, atol=1e-4, preconditioner='fdm',
                        exact_solves=exact_solves)
  conv = dist.make_advection()

  def one_step(us, ps, cus):
    cu = tree_map(
        lambda *xs: sum(e * x for e, x in zip(ext[::-1], xs[::-1])), *cus)
    f_el = datagen.kolmogorov_el_forcing(cfg, wmass_el, fbody_el, us[-1], cu)
    u, p, aux = step(list(us), list(ps), f_el)
    return u, p, conv(u), aux

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


def _sync(device) -> None:
  if torch.device(device).type == 'cuda':
    torch.cuda.synchronize(device)


def run_rank(ax, shard, *, cfg: datagen.DatagenConfig, device, dtype,
             exact_solves: bool = True) -> dict:
  """One rank of `run_simulation_distributed` (a `spmd.launch` function).

  Returns the rank's per-cycle walls, its frames (el slabs: each cycle's
  start and snapshots), its final history, and per step the collectives
  and host-staged bytes of its `Axis`.
  """
  dist = DistributedStokesBox(shard['slab'], ax, device=device, dtype=dtype)
  u0 = dist.to_device(shard['u0'])
  p0 = dist.to_device(shard['p0'])
  fbody = dist.to_device(shard['fbody'])
  c0 = dist.make_advection()(u0)
  order = cfg.time_order
  us, ps, cus = (u0,) * order, (p0,) * order, (c0,) * order
  advance = make_distributed_step_fn(dist, cfg, fbody,
                                     exact_solves=exact_solves)
  for _ in range(cfg.warmup_cycles):
    (us, ps, cus), _ = advance(us, ps, cus)
  walls, frames = [], []
  ax.reset_stats()
  for _ in range(cfg.num_cycles):
    start = (us[-1], ps[-1])
    _sync(device)
    t0 = time.perf_counter()
    (us, ps, cus), (u_frames, p_frames) = advance(us, ps, cus)
    _sync(device)
    walls.append(time.perf_counter() - t0)
    frames.append({'u': [start[0]] + u_frames, 'p': [start[1]] + p_frames})
  steps = cfg.num_cycles * cfg.num_steps_per_cycle
  return {'walls': walls, 'frames': frames, 'state': (us, ps, cus),
          'collectives_per_step': ax.stats['collectives'] / steps,
          'host_bytes_per_step': ax.stats['host_bytes'] / steps}


def shard_inputs(sem, cfg: datagen.DatagenConfig, num_ranks: int) -> list:
  """Each rank's `spmd.launch` shard: its `BoxSlab`, its slabs of the
  start (``datagen.initial_state``'s velocity and pressure) and of the
  body force."""
  d = sem.velocity.mesh.ndim
  us, ps, _ = datagen.initial_state(sem, cfg)
  coords = sem.velocity.mesh.node_coords
  fbody = sem.velocity_to_el(
      (torch.sin(2 * np.pi * cfg.forcing_wavenumber * coords[..., 1]),))[0]
  slabs = split_box(sem, num_ranks, dt=cfg.dt, time_order=cfg.time_order)
  return [{'slab': slabs[r], 'u0': shard_el(us[-1], r, num_ranks, d),
           'p0': shard_el(ps[-1], r, num_ranks, d),
           'fbody': shard_el(fbody, r, num_ranks, d)}
          for r in range(num_ranks)]


def run_simulation_distributed(workdir: str | None,
                               cfg: datagen.DatagenConfig | None = None, *,
                               device: torch.device | str,
                               dtype: torch.dtype, num_ranks: int = 4,
                               exact_solves: bool = True,
                               frames_out: list | None = None,
                               timeout: float = 1800.0, sem=None):
  """The distributed DNS run: `num_ranks` ranks, each on `device`, which
  the caller names with `dtype` (no default: a caller who did not ask for
  the CPU does not land on it).

  The solver is built once on the host (CPU, float64) and each rank gets
  its slab as numpy arrays.  On a CUDA device the kernels are built here,
  before the ranks start, and every rank shares that device.  With
  `workdir` each cycle's frames go to an HDF5 shard of the single-device
  layout; `workdir=None` writes nothing.  `frames_out`, a list, receives
  each cycle's nodal frames (``t``, ``u``, ``p``).  `sem`, the datagen
  solver of `cfg` (`datagen.build_solver`), is built here when None.

  Returns ``(cycle_walls, sem, state, stats)``: rank 0's walltime per
  cycle (seconds), the host solver, the final el history ``(us, ps, cus)``
  joined over the ranks (numpy), and rank 0's collectives and host-staged
  bytes per step.
  """
  cfg = cfg or datagen.DatagenConfig()
  if sem is None:
    sem = datagen.build_solver(cfg, device='cpu', dtype=torch.float64)
  d = sem.velocity.mesh.ndim
  log.info('distributed mesh: %d nodes over %d ranks',
           sem.velocity.mesh.num_nodes, num_ranks)
  shards = shard_inputs(sem, cfg, num_ranks)
  if torch.device(device).type == 'cuda':
    from swirlfem_tpu_torch.ops import cuda_build
    cuda_build.library()  # once, before the ranks start
  outs = spmd.launch(run_rank, shards, cfg=cfg, device=str(device),
                     dtype=dtype, exact_solves=exact_solves,
                     timeout=timeout)

  def u_np(slabs):
    u_el = unshard_el(slabs, d)
    return np.stack([c.numpy() for c in sem.velocity_from_el(
        tuple(torch.as_tensor(c) for c in u_el))], axis=-1)

  def p_np(slabs):
    return sem.pressure_from_el(torch.as_tensor(unshard_el(slabs, d))).numpy()

  for cycle in range(cfg.num_cycles):
    start_step = (cfg.warmup_cycles + cycle) * cfg.num_steps_per_cycle
    per_rank = [o['frames'][cycle] for o in outs]
    num = len(per_rank[0]['u'])
    times = [start_step * cfg.dt]
    for _ in range(num - 1):  # accumulated as `datagen.one_cycle` does
      times.append(times[-1] + cfg.snapshot_every * cfg.dt)
    frames = {
        't': np.asarray(times),
        'u': np.stack([u_np([f['u'][i] for f in per_rank])
                       for i in range(num)]),
        'p': np.stack([p_np([f['p'][i] for f in per_rank])
                       for i in range(num)])}
    if workdir is not None:
      os.makedirs(workdir, exist_ok=True)
      datagen.write_shard(workdir, cfg, start_step, frames)
    if frames_out is not None:
      frames_out.append(frames)
  state = tuple(
      tuple(unshard_el([o['state'][j][i] for o in outs], d)
            for i in range(cfg.time_order))
      for j in range(3))
  stats = {key: outs[0][key]
           for key in ('collectives_per_step', 'host_bytes_per_step')}
  log.info('distributed datagen complete')
  return outs[0]['walls'], sem, state, stats

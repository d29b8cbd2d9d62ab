"""Flow past a cylinder: Karman vortex shedding (Schaefer-Turek 2D-2/2D-3).

Counterpart of ``swirlfem_tpu/examples/cylinder.py``.  Channel 2.2 x 0.41
with a cylinder of diameter 0.1 at (0.2, 0.2); parabolic inflow with mean
velocity 1.0 gives Re = 100, where the wake sheds at St = f D / U ~ 0.30
(Schaefer & Turek 1996).  Runs the unstructured path end to end: the
programmatic O-grid mesh (utils.cylinder), the blended circle snap, the
Dirichlet lift, the do-nothing outflow, the generic operators with the
assembled divergence (or, with ``unstructured_el_ops=True``, the E-last
element operators and their general stiffness kernel), the dense Schur
pressure inverse or, past its range, the two-level Schwarz preconditioner
(`schwarz_preconditioner`), and the Fischer solve history.

Usage (the card unless ``--device cpu``)::

  python -m swirlfem_tpu_torch.examples.cylinder --num-steps 40000 \
      --max-seconds 1080 --out cylinder.json

The JAX package's large mesh (``experiments/large_cylinder_campaign.py``:
912 elements, order 6, 22,800 pressure dofs, dt at CFL 0.65, the two-level
Schwarz preconditioner)::

  python -m swirlfem_tpu_torch.examples.cylinder --order 6 --ns 12 --nr 8 \
      --nx-up 2 --nx-down 28 --ny-low 2 --ny-high 2 --cfl 0.65 \
      --pressure-precond schwarz --kick-steps 30000 --out large.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from swirlfem_tpu_torch.core.bc import BCType
from swirlfem_tpu_torch.nse.solver import bdfk_coeffs
from swirlfem_tpu_torch.nse.solver import extk_coeffs
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.utils.cylinder import cylinder_channel_premesh
from swirlfem_tpu_torch.utils.cylinder import make_cylinder_snap

RADIUS = 0.05
CENTER = (0.2, 0.2)
HEIGHT = 0.41
MEAN_VELOCITY = 1.0  # Re = U * D / nu = 100 at nu = 1e-3


# 'outflow' unmasked: natural (do-nothing) outflow.
BOUNDARY_CONDITIONS = {
    'cylinder': (BCType.DIRICHLET, 0.0),
    'walls': (BCType.DIRICHLET, 0.0),
    'inflow': (BCType.DIRICHLET, 0.0),
}
# The JAX package's large mesh (``experiments/large_cylinder_campaign.py``):
# 912 elements; at order 6, 22,800 pressure dofs, past the dense inverse.
LARGE = dict(ns=12, nr=8, nx_up=2, nx_down=28, ny_low=2, ny_high=2)


def make_cylinder_sem(order: int = 5, ns: int = 6, nr: int = 4,
                      nx_down: int = 14, *, nx_up: int = 1, ny_low: int = 1,
                      ny_high: int = 1, device='cuda',
                      dtype: torch.dtype = torch.float32,
                      **create_kwargs) -> StokesSEM:
  """The Schaefer-Turek channel at `order` on `device` (the card by
  default); `create_kwargs` go to `StokesSEM.create` (for one,
  ``unstructured_el_ops=True``)."""
  premesh = cylinder_channel_premesh(ns=ns, nr=nr, nx_up=nx_up,
                                     nx_down=nx_down, ny_low=ny_low,
                                     ny_high=ny_high)
  snap = make_cylinder_snap(premesh, radius=RADIUS, center=CENTER)
  return StokesSEM.create(premesh, boundary_conditions=BOUNDARY_CONDITIONS,
                          order=order, coord_transform=snap, device=device,
                          dtype=dtype, **create_kwargs)


def schwarz_preconditioner(sem: StokesSEM, dt: float, time_order: int = 2,
                           **mesh):
  """The two-level Schwarz pressure preconditioner of the channel `sem` was
  made on (`mesh`: the `cylinder_channel_premesh` arguments it was made
  with), with its defaults: overlap 1, the p1dg coarse space up to 16,000
  coarse dofs."""
  return sem.schwarz_pressure_preconditioner(
      cylinder_channel_premesh(**mesh), BOUNDARY_CONDITIONS, dt, time_order)


def cfl_dt(sem: StokesSEM, cfl: float = 0.65) -> float:
  """The step at convective CFL `cfl` on the mesh's spacing, ``cfl dx_min /
  2.2`` (2.2: the peak inflow with a margin), as the JAX package's large
  cylinder campaign sets it (0.65)."""
  from swirlfem_tpu_torch.niles.datagen import min_node_spacing
  return float(cfl * min_node_spacing(sem.velocity.mesh) / 2.2)


def inflow_boundary_field(sem: StokesSEM,
                          mean_velocity: float = MEAN_VELOCITY
                          ) -> torch.Tensor:
  """Parabolic inflow profile on the x=0 plane, zero elsewhere, ``(N, 2)``
  on the solver's device."""
  mesh = sem.velocity.mesh
  coords = mesh.node_coords.numpy()
  on_inflow = mesh.physical_masks['inflow'].numpy() > 0
  y = coords[:, 1]
  profile = 6.0 * mean_velocity * y * (HEIGHT - y) / HEIGHT ** 2
  ub = np.zeros_like(coords)
  ub[:, 0] = np.where(on_inflow, profile, 0.0)
  return torch.as_tensor(ub, dtype=sem.dtype, device=sem.device)


def probe_index(sem: StokesSEM,
                point: tuple[float, float] = (0.35, 0.2)) -> int:
  """Nearest velocity node to a wake probe point."""
  coords = sem.velocity.mesh.node_coords.numpy()
  return int(np.argmin(np.sum((coords - np.asarray(point)) ** 2, axis=-1)))


def _history(sem: StokesSEM, u0: torch.Tensor, time_order: int):
  npn = sem.pressure.pspace.mesh.num_nodes
  p0 = torch.zeros(npn, dtype=sem.dtype, device=sem.device)
  return (u0,) * time_order, (p0,) * time_order


def check_cfl(sem: StokesSEM, dt: float) -> float:
  """Asserts the convective CFL ``u_max dt / dx_min < 0.75`` on the mesh's
  spacing (``u_max`` = 1.5 x the mean inflow, with a margin) and returns it.

  Hard-won in the JAX package: above ~0.7 the extrapolated-convection
  scheme leaves the wake silently attached at any Reynolds number (CFL 2.4
  at dt = 1e-3 on the order-5 mesh gave a steady wake; dt = 2.5e-4 sheds).
  """
  from swirlfem_tpu_torch.niles.datagen import min_node_spacing
  cfl = 2.2 * MEAN_VELOCITY * dt / min_node_spacing(sem.velocity.mesh)
  assert cfl < 0.75, (
      f'CFL {cfl:.2f} too large: reduce dt below {0.7 * dt / cfl:.1e}')
  return cfl


def run_cylinder(sem: StokesSEM, reynolds: float = 100.0,
                 dt: float = 2.5e-4, num_steps: int = 100,
                 time_order: int = 2, tol: float = 1e-6,
                 probe: int | None = None):
  """Time-steps from rest; returns ``(u, p, probe trace of cross-stream
  u_y)``, with the dense Schur pressure inverse.  The CFL is asserted
  (`check_cfl`)."""
  check_cfl(sem, dt)
  nv = sem.velocity.mesh.num_nodes
  u_boundary = inflow_boundary_field(sem)
  ext = [float(c) for c in extk_coeffs(k=time_order - 1)]
  if probe is None:
    probe = probe_index(sem)
  us, ps = _history(sem, torch.zeros((nv, 2), dtype=sem.dtype,
                                     device=sem.device), time_order)
  cus = tuple(sem.C(u + u_boundary) for u in us)
  mu = MEAN_VELOCITY * 2 * RADIUS / reynolds
  # Exact dense Schur inverse: the pressure CG needs ~2000 iterations a
  # step unpreconditioned on this mesh, O(1) with it.
  precond = sem.dense_pressure_preconditioner(dt, time_order)
  trace = []
  for _ in range(num_steps):
    cu = sum(ext[-i] * cus[-i] for i in range(1, len(ext) + 1))
    u, p, _ = sem.stokes_one_step(
        list(us), list(ps), -cu, mu=mu, dt=dt, time_order=time_order,
        u_boundary=u_boundary, tol=tol, atol=tol * 1e-2,
        pressure_preconditioner=precond, project_out_nullspace=False)
    us, ps, cus = us[1:] + (u - u_boundary,), ps[1:] + (p,), cus[1:] + (
        sem.C(u),)
    trace.append(u[probe, 1])
  return us[-1] + u_boundary, ps[-1], torch.stack(trace).cpu().numpy()


def strouhal_number(trace: np.ndarray, dt: float,
                    mean_velocity: float = MEAN_VELOCITY) -> float:
  """St = f D / U from the dominant FFT peak of the probe trace's second
  half (Hann window, log-parabolic peak interpolation)."""
  tail = trace[len(trace) // 2:]
  tail = tail - tail.mean()
  freqs = np.fft.rfftfreq(len(tail), d=dt)
  spectrum = np.abs(np.fft.rfft(tail * np.hanning(len(tail))))
  k = int(np.argmax(spectrum[1:])) + 1
  f = freqs[k]
  if 1 <= k < len(spectrum) - 1 and spectrum[k - 1] > 0 and spectrum[k + 1] > 0:
    a, b, c = np.log(spectrum[k - 1: k + 2])
    denom = a - 2 * b + c
    if denom < 0:  # genuine local max
      f = (k + 0.5 * (a - c) / denom) * (freqs[1] - freqs[0])
  return float(f * 2 * RADIUS / mean_velocity)


def run_cylinder_scan(sem: StokesSEM, reynolds: float = 100.0,
                      dt: float = 2.5e-4, num_steps: int = 40000,
                      steps_per_dispatch: int = 200, time_order: int = 2,
                      tol: float = 1e-5, probe: int | None = None,
                      perturb: float = 1e-2, log_every: int | None = None,
                      kick_amplitude: float = 0.3,
                      kick_steps: int = 12000,
                      compute_forces: bool = False,
                      pressure_preconditioner=None,
                      use_projection: bool = True,
                      checkpoint_path: str | None = None,
                      checkpoint_every: int = 20,
                      alpha: float = 0.05,
                      max_seconds: float | None = None,
                      telemetry: dict | None = None,
                      on_chunk=None):
  """Long shedding run in chunks of `steps_per_dispatch` steps.

  Returns ``(u, p, trace)`` with the per-step probe trace of the
  cross-stream velocity, or with ``compute_forces=True`` ``(u, p, trace,
  forces)``: the per-step ``(steps, 2)`` consistent-flux reaction force on
  the cylinder (`reaction_force`; Schaefer-Turek coefficients ``C = 2 F /
  (rho Ubar^2 D)`` with ``Ubar = 1``, ``D = 0.1``).  A transient
  cross-stream kick force behind the cylinder for the first `kick_steps`
  steps seeds the Karman mode.  A chunk is the unit of the host's logs
  (every `log_every` chunks), of the trace's device-to-host copies and of
  the npz checkpoint (every `checkpoint_every` chunks; a run given an
  existing `checkpoint_path` resumes at its chunk; the solve history is
  not saved, it only warm-starts CG).  `num_steps` must be a multiple of
  `steps_per_dispatch`.  With `max_seconds` the run stops after the chunk
  in which that much wall time has passed (the trace is then shorter).
  `telemetry`, a dict, receives the per-step CG iterations
  (``viscous_iterations``, ``pressure_iterations``), the stepping's wall
  seconds, the steps run and the final ``history`` ``(us, ps, cus)``
  (`continue_cylinder` steps on from it).  `on_chunk`, where given, is called after each
  chunk (its log and checkpoint) with the number of steps done since step
  0: a hook for timing or profiling a window of the live loop.
  The CFL is asserted (`check_cfl`).
  """
  check_cfl(sem, dt)
  if num_steps % steps_per_dispatch:
    raise ValueError(
        f'num_steps={num_steps} is not a multiple of '
        f'steps_per_dispatch={steps_per_dispatch}: the trailing '
        f'{num_steps % steps_per_dispatch} steps would be silently dropped')

  coords = sem.velocity.mesh.node_coords.numpy()
  like = dict(dtype=sem.dtype, device=sem.device)
  u_boundary = inflow_boundary_field(sem)
  ext = [float(c) for c in extk_coeffs(k=time_order - 1)]
  if probe is None:
    probe = probe_index(sem)
  mu = MEAN_VELOCITY * 2 * RADIUS / reynolds

  # Perturbation: a localized swirl behind the cylinder, zero on boundaries.
  mask = np.asarray(sem.velocity.interior_mask)[:, 0]
  bump = perturb * np.exp(
      -(((coords[:, 0] - 0.3) / 0.05) ** 2
        + ((coords[:, 1] - 0.22) / 0.05) ** 2))
  u0 = torch.as_tensor(np.stack([np.zeros_like(bump), bump * mask], axis=-1),
                       **like)
  us, ps = _history(sem, u0, time_order)
  # Convection covectors are stored UNMASKED: the step's forcing masks the
  # Dirichlet rows, while the reaction force needs exactly those rows.
  vel = sem.nodal.velocity

  def raw_convection(u):
    return vel.scatter(vel.C_local(vel.gather(u)))

  cus = tuple(raw_convection(u + u_boundary) for u in us)
  precond = pressure_preconditioner
  if precond is None:
    precond = sem.dense_pressure_preconditioner(dt, time_order)

  kick = kick_amplitude * np.exp(
      -(((coords[:, 0] - 0.3) / 0.05) ** 2
        + ((coords[:, 1] - 0.2) / 0.05) ** 2)) * mask
  f_kick = sem.B(torch.as_tensor(
      np.stack([np.zeros_like(kick), kick], axis=-1), **like))
  imask = vel.interior_mask
  proj0 = sem.initial_projection_state() if use_projection else None

  trace, forces = [], []
  carry = (us, ps, cus, proj0)
  start_chunk = 0
  if checkpoint_path and os.path.exists(checkpoint_path):
    ck = np.load(checkpoint_path)
    if int(ck['steps_per_dispatch']) != steps_per_dispatch:
      raise ValueError(
          f'checkpoint was written with steps_per_dispatch='
          f'{int(ck["steps_per_dispatch"])}, resume requested '
          f'{steps_per_dispatch}; chunk indices would misalign')
    start_chunk = int(ck['chunk'])
    load = lambda key: tuple(torch.as_tensor(a, **like) for a in ck[key])
    carry = (load('us'), load('ps'), load('cus'), proj0)
    trace = [ck['trace']] if ck['trace'].size else []
    forces = [ck['forces']] if ck['forces'].size else []
    print(f'resuming from checkpoint at chunk {start_chunk} '
          f'({start_chunk * steps_per_dispatch} steps)', flush=True)

  v_iters, p_iters = [], []
  t0 = time.perf_counter()
  done = 0
  for i in range(start_chunk, num_steps // steps_per_dispatch):
    us, ps, cus, proj = carry
    tr, fr = [], []
    for k in range(steps_per_dispatch):
      cu = sum(ext[-j] * cus[-j] for j in range(1, len(ext) + 1))
      f = -imask * cu
      if i * steps_per_dispatch + k < kick_steps:
        f = f + f_kick
      u, p, aux = sem.stokes_one_step(
          list(us), list(ps), f, mu=mu, dt=dt, time_order=time_order,
          alpha=alpha, u_boundary=u_boundary, tol=tol, atol=tol * 1e-2,
          pressure_preconditioner=precond, project_out_nullspace=False,
          projection_state=proj)
      v_iters.append(aux['u_star_info']['num_iterations'])
      p_iters.append(aux['dp_info']['num_iterations'])
      if compute_forces:
        full = [w + u_boundary for w in us] + [u]
        fr.append(reaction_force(sem, full, p, 0.0, mu=mu, dt=dt,
                                 convection=cu))
      us, ps = us[1:] + (u - u_boundary,), ps[1:] + (p,)
      cus = cus[1:] + (raw_convection(u),)
      proj = aux.get('projection_state', proj)
      tr.append(u[probe, 1])
    carry = (us, ps, cus, proj)
    done += steps_per_dispatch
    # One device-to-host copy a chunk for the trace and the forces.
    trace.append(torch.stack(tr).cpu().numpy())
    if compute_forces:
      forces.append(torch.stack(fr).cpu().numpy())
    wall = time.perf_counter() - t0
    if log_every and (i + 1) % log_every == 0:
      print(f'step {(i + 1) * steps_per_dispatch}: '
            f'probe={trace[-1][-1]:+.4f} '
            f'({wall / done * 1e3:.2f} ms/step)', flush=True)
    if checkpoint_path and (i + 1) % checkpoint_every == 0:
      tmp = checkpoint_path + '.tmp.npz'
      host = lambda ts: np.stack([t.cpu().numpy() for t in ts])
      with open(tmp, 'wb') as fh:
        np.savez(fh, chunk=i + 1, steps_per_dispatch=steps_per_dispatch,
                 us=host(us), ps=host(ps), cus=host(cus),
                 trace=np.concatenate(trace),
                 forces=(np.concatenate(forces) if forces
                         else np.zeros((0, 2))))
      os.replace(tmp, checkpoint_path)
    if on_chunk is not None:
      on_chunk((i + 1) * steps_per_dispatch)
    if max_seconds is not None and wall >= max_seconds:
      break
  if telemetry is not None:
    telemetry.update(viscous_iterations=v_iters, pressure_iterations=p_iters,
                     seconds=time.perf_counter() - t0, steps=done,
                     history=carry[:3])
  us, ps = carry[0], carry[1]
  out = (us[-1] + u_boundary, ps[-1], np.concatenate(trace))
  if compute_forces:
    out = out + (np.concatenate(forces),)
  return out


def continue_cylinder(sem: StokesSEM, history, num_steps: int, *,
                      reynolds: float = 100.0, dt: float, time_order: int = 2,
                      tol: float = 1e-5, alpha: float = 0.05,
                      maxiter: int | None = None,
                      pressure_preconditioner=None):
  """`num_steps` more steps (no kick, no solve history) from the history
  ``(us, ps, cus)`` a `run_cylinder_scan` run left in its telemetry.
  Returns ``(u, p, pressure CG iterations a step)``."""
  us, ps, cus = history
  u_boundary = inflow_boundary_field(sem)
  ext = [float(c) for c in extk_coeffs(k=time_order - 1)]
  mu = MEAN_VELOCITY * 2 * RADIUS / reynolds
  vel = sem.nodal.velocity
  p_iters = []
  for _ in range(num_steps):
    cu = sum(ext[-j] * cus[-j] for j in range(1, len(ext) + 1))
    u, p, aux = sem.stokes_one_step(
        list(us), list(ps), -vel.interior_mask * cu, mu=mu, dt=dt,
        time_order=time_order, alpha=alpha, u_boundary=u_boundary, tol=tol,
        atol=tol * 1e-2, maxiter=maxiter,
        pressure_preconditioner=pressure_preconditioner,
        project_out_nullspace=False)
    p_iters.append(aux['dp_info']['num_iterations'])
    us, ps = us[1:] + (u - u_boundary,), ps[1:] + (p,)
    cus = cus[1:] + (vel.scatter(vel.C_local(vel.gather(u))),)
  return u, p, p_iters


def reaction_force(sem: StokesSEM, us, p, f=0.0, *, mu: float, dt: float,
                   group: str = 'cylinder', convection=None):
  """Discrete reaction force the fluid exerts on a Dirichlet boundary.

  The consistent-flux evaluation: at Dirichlet nodes the row-elided
  momentum equations are not enforced, and their UNMASKED residual is the
  nodal reaction covector; the force ON the body is its negative, summed
  over the group's nodes:

      F = - sum_{wall nodes} [B du/dt + C_ext + mu A u - D^T p - f]

  Args:
    us: BDF velocity history, newest (the just-computed step) LAST, each a
      nodal ``(N, d)`` tensor INCLUDING the boundary lift; ``len(us) - 1``
      is the BDF order.
    p: the pressure produced by the same step.
    f: the external-forcing covector EXCLUDING convection (unmasked).
    convection: optional explicit unmasked convection covector; by default
      the extrapolation the step used is rebuilt from ``us[:-1]``.

  Returns the d-vector force (a tensor on the solver's device).
  """
  vel = sem.nodal.velocity
  k = len(us) - 1
  if k < 1:
    raise ValueError('us must hold the BDF history plus the new state')
  coeffs = [float(c) for c in bdfk_coeffs(k)]
  dudt = sum(c * u for c, u in zip(coeffs, us)) / dt

  if convection is None:
    ext = [float(c) for c in extk_coeffs(k=k - 1)] if k > 1 else [1.0]
    convection = sum(e * vel.scatter(vel.C_local(vel.gather(u)))
                     for e, u in zip(ext, us[:-1]))

  b_term = vel.scatter(vel.B_local(vel.gather(dudt)))
  a_term = vel.scatter(vel.A_local(vel.gather(us[-1])))
  dt_term = vel.scatter(sem.Dt_local(sem.nodal.pressure.gather(p)))
  residual = b_term + convection + mu * a_term - dt_term
  if not (isinstance(f, (int, float)) and f == 0):
    residual = residual - f
  on_wall = vel.mesh.physical_masks[group] > 0
  return -(residual * on_wall[:, None]).sum(dim=0)


def main(argv=None) -> dict:
  """Runs `run_cylinder_scan` on the default configuration and reports the
  shedding: St, the force coefficients and the step times."""
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--order', type=int, default=5)
  parser.add_argument('--ns', type=int, default=6)
  parser.add_argument('--nr', type=int, default=4)
  parser.add_argument('--nx-down', type=int, default=14)
  parser.add_argument('--nx-up', type=int, default=1)
  parser.add_argument('--ny-low', type=int, default=1)
  parser.add_argument('--ny-high', type=int, default=1)
  parser.add_argument('--reynolds', type=float, default=100.0)
  parser.add_argument('--dt', type=float, default=2.5e-4)
  parser.add_argument('--cfl', type=float, default=None,
                      help='set dt from this convective CFL (cfl_dt; the '
                      'large campaign: 0.65) instead of --dt')
  parser.add_argument('--pressure-precond', default='dense',
                      choices=('dense', 'schwarz'),
                      help='the dense Schur inverse (up to 20,000 pressure '
                      'dofs) or the two-level Schwarz preconditioner')
  parser.add_argument('--num-steps', type=int, default=40000)
  parser.add_argument('--steps-per-dispatch', type=int, default=200,
                      help='steps a chunk (host log, trace copy)')
  parser.add_argument('--kick-steps', type=int, default=12000)
  parser.add_argument('--max-seconds', type=float, default=None,
                      help='stop after the chunk that passes this wall time')
  parser.add_argument('--el-ops', action='store_true',
                      help='the E-last element operators (unstructured_el_ops)')
  parser.add_argument('--device', default='cuda')
  parser.add_argument('--dtype', default='float32',
                      choices=('float32', 'float64'))
  parser.add_argument('--checkpoint', default=None)
  parser.add_argument('--log-every', type=int, default=10)
  parser.add_argument('--out', default=None, help='JSON file of the run')
  args = parser.parse_args(argv)
  device = torch.device(args.device)
  card = None
  if device.type == 'cuda':
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)
  t0 = time.perf_counter()
  mesh = dict(ns=args.ns, nr=args.nr, nx_down=args.nx_down, nx_up=args.nx_up,
              ny_low=args.ny_low, ny_high=args.ny_high)
  sem = make_cylinder_sem(args.order, **mesh, device=device,
                          dtype=getattr(torch, args.dtype),
                          unstructured_el_ops=args.el_ops)
  dt = args.dt if args.cfl is None else cfl_dt(sem, args.cfl)
  if args.pressure_precond == 'schwarz':
    precond = schwarz_preconditioner(sem, dt, **mesh)
    pre = {'schwarz_setup_s': precond.setup_seconds,
           'schwarz_coarse': precond.coarse,
           'schwarz_coarse_dofs': precond.coarse_dofs,
           'schwarz_overlap': precond.overlap,
           'schwarz_colors': precond.colors,
           'schwarz_probe_applies': precond.probe_applies,
           'schwarz_block_mb': precond.block_bytes / 2 ** 20}
  else:
    precond = sem.dense_pressure_preconditioner(dt, 2)
    if precond is None:
      parser.error(f'{sem.pressure.pspace.mesh.num_nodes} pressure dofs: '
                   'past the dense inverse, pass --pressure-precond schwarz')
    pre = {'dense_schur_s': precond.assembly_seconds}
  setup = time.perf_counter() - t0
  print(f'setup {setup:.2f} s ({pre}); dt {dt:.4e}; '
        f'{sem.velocity.mesh.num_elements} elements, '
        f'{sem.velocity.mesh.num_nodes} velocity and '
        f'{sem.pressure.pspace.mesh.num_nodes} pressure nodes', flush=True)
  tele = {}
  _, _, trace, forces = run_cylinder_scan(
      sem, reynolds=args.reynolds, dt=dt, num_steps=args.num_steps,
      steps_per_dispatch=args.steps_per_dispatch, kick_steps=args.kick_steps,
      compute_forces=True, pressure_preconditioner=precond,
      use_projection=not args.el_ops, checkpoint_path=args.checkpoint,
      log_every=args.log_every, max_seconds=args.max_seconds,
      telemetry=tele)
  coef = 2.0 * forces / (MEAN_VELOCITY ** 2 * 2 * RADIUS)
  tail = slice(len(trace) // 2, None)
  summary = {
      'card': card, 'order': args.order, 'dt': dt, 'mesh': mesh,
      'dtype': args.dtype, 'el_ops': args.el_ops,
      'elements': sem.velocity.mesh.num_elements,
      'pressure_dofs': sem.pressure.pspace.mesh.num_nodes,
      'pressure_precond': args.pressure_precond, 'setup_s': setup, **pre,
      'steps': len(trace), 't_end': len(trace) * dt,
      'ms_per_step': 1e3 * tele['seconds'] / max(tele['steps'], 1),
      'viscous_iterations_mean': float(np.mean(tele['viscous_iterations'])),
      'pressure_iterations_mean': float(np.mean(
          tele['pressure_iterations'])),
      'pressure_iterations_max': int(np.max(tele['pressure_iterations'])),
      'strouhal': strouhal_number(trace, dt),
      'probe_amplitude_tail': float(np.ptp(trace[tail])),
      'cd_max': float(coef[tail, 0].max()), 'cd_mean': float(
          coef[tail, 0].mean()),
      'cl_max': float(coef[tail, 1].max()), 'cl_min': float(
          coef[tail, 1].min()),
      'finite': bool(np.isfinite(trace).all() and np.isfinite(forces).all()),
  }
  print(json.dumps(summary), flush=True)
  if args.out:
    with open(args.out, 'w', encoding='utf-8') as fh:
      json.dump(summary, fh)
    np.savez(os.path.splitext(args.out)[0] + '_trace.npz', trace=trace,
             forces=forces)
  return summary


if __name__ == '__main__':
  main()

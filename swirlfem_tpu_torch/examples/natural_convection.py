"""Differentially heated square cavity: the de Vahl Davis benchmark.

Counterpart of ``swirlfem_tpu/examples/natural_convection.py``.  Natural
convection of a Boussinesq fluid in the unit square (kappa-based units):

    du/dt + (u . grad) u = -grad p + Pr lap(u) + Ra Pr theta e_y
    dtheta/dt + u . grad theta = lap(theta)

with theta = +1/2 at x=0, theta = -1/2 at x=1, insulated horizontal walls
and no-slip velocity everywhere.  The mean Nusselt number comes out three
ways: the volume identity on the dealiasing rule and the consistent
discrete wall flux on the hot and on the cold wall.

At high Ra the mesh is graded toward the walls by moving the REFINED nodes
(``x -> x - s sin(2 pi x) / (2 pi)`` per axis): its elements are curved, so
the velocity stiffness runs the general 2D kernel (``stiffness2d_general``)
in every viscous CG matvec on a CUDA device; an ungraded cavity runs the
congruent one.  The momentum step is `StokesSEM.stokes_one_step` (BDF2 /
EXT2 advection, no filter), the scalar step `ScalarTransport.one_step`; all
three solves are seeded with their exact FDM inverses.  Run one rung of the
campaign's ladder on a GPU host (float32, tol 3e-6), from the repository
root:

    python -m swirlfem_tpu_torch.examples.natural_convection --ra 1e5 \\
        --out nc_1e5.json [--profile-steps 20]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from swirlfem_tpu_torch.core.bc import BCType
from swirlfem_tpu_torch.core.fespace import grad
from swirlfem_tpu_torch.linalg.cg import vdot
from swirlfem_tpu_torch.nse.scalar import ScalarTransport
from swirlfem_tpu_torch.nse.solver import extk_coeffs
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.utils.box import unit_cube_mesh

# Benchmark mean-Nusselt values (de Vahl Davis 1983, Table I).
BENCHMARK_NU = {1e3: 1.118, 1e4: 2.243, 1e5: 4.519, 1e6: 8.800}

# Modern high-accuracy values (Le Quere 1991 pseudo-spectral for 1e5/1e6;
# grid-converged consensus for 1e3/1e4).
ACCURATE_NU = {1e3: 1.1178, 1e4: 2.2448, 1e5: 4.5216, 1e6: 8.8252}

# The campaign's ladder (experiments/natural_convection_campaign.py): the
# boundary layers thin like Ra^(-1/4), so the mesh grows and grades.
RUNGS = {
    1e3: dict(n_el=6, order=5, grading=0.0),
    1e4: dict(n_el=8, order=6, grading=0.0),
    1e5: dict(n_el=8, order=7, grading=0.3),
    1e6: dict(n_el=12, order=7, grading=0.5),
}


def sine_grading(x: np.ndarray, s: float) -> np.ndarray:
  """The wall-clustering map ``x - s sin(2 pi x) / (2 pi)`` on [0, 1]."""
  return x - s * np.sin(2 * np.pi * x) / (2 * np.pi)


def create_cavity(n_el: int = 8, order: int = 6,
                  dtype: torch.dtype = torch.float64, grading: float = 0.0,
                  *, device: torch.device | str = 'cuda'):
  """Builds the flow solver + scalar transport for the heated cavity.

  Args:
    grading: wall clustering strength in [0, 1), applied to the refined
      nodes of both axes (wall-adjacent elements shrink by ``1 - s``).

  Returns ``(sem, st, theta_lift)`` where `theta_lift` is the conduction
  profile ``1/2 - x`` carrying the hot/cold wall values.
  """
  premesh = unit_cube_mesh(n_el, ndim=2, face_groups=True)
  transform = None
  if grading:
    if not 0.0 <= grading < 1.0:
      raise ValueError(f'grading must be in [0, 1), got {grading}')

    def transform(pm):
      return sine_grading(np.asarray(pm.node_coords), grading)

  sem = StokesSEM.create(
      premesh, boundary_conditions={'boundary': (BCType.DIRICHLET, 0.0)},
      order=order, coord_transform=transform, device=device, dtype=dtype)
  st = ScalarTransport.create(
      sem, {'xlo': (BCType.DIRICHLET, 0.5),
            'xhi': (BCType.DIRICHLET, -0.5)})
  coords = sem.velocity.mesh.node_coords.numpy()
  theta_lift = torch.as_tensor(0.5 - coords[:, 0], dtype=dtype,
                               device=sem.device)
  return sem, st, theta_lift


def nusselt_volume(sem: StokesSEM, u: torch.Tensor,
                   theta: torch.Tensor) -> torch.Tensor:
  """Mean Nusselt via the volume identity ``int (u_x theta - theta_x)`` on
  the dealiasing rule; `theta` is the FULL temperature field."""
  vel = sem.nodal.velocity
  ov = vel.overint_space
  uq = ov.vector_function(vel.gather(u))
  tq = ov.scalar_function(vel.mesh.gather(theta))

  def integrand(x):
    return uq(x)[..., 0] * tq(x) - grad(tq)(x)[..., 0]

  return ov.integrate(integrand)


def nusselt_wall(sem: StokesSEM, st: ScalarTransport, u: torch.Tensor,
                 theta: torch.Tensor, group: str = 'xlo') -> torch.Tensor:
  """Mean Nusselt from the consistent discrete wall flux: the unmasked
  steady residual ``A(theta) + C(theta, u)`` summed over a wall's rows
  (+Nu on the hot wall, -Nu on the cold one)."""
  mesh = st.mesh
  th_local = mesh.gather(theta)
  flux = mesh.scatter(st.A_local(th_local)) + mesh.scatter(
      st.C_local(th_local, sem.nodal.velocity.gather(u)))
  mask = mesh.physical_masks[group].to(theta.dtype)
  return vdot(mask, flux)


def default_dt(sem: StokesSEM, ra: float) -> float:
  """CFL-style step: peak velocity scales like ~0.25 sqrt(Ra) kappa/L."""
  from swirlfem_tpu_torch.niles.datagen import min_node_spacing
  dx = min_node_spacing(sem.velocity.mesh)
  u_est = max(2.0, 0.3 * float(np.sqrt(ra)))
  return float(0.4 * dx / u_est)


def _sync(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def make_step(sem: StokesSEM, st: ScalarTransport, th_b: torch.Tensor, *,
              ra: float, pr: float, dt: float, tol: float, maxiter: int):
  """The coupled step ``(us, ps, thetas, cus) -> (carry, iterations)``.

  `iterations` holds the CG iterations of the viscous, pressure and scalar
  solves (host ints).  Momentum advection enters the linear Stokes update
  through the EXT2-extrapolated convection history; ``alpha = 0``: the
  modal filter would bias Nu on this steady laminar benchmark.
  """
  vprecond = sem.fdm_viscous_preconditioner(pr, dt, 2)
  pprecond = sem.fdm_pressure_preconditioner(dt, 2)
  sprecond = st.fdm_preconditioner(sem, 1.0, dt, 2)
  ey = torch.tensor([0.0, 1.0], dtype=sem.dtype, device=sem.device)
  ext = [float(c) for c in extk_coeffs(k=1)]

  def step(us, ps, thetas, cus):
    cu = sum(e * c for e, c in zip(ext[::-1], cus[::-1]))
    f = sem.B((ra * pr) * thetas[-1][:, None] * ey) - cu
    u, p, aux = sem.stokes_one_step(
        list(us), list(ps), f, mu=pr, dt=dt, time_order=2, alpha=0.0,
        tol=tol, atol=tol, maxiter=maxiter, viscous_preconditioner=vprecond,
        pressure_preconditioner=pprecond)
    th, info = st.one_step(list(thetas), [us[-1], u], kappa=1.0, dt=dt,
                           time_order=2, theta_boundary=th_b, tol=tol,
                           maxiter=maxiter, preconditioner=sprecond)
    iters = (aux['u_star_info']['num_iterations'],
             aux['dp_info']['num_iterations'], info['num_iterations'])
    return ((us[-1], u), (ps[-1], p), (thetas[-1], th),
            (cus[-1], sem.C(u))), iters

  return step


def initial_state(sem: StokesSEM, th_b: torch.Tensor):
  """Rest, conduction profile: ``(us, ps, thetas, cus)``, two deep."""
  u0 = torch.zeros((sem.velocity.mesh.num_nodes, 2), dtype=sem.dtype,
                   device=sem.device)
  p0 = torch.zeros(sem.pressure.pspace.mesh.num_nodes, dtype=sem.dtype,
                   device=sem.device)
  c0 = sem.C(u0)
  return (u0, u0), (p0, p0), (th_b, th_b), (c0, c0)


def run_cavity(ra: float, pr: float = 0.71, n_el: int = 8, order: int = 6,
               *, dt: float | None = None, max_steps: int = 200_000,
               steps_per_dispatch: int = 200, steady_tol: float = 1e-6,
               tol: float = 1e-9, dtype: torch.dtype = torch.float64,
               grading: float = 0.0, verbose: bool = False,
               device: torch.device | str = 'cuda',
               maxiter: int = 200) -> dict:
  """Marches the heated cavity to steady state; returns fields + Nusselt.

  A Python loop over chunks of `steps_per_dispatch` eager steps (the JAX
  package's ``jit`` + ``scan``); the steady-rate test reads the device once
  per chunk.  Steadiness: the max temperature change per unit time below
  ``steady_tol * Ra^(1/2)``.  `maxiter` caps every CG solve (the exact FDM
  seeds certify in 0-2 iterations; a cap keeps a stalled solve from
  stalling the run).

  Returns a dict with ``u``, ``theta`` (full field), ``p``, ``nu_volume``,
  ``nu_hot``, ``nu_cold``, ``u_max``, ``steps``, the per-chunk walls and
  the largest CG iteration count of each solve (``cg_max_iters``).
  """
  device = torch.device(device)
  sem, st, th_b = create_cavity(n_el, order, dtype, grading=grading,
                                device=device)
  if dt is None:
    dt = default_dt(sem, ra)
  step = make_step(sem, st, th_b, ra=ra, pr=pr, dt=dt, tol=tol,
                   maxiter=maxiter)
  us, ps, thetas, cus = initial_state(sem, th_b)
  steps = 0
  rate = float('inf')
  rate_tol = steady_tol * max(1.0, float(np.sqrt(ra)))
  chunk_walls = []  # the first includes the first launches' one-time costs
  max_iters = [0, 0, 0]
  while steps < max_steps:
    th_prev = thetas[-1]
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps_per_dispatch):
      (us, ps, thetas, cus), iters = step(us, ps, thetas, cus)
      max_iters = [max(a, int(b)) for a, b in zip(max_iters, iters)]
    rate = float((thetas[-1] - th_prev).abs().max()) / (
        steps_per_dispatch * dt)  # reads the device: the wall covers it
    chunk_walls.append(time.perf_counter() - t0)
    steps += steps_per_dispatch
    if verbose:
      print(f'step {steps}: d(theta)/dt {rate:.3e} (target {rate_tol:.1e}), '
            f'{chunk_walls[-1] / steps_per_dispatch * 1e3:.3f} ms/step, '
            f'cg iters {max_iters}', flush=True)
    if rate < rate_tol:
      break
  walls = chunk_walls[1:] or chunk_walls
  ms_per_step_steady = 1e3 * sum(walls) / (steps_per_dispatch * len(walls))

  u, theta = us[-1], thetas[-1]
  return {
      'u': u, 'theta': theta, 'p': ps[-1], 'dt': dt, 'steps': steps,
      'steady_rate': rate, 'ms_per_step_steady': ms_per_step_steady,
      'chunk_walls_s': chunk_walls,
      'nu_volume': float(nusselt_volume(sem, u, theta)),
      'nu_hot': float(nusselt_wall(sem, st, u, theta, 'xlo')),
      'nu_cold': float(-nusselt_wall(sem, st, u, theta, 'xhi')),
      'u_max': float(u.abs().max()),
      'cg_max_iters': dict(zip(('viscous', 'pressure', 'scalar'), max_iters)),
      'sem': sem, 'st': st, 'theta_lift': th_b,
      'state': (us, ps, thetas, cus),
  }


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--ra', type=float, default=1e5, choices=sorted(RUNGS))
  parser.add_argument('--pr', type=float, default=0.71)
  parser.add_argument('--max-steps', type=int, default=400_000)
  parser.add_argument('--steps-per-dispatch', type=int, default=200)
  parser.add_argument('--tol', type=float, default=3e-6)
  parser.add_argument('--out', default=None, help='JSON file of the run')
  parser.add_argument('--profile-steps', type=int, default=0,
                      help='then profile this many steps (torch.profiler)')
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit('natural_convection: no CUDA device')
  device = torch.device('cuda', 0)
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
  print(f'card: {card}', flush=True)
  rung = RUNGS[args.ra]
  t0 = time.perf_counter()
  r = run_cavity(args.ra, args.pr, dtype=torch.float32, tol=args.tol,
                 max_steps=args.max_steps,
                 steps_per_dispatch=args.steps_per_dispatch, device=device,
                 verbose=True, **rung)
  wall = time.perf_counter() - t0
  nu_acc = ACCURATE_NU[args.ra]
  case = {
      'card': card, 'ra': args.ra, 'pr': args.pr, **rung,
      'dtype': 'float32', 'tol': args.tol, 'steps': r['steps'],
      'dt': r['dt'], 'wall_s': wall, 'ms_per_step': 1e3 * wall / r['steps'],
      'ms_per_step_steady': r['ms_per_step_steady'],
      'nu_volume': r['nu_volume'], 'nu_hot': r['nu_hot'],
      'nu_cold': r['nu_cold'], 'u_max': r['u_max'],
      'steady_rate': r['steady_rate'],
      'nu_benchmark': BENCHMARK_NU[args.ra], 'nu_accurate': nu_acc,
      'nu_rel_err': abs(r['nu_volume'] - nu_acc) / nu_acc,
      'cg_max_iters': r['cg_max_iters'],
  }
  print(json.dumps(case), flush=True)
  if args.profile_steps:
    from swirlfem_tpu_torch.niles.profile_datagen import profile_steps
    step = make_step(r['sem'], r['st'], r['theta_lift'], ra=args.ra,
                     pr=args.pr, dt=r['dt'], tol=args.tol, maxiter=200)

    def run():
      state = r['state']
      for _ in range(args.profile_steps):
        state, _ = step(*state)

    case['profile'] = profile_steps(run, args.profile_steps, device)
  if args.out:
    with open(args.out, 'w', encoding='utf-8') as f:
      json.dump(case, f)


if __name__ == '__main__':
  main()

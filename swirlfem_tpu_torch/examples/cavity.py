"""Lid-driven cavity: the non-homogeneous Dirichlet NSE example.

Counterpart of ``swirlfem_tpu/examples/cavity.py``: unit square, no-slip
walls, a lid moving along the top wall.  Demonstrates the boundary-lift
path of `StokesSEM.stokes_one_step` (``u_boundary``): the solve runs on the
homogeneous interior with the lifted boundary field folded into the
right-hand side.

On the uniform box the velocity stiffness runs the congruent 2D kernel;
with its premesh VERTICES moved by the heated cavity's sine grading
(``grading``) every element stays a parallelogram but no two columns share
a metric, so it runs the affine kernel (``stiffness2d_affine``) on a CUDA
device.  Run 500 steps at Re 100 on a GPU host, from the repository root:

    python -m swirlfem_tpu_torch.examples.cavity --grading 0.5 \\
        [--profile-steps 20]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from swirlfem_tpu_torch.core.bc import BCType
from swirlfem_tpu_torch.examples.natural_convection import sine_grading
from swirlfem_tpu_torch.nse.solver import extk_coeffs
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.ops import cuda_build
from swirlfem_tpu_torch.utils.box import unit_cube_mesh


def make_cavity(num_elements: int = 8, order: int = 5, *,
                grading: float = 0.0, device: torch.device | str = 'cuda',
                dtype: torch.dtype = torch.float64) -> StokesSEM:
  """The cavity solver; `grading` moves the premesh vertices by
  `sine_grading` on both axes (affine, non-congruent elements)."""
  premesh = unit_cube_mesh(num_elements, ndim=2)
  if grading:
    premesh = premesh.replace(node_coords=sine_grading(
        np.asarray(premesh.node_coords, dtype=np.float64), grading))
  return StokesSEM.create(
      premesh, boundary_conditions={'boundary': (BCType.DIRICHLET, 0.0)},
      order=order, device=device, dtype=dtype)


def lid_boundary_field(sem: StokesSEM, lid_speed: float = 1.0):
  """Velocity field equal to (lid_speed, 0) on the lid, zero elsewhere.

  The lid is the y = 1 wall; the regularized profile 16 x^2 (1 - x)^2
  tapers to zero at the corners.  Returned ``(N, 2)`` on the solver's
  device.
  """
  coords = sem.velocity.mesh.node_coords.numpy()
  on_lid = np.abs(coords[:, 1] - 1.0) < 1e-12
  x = coords[:, 0]
  profile = 16.0 * (x * (1.0 - x)) ** 2  # peaks at 1 in the middle
  ub = np.zeros_like(coords)
  ub[:, 0] = np.where(on_lid, lid_speed * profile, 0.0)
  return torch.as_tensor(ub, dtype=sem.dtype, device=sem.device)


def make_step(sem: StokesSEM, *, reynolds: float, dt: float,
              time_order: int = 2, maxiter: int = 200,
              fdm_viscous: bool = True):
  """The step ``(us, ps, cus) -> ((us, ps, cus), aux)`` with the lift
  `u_boundary` and the exact FDM seed of the pressure solve and, with
  `fdm_viscous`, of the viscous one (else Jacobi-preconditioned CG, where
  the stiffness apply sets the answer)."""
  u_boundary = lid_boundary_field(sem)
  ext = [float(c) for c in extk_coeffs(k=time_order - 1)]
  # Exact FDM inverse of the Schur operator: the pressure correction
  # converges in 1 iteration instead of O(order * num_elements).
  precond = sem.best_pressure_preconditioner(dt, time_order)
  vprecond = (sem.fdm_viscous_preconditioner(1.0 / reynolds, dt, time_order)
              if fdm_viscous else None)

  def step(us, ps, cus):
    cu = sum(ext[-i] * cus[-i] for i in range(1, len(ext) + 1))
    u, p, aux = sem.stokes_one_step(
        list(us), list(ps), -cu, mu=1.0 / reynolds, dt=dt,
        time_order=time_order, u_boundary=u_boundary, tol=1e-8, atol=1e-10,
        maxiter=maxiter, pressure_preconditioner=precond,
        viscous_preconditioner=vprecond)
    # The interior solve returns u including the lift; advect the full
    # field, keep the homogeneous part in the history.
    return (us[1:] + (u - u_boundary,), ps[1:] + (p,),
            cus[1:] + (sem.C(u),)), aux

  step.u_boundary = u_boundary
  return step


def initial_state(sem: StokesSEM, u_boundary, time_order: int = 2):
  """Rest: ``(us, ps, cus)``, `time_order` deep."""
  u0 = torch.zeros((sem.velocity.mesh.num_nodes, 2), dtype=sem.dtype,
                   device=sem.device)
  p0 = torch.zeros(sem.pressure.pspace.mesh.num_nodes, dtype=sem.dtype,
                   device=sem.device)
  c0 = sem.C(u0 + u_boundary)
  return (u0,) * time_order, (p0,) * time_order, (c0,) * time_order


def run_cavity(sem: StokesSEM, reynolds: float = 100.0, dt: float = 2e-3,
               num_steps: int = 50, time_order: int = 2):
  """Time-steps the cavity from rest; returns ``(u, p, aux)`` of the last
  step (u including the lid)."""
  step = make_step(sem, reynolds=reynolds, dt=dt, time_order=time_order)
  state = initial_state(sem, step.u_boundary, time_order)
  aux = None
  for _ in range(num_steps):
    state, aux = step(*state)
  us, ps, _ = state
  return us[-1] + step.u_boundary, ps[-1], aux


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--n-el', type=int, default=16)
  parser.add_argument('--order', type=int, default=7)
  parser.add_argument('--re', type=float, default=100.0)
  parser.add_argument('--dt', type=float, default=1e-3)
  parser.add_argument('--steps', type=int, default=500)
  parser.add_argument('--grading', type=float, default=0.5)
  parser.add_argument('--out', default=None, help='JSON file of the run')
  parser.add_argument('--profile-steps', type=int, default=0,
                      help='then profile this many steps (torch.profiler)')
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit('cavity: no CUDA device')
  device = torch.device('cuda', 0)
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
  print(f'card: {card}', flush=True)
  sem = make_cavity(args.n_el, args.order, grading=args.grading,
                    device=device, dtype=torch.float32)
  step = make_step(sem, reynolds=args.re, dt=args.dt)
  state = initial_state(sem, step.u_boundary)
  cuda_build.library()  # build (or load) the kernels outside the timed loop
  torch.cuda.synchronize(device)
  t0 = time.perf_counter()
  for _ in range(args.steps):
    state, aux = step(*state)
  torch.cuda.synchronize(device)
  wall = time.perf_counter() - t0
  u = state[0][-1] + step.u_boundary
  summary = {
      'card': card, 're': args.re, 'n_el': args.n_el, 'order': args.order,
      'grading': args.grading, 'stiffness_key': sem.fast_ops.stiffness_key,
      'dtype': 'float32', 'dt': args.dt, 'steps': args.steps,
      'wall_s': wall, 'ms_per_step': 1e3 * wall / args.steps,
      'u_max': float(u.abs().max()),
      'last_iters': [aux['u_star_info']['num_iterations'],
                     aux['dp_info']['num_iterations']],
  }
  print(json.dumps(summary), flush=True)
  if args.profile_steps:
    from swirlfem_tpu_torch.niles.profile_datagen import profile_steps

    def run():
      s = state
      for _ in range(args.profile_steps):
        s, _ = step(*s)

    summary['profile'] = profile_steps(run, args.profile_steps, device)
  if args.out:
    with open(args.out, 'w', encoding='utf-8') as f:
      json.dump(summary, f)


if __name__ == '__main__':
  main()

#!/usr/bin/env python3
"""Viscous CG iterations of the vertex-graded lid-driven cavity: the JAX
package against the port, in one arithmetic class, float32, on the CPU.

Both run the lid-driven steps of their `examples/cavity.py` (Re 100,
dt 1e-3, BDF2, FDM-seeded viscous and pressure solves, tol 1e-8) on the
box whose premesh vertices are sine-graded (affine elements).  The JAX
solver applies its stiffness through `stiffness_el_pallas_affine` in
interpret mode (which runs 'bf16x3' as three bf16 passes, but
Precision.DEFAULT at full precision: only 'highest' and 'bf16x3' are
comparable); the port through its plain emulation of the same class.
Prints each step's (viscous, pressure) iterations of both and the final
velocities' relative difference as one JSON line.  Not a test: a check
run by hand, a minute or two at the path's size.

Both sides get the port's set-up (`jax_solver`): the operators built in
float64 and cast once to float32, the FDM seeds' per-axis Jacobians taken
from the float64 node coordinates.  With ``--jax-seed-coords float32`` the
JAX seeds read the node coordinates rounded to float32, as a float32 run of
the JAX package holds them: the viscous seed then leaves a residual ~4x the
port's against the same float32 operator, and the JAX viscous solves take
one to four more iterations (`tests/test_torch_lid_iterations.py`).

    python tests/torch_port_lid_iterations.py [--n-el 16] [--order 7]
        [--steps 30] [--precision bf16x3] [--jax-seed-coords float64]
"""

import argparse
import dataclasses
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from swirlfem_tpu.core.bc import BCType as JBCType
from swirlfem_tpu.examples import cavity as jcavity
from swirlfem_tpu.nse.solver import extk_coeffs
from swirlfem_tpu.nse.solver import StokesSEM as JStokesSEM
from swirlfem_tpu.ops import pallas_stiffness
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch.examples import cavity
from swirlfem_tpu_torch.examples.natural_convection import sine_grading

RE, DT, GRADING = 100.0, 1e-3, 0.5


def interpreted_affine_kernel():
  """`stiffness_el_pallas_affine` in interpret mode (the CPU has no Pallas
  backend); the JAX solver looks it up at each call."""
  return functools.partial(pallas_stiffness.stiffness_el_pallas_affine,
                           interpret=True)


def jax_solver(n_el, order, precision, seed_coords='float64'):
  """The JAX solver of the graded cavity in float32 and its FDM seeds.

  Returns ``(sem, vprecond, precond)``.  The solver is built in float64
  and its arrays cast to float32 (the port's set-up; needs
  ``jax_enable_x64``).  The seeds' transforms are float32; their per-axis
  Jacobians come from the node coordinates in `seed_coords`: 'float64' as
  the port's, or 'float32' as a float32 run of the JAX package holds them.
  On the CPU, `interpreted_affine_kernel` must stand in for the kernel.
  """
  pm = junit_cube_mesh(n_el, ndim=2)
  pm = pm.replace(node_coords=sine_grading(
      np.asarray(pm.node_coords, dtype=np.float64), GRADING))
  sem = JStokesSEM.create(pm, {'boundary': (JBCType.DIRICHLET, 0.0)},
                          order=order, use_pallas_kernels=True,
                          kernel_precision=precision)
  to32 = lambda a: (a.astype(jnp.float32) if getattr(a, 'dtype', None)
                    in (jnp.float64, np.float64) else a)
  sem32 = jax.tree_util.tree_map(to32, sem)
  # The seeds take their transforms' dtype from the mass diagonal and
  # their geometry from the node coordinates.
  seed_sem = (sem.replace(velocity_mass_diag=sem32.velocity_mass_diag)
              if seed_coords == 'float64' else sem32)
  return (sem32, seed_sem.fdm_viscous_preconditioner(1.0 / RE, DT, 2),
          seed_sem.best_pressure_preconditioner(DT, 2))


def jax_iterations(n_el, order, steps, precision, seed_coords='float64'):
  sem, vprecond, precond = jax_solver(n_el, order, precision, seed_coords)
  dtype = jnp.float32
  ub = jcavity.lid_boundary_field(sem).astype(dtype)
  ext = [float(c) for c in extk_coeffs(k=1)]

  @jax.jit
  def step(us, ps, cus):
    cu = sum(ext[-i] * cus[-i] for i in range(1, len(ext) + 1))
    u, p, aux = sem.stokes_one_step(
        list(us), list(ps), -cu, mu=1.0 / RE, dt=DT, time_order=2,
        u_boundary=ub, tol=1e-8, atol=1e-10, maxiter=200,
        pressure_preconditioner=precond, viscous_preconditioner=vprecond)
    iters = tuple(aux[k]['num_iterations'] for k in ('u_star_info',
                                                    'dp_info'))
    return (us[1:] + (u - ub,), ps[1:] + (p,), cus[1:] + (sem.C(u),)), iters

  u0 = jnp.zeros((sem.velocity.mesh.num_nodes, 2), dtype)
  p0 = jnp.zeros(sem.pressure.pspace.mesh.num_nodes, dtype)
  state = ((u0, u0), (p0, p0), (sem.C(u0 + ub),) * 2)
  counts = []
  for _ in range(steps):
    state, iters = step(*state)
    counts.append([int(np.asarray(i).max()) for i in iters])
  return counts, np.asarray(state[0][-1] + ub)


def port_iterations(n_el, order, steps, precision):
  sem = cavity.make_cavity(n_el, order, grading=GRADING, device='cpu',
                           dtype=torch.float32)
  sem = dataclasses.replace(sem, fast_ops=dataclasses.replace(
      sem.fast_ops, kernel_precision=precision))
  step = cavity.make_step(sem, reynolds=RE, dt=DT)
  state = cavity.initial_state(sem, step.u_boundary)
  counts = []
  for _ in range(steps):
    state, aux = step(*state)
    counts.append([int(aux[k]['num_iterations'])
                   for k in ('u_star_info', 'dp_info')])
  return counts, (state[0][-1] + step.u_boundary).numpy()


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--n-el', type=int, default=16)
  parser.add_argument('--order', type=int, default=7)
  parser.add_argument('--steps', type=int, default=30)
  parser.add_argument('--precision', default='bf16x3',
                      choices=('highest', 'bf16x3'))
  parser.add_argument('--jax-seed-coords', default='float64',
                      choices=('float64', 'float32'))
  args = parser.parse_args(argv)
  jax.config.update('jax_platforms', 'cpu')
  jax.config.update('jax_enable_x64', True)
  pallas_stiffness.stiffness_el_pallas_affine = interpreted_affine_kernel()
  jax_counts, ju = jax_iterations(args.n_el, args.order, args.steps,
                                  args.precision, args.jax_seed_coords)
  port_counts, pu = port_iterations(args.n_el, args.order, args.steps,
                                    args.precision)
  print(json.dumps({
      'n_el': args.n_el, 'order': args.order, 'steps': args.steps,
      'precision': args.precision, 'jax_seed_coords': args.jax_seed_coords,
      'jax_iterations': jax_counts,
      'port_iterations': port_counts,
      'u_rel': float(np.abs(pu - ju).max() / np.abs(ju).max())}))


if __name__ == '__main__':
  main()

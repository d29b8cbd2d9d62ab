"""Viscous CG iterations of the vertex-graded lid-driven cavity, float32:
the port against the JAX package, and what sets them.

The FDM viscous seed is exact for the separable operator built from the
per-axis Jacobians of the node coordinates.  The port builds it from its
float64 host coordinates; a float32 run of the JAX package holds its node
coordinates in float32, and the seed inherits their rounding: against the
same float32 operator it leaves a residual ~4x the port's, and the seeded
CG takes one to four more iterations a solve (16², order 7, 30 steps:
`tests/torch_port_lid_iterations.py`).  Given the same coordinates, the
two packages take the same iterations step by step.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_port_lid_iterations as lid  # noqa: E402
from swirlfem_tpu_torch.examples import cavity  # noqa: E402

N_EL, ORDER, STEPS = 6, 5, 3


def _round_coords(sem):
  """`sem` with its velocity node coordinates rounded to float32, as a
  float32 run of the JAX package holds them; the operators stay the ones
  built from the float64 coordinates."""
  vspace = sem.velocity.vspace
  mesh = dataclasses.replace(
      vspace.mesh,
      node_coords=vspace.mesh.node_coords.to(torch.float32).double())
  velocity = dataclasses.replace(
      sem.velocity, vspace=dataclasses.replace(vspace, mesh=mesh))
  return dataclasses.replace(sem, velocity=velocity)


def _port_sem():
  sem = cavity.make_cavity(N_EL, ORDER, grading=lid.GRADING, device='cpu',
                           dtype=torch.float32)
  return dataclasses.replace(sem, fast_ops=dataclasses.replace(
      sem.fast_ops, kernel_precision='highest'))


def _port_counts(sem):
  step = cavity.make_step(sem, reynolds=lid.RE, dt=lid.DT)
  state = cavity.initial_state(sem, step.u_boundary)
  counts = []
  for _ in range(STEPS):
    state, aux = step(*state)
    counts.append([int(aux[k]['num_iterations'])
                   for k in ('u_star_info', 'dp_info')])
  return counts


def _seed_residual(sem, seed_sem):
  """``|H x0 - r| / |r|`` of the viscous seed of `seed_sem` on a masked
  random residual, H the float32 viscous operator of `sem`."""
  mask = sem.nodal.mask
  md = sem.nodal.mass_diag[:, 0]
  mu = 1.0 / lid.RE
  rng = np.random.default_rng(0)
  r = mask * torch.as_tensor(rng.standard_normal(mask.numel()),
                             dtype=torch.float32)
  x0 = seed_sem.fdm_viscous_preconditioner(mu, lid.DT, 2)(r)
  hx = mask * (1.5 / lid.DT * md * x0 + mu * sem._fast_stiffness((x0,))[0])
  return float(torch.linalg.norm(hx - r) / torch.linalg.norm(r))


def test_seed_residual_from_float32_coordinates():
  sem = _port_sem()
  own = _seed_residual(sem, sem)
  rounded = _seed_residual(sem, _round_coords(sem))
  assert own < 4e-7, own
  assert rounded > 2.5 * own, (own, rounded)


@pytest.mark.parametrize('seed_coords', ['float64', 'float32'])
def test_viscous_iterations_match_jax(seed_coords, monkeypatch):
  """Given the same seed coordinates, the port's viscous and pressure
  iterations are the JAX package's at every step; rounded ones cost the
  viscous solves an iteration at this size."""
  monkeypatch.setattr(lid.pallas_stiffness, 'stiffness_el_pallas_affine',
                      lid.interpreted_affine_kernel())
  sem = _port_sem()
  if seed_coords == 'float32':
    sem = _round_coords(sem)
  port = _port_counts(sem)
  ref, _ = lid.jax_iterations(N_EL, ORDER, STEPS, 'highest', seed_coords)
  assert port == ref, (port, ref)
  assert [c[0] for c in port] == ([1] * STEPS if seed_coords == 'float64'
                                  else [2] * STEPS), port

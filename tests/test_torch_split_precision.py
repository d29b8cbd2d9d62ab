"""The split-bf16 stiffness classes ('bf16x3', 'default') against the JAX
package.

The host split of each static operator (the 2D congruent operator at orders
3 and 8, the affine stack, the 3D dense operator at k = 4) equals, bitwise,
the hi / lo operands that the JAX Pallas functions hand their kernels; the
plain version of the tensor-core kernels matches those functions in
interpret mode at 'bf16x3'; 'default' sits at its bf16 accuracy against the
float64 operator; and the walled `stokes_one_step` and the certified
datagen step run the split class.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.core.bc import BCType as JBCType
from swirlfem_tpu.nse.solver import StokesSEM as JStokesSEM
from swirlfem_tpu.ops import pallas_stiffness as jps
from swirlfem_tpu.ops import pallas_stiffness3d as jp3
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch import interop
from swirlfem_tpu_torch.core.bc import BCType
from swirlfem_tpu_torch.core.quadrature import differentiation_matrix_1d
from swirlfem_tpu_torch.core.quadrature import NodeType
from swirlfem_tpu_torch.core.quadrature import Quadrature1D
from swirlfem_tpu_torch.examples.natural_convection import sine_grading
from swirlfem_tpu_torch.niles import datagen
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.ops import cuda_split
from swirlfem_tpu_torch.ops import cuda_stiffness
from swirlfem_tpu_torch.ops import cuda_stiffness3d
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
# The JAX certified datagen step and its numpy-seeded state.
from test_torch_datagen import _assert_state_close
from test_torch_datagen import _jax_advance
from test_torch_datagen import _jax_state
from test_torch_datagen import _jcfg
from test_torch_datagen import CFG
from test_torch_datagen import sems  # pylint: disable=unused-import
from test_torch_datagen import state  # pylint: disable=unused-import
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

# Split plain version vs the interpret-mode JAX kernel: both sum exact bf16
# products, in another order (relative to the output's largest entry).
TOL = {torch.float64: 1e-12, torch.float32: 1e-6}
# The classes against the float64 operator (kernel_checks has the same).
BF16X3_BAND, DEFAULT_BAND = (1e-7, 1e-4), (1e-5, 1e-2)
# The walled box of tests/test_torch_walls.py: 3x3, order 4, the premesh
# vertices sine-graded (affine elements, not congruent).
N_EL, ORDER, GRADING = 3, 4, 0.5
MU, DT = 0.05, 5e-3


def _rel(got, want):
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  return float(np.abs(got - want).max() / np.abs(want).max())


def _gll(order):
  """(w, D): GLL weights and differentiation matrix, float64."""
  quad = Quadrature1D.create(order + 1, NodeType.GAUSS_LOBATTO_LEGENDRE)
  return quad.weights, differentiation_matrix_1d(quad.nodes)


@functools.lru_cache(maxsize=None)
def _walled(kernel_precision='highest'):
  """(JAX solver with the Pallas kernels, port solver) of the walled box."""
  out = []
  for ucm, create, bct, kw in (
      (junit_cube_mesh, JStokesSEM.create, JBCType,
       dict(use_pallas_kernels=True)),
      (unit_cube_mesh, StokesSEM.create, BCType,
       dict(device='cpu', dtype=torch.float64))):
    pm = ucm(N_EL, ndim=2, face_groups=True)
    pm = pm.replace(node_coords=sine_grading(
        np.asarray(pm.node_coords, dtype=np.float64), GRADING))
    out.append(create(pm, {'boundary': (bct.DIRICHLET, 0.0)}, order=ORDER,
                      kernel_precision=kernel_precision, **kw))
  return tuple(out)


@contextlib.contextmanager
def _operands_of_pallas_call(captured):
  """Appends the operands of every `pl.pallas_call` made inside."""
  real = jps.pl.pallas_call

  def spy(kernel, **kwargs):
    call = real(kernel, **kwargs)

    def run(*operands):
      captured.append(operands)
      return call(*operands)
    return run

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jps.pl, 'pallas_call', spy)
    yield


def _case(name):
  """(operator float64, number of blocks, field shape, JAX function and its
  static arguments, port plain version) of one split-class case."""
  rng = np.random.default_rng(5)
  if name.startswith('uniform'):
    order = int(name.split('-')[1])
    w, d = _gll(order)
    wq = np.outer(w, w)
    c_uniform = (1.3, 0.2, 0.8)
    m64 = cuda_stiffness.uniform_amat_np(c_uniform, wq, d)
    jax_fn = functools.partial(jps.stiffness_el_pallas_uniform,
                               c_uniform=c_uniform, wq_nd=wq, dmat=d)
    return m64, 1, (order + 1, order + 1, 16), jax_fn, (
        lambda us, hi, lo: cuda_split.stiffness_uniform_split_plain(
            us, hi, lo, 3))
  if name == 'affine':
    _, sem = _walled()
    ops = sem.fast_ops
    m64 = cuda_stiffness.affine_mstack_np(ops.wq2d, ops.dmat)
    c_aff = ops.g_affine.numpy()
    jax_fn = lambda us: jps.stiffness_el_pallas_affine(
        us, jnp.asarray(c_aff, us[0].dtype), ops.wq2d, ops.dmat,
        precision='bf16x3', interpret=True)
    return m64, 3, (ORDER + 1, ORDER + 1, N_EL ** 2), jax_fn, (
        lambda us, hi, lo: cuda_split.stiffness2d_affine_split_plain(
            us, torch.as_tensor(c_aff, dtype=us[0].dtype), hi, lo, 3))
  assert name == 'dense3d'
  w, d = _gll(3)
  c_uniform = tuple(rng.uniform(0.5, 1.5, 3))
  m64 = cuda_stiffness3d.uniform_amat3d_np(c_uniform, w, d)
  jax_fn = functools.partial(jp3.stiffness3d_el_pallas_dense,
                             c_uniform=c_uniform, w1=w, dmat=d)
  return m64, 1, (4, 4, 4, 2 ** 3), jax_fn, (
      lambda us, hi, lo: cuda_split.stiffness_uniform_split_plain(
          us, hi, lo, 3))


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['f64', 'f32'])
@pytest.mark.parametrize('name', ['uniform-3', 'uniform-8', 'affine',
                                  'dense3d'])
def test_split_matches_jax_kernel(name, dtype):
  """hi / lo bitwise equal to the JAX kernel's operands; the plain version
  equal to the interpret-mode kernel at 'bf16x3'."""
  m64, blocks, shape, jax_fn, plain = _case(name)
  rng = np.random.default_rng(3)
  us = tuple(rng.standard_normal(shape) for _ in range(2))
  jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
  captured = []
  with _operands_of_pallas_call(captured):
    if name == 'affine':
      want = jax_fn(tuple(jnp.asarray(u, jdtype) for u in us))
    else:
      want = jax_fn(tuple(jnp.asarray(u, jdtype) for u in us),
                    precision='bf16x3', interpret=True)
  jhi, jlo = (np.asarray(x.astype(jnp.float32)) for x in captured[0][:2])
  assert captured[0][0].dtype == jnp.bfloat16

  split = cuda_split.split_operator_np(m64, num_blocks=blocks)
  rows, depth = m64.shape[0] // blocks, m64.shape[1]
  assert split.shape[1] % (16 * blocks) == 0 and split.shape[2] % 16 == 0
  blocked = split.reshape(2, blocks, -1, split.shape[2])
  for part, jpart in zip(blocked, (jhi, jlo)):
    np.testing.assert_array_equal(
        part[:, :rows, :depth].reshape(blocks * rows, depth), jpart)
    assert not part[:, rows:].any() and not part[:, :, depth:].any()

  split_t = torch.as_tensor(split).to(torch.bfloat16)
  got = plain(tuple(torch.as_tensor(u, dtype=dtype) for u in us),
              split_t[0], split_t[1])
  err = max(_rel(g.double().numpy(), w) for g, w in zip(got, want))
  assert err <= TOL[dtype], err


def _ops_at(geometry, kernel_precision):
  if geometry == 'vertex':
    ops = _walled()[1].fast_ops
  else:
    ops = _uniform_ops()
  return dataclasses.replace(ops, kernel_precision=kernel_precision)


@functools.lru_cache(maxsize=None)
def _uniform_ops():
  sem = StokesSEM.create(unit_cube_mesh(3, ndim=2, periodic_dims=(0, 1)), {},
                         order=8, device='cpu', dtype=torch.float64)
  return sem.fast_ops


@pytest.mark.parametrize('geometry', ['uniform', 'vertex'])
def test_split_classes_against_the_float64_operator(geometry):
  """JAX in interpret mode on the CPU runs Precision.DEFAULT at full
  precision, so it is no oracle of the 'default' class: the float64
  operator is, with the class's accuracy band (one bf16 pass, ~1e-3)."""
  highest = _ops_at(geometry, 'highest')
  assert highest.stiffness_key[0] == ('congruent' if geometry == 'uniform'
                                      else 'affine')
  k = highest.vinfo.order + 1
  num_e = highest.vinfo.num_elements_per_dim ** 2
  rng = np.random.default_rng(11)
  us = tuple(torch.as_tensor(rng.standard_normal((k, k, num_e)))
             for _ in range(2))
  want = highest.stiffness_el_multi(us)
  launches = (cuda_split.stiffness_uniform_split.launches,
              cuda_split.stiffness2d_affine_split.launches)
  for precision, (low, high) in (('bf16x3', BF16X3_BAND),
                                 ('default', DEFAULT_BAND)):
    got = _ops_at(geometry, precision).stiffness_el_multi(us)
    err = max(_rel(g.numpy(), w.numpy()) for g, w in zip(got, want))
    assert low < err <= high, (precision, err)
  # CPU tensors run the plain versions: no kernel launch is counted.
  assert launches == (cuda_split.stiffness_uniform_split.launches,
                      cuda_split.stiffness2d_affine_split.launches)


def _walled_steps(sem_step, state, f, steps):
  us, ps = state
  for _ in range(steps):
    u, p = sem_step(us, ps, f)[:2]
    us, ps = (us[-1], u), (ps[-1], p)
  return us[-1], ps[-1]


def test_walled_step_at_bf16x3_matches_jax(monkeypatch):
  """3 steps of `stokes_one_step` with the Jacobi-preconditioned viscous CG
  (the stiffness sets the answer) at 'bf16x3', float64: the JAX step runs
  its affine Pallas kernel in interpret mode."""
  monkeypatch.setattr(jps, 'stiffness_el_pallas_affine', functools.partial(
      jps.stiffness_el_pallas_affine, interpret=True))
  jsem, sem = _walled('bf16x3')
  assert sem.fast_ops.stiffness_key == ('affine', 'bf16x3')
  steps = 3
  nv = sem.velocity.mesh.num_nodes
  npn = sem.pressure.pspace.mesh.num_nodes
  rng = np.random.default_rng(9)
  mask = np.asarray(jsem.velocity.interior_mask)
  u0 = mask * rng.standard_normal((nv, 2))
  f = mask * rng.standard_normal((nv, 2))
  p0 = np.zeros(npn)
  kw = dict(mu=MU, dt=DT, time_order=2, alpha=0.05, tol=1e-12, atol=0.0)

  jstep = jax.jit(lambda us, ps: jsem.stokes_one_step(
      list(us), list(ps), jnp.asarray(f), **kw)[:2])
  ju, jp = _walled_steps(lambda us, ps, _: jstep(us, ps),
                         ((jnp.asarray(u0),) * 2, (jnp.asarray(p0),) * 2),
                         None, steps)

  def port(sem_v):
    us, ps, _, _ = interop.nodal_state_from_arrays(
        (u0, u0), (p0, p0), device='cpu', dtype=torch.float64)
    step = lambda us, ps, ft: sem_v.stokes_one_step(list(us), list(ps), ft,
                                                   **kw)
    return _walled_steps(step, (tuple(us), tuple(ps)), torch.as_tensor(f),
                         steps)

  calls = []
  real = cuda_split.stiffness2d_affine_split_plain
  monkeypatch.setattr(cuda_split, 'stiffness2d_affine_split_plain',
                      lambda *a: calls.append(1) or real(*a))
  u, p = port(sem)
  assert calls, 'the bf16x3 step never ran the split plain version'
  assert _rel(u.numpy(), ju) <= 1e-10
  assert _rel(p.numpy(), jp) <= 1e-10
  # The class ran: 'highest' gives another answer (9e-7 apart in JAX).
  u_highest, _ = port(_walled()[1])
  assert _rel(u.numpy(), u_highest.numpy()) > 1e-8


def test_certified_datagen_step_at_bf16x3(monkeypatch, sems, state):
  """The port's certified datagen steps at 'bf16x3' run the split plain
  version, and give the JAX 'highest' certified steps' state: the
  stiffness enters only the CG certificate, and the FDM seed certifies."""
  jsem, sem = sems
  want, _ = _jax_advance(jsem, _jcfg(CFG), False)(*_jax_state(state))
  calls = []
  real = cuda_split.stiffness_uniform_split_plain
  monkeypatch.setattr(cuda_split, 'stiffness_uniform_split_plain',
                      lambda *a: calls.append(1) or real(*a))
  sem_b = dataclasses.replace(sem, fast_ops=dataclasses.replace(
      sem.fast_ops, kernel_precision='bf16x3'))
  assert sem_b.fast_ops.stiffness_key == ('congruent', 'bf16x3')
  advance = datagen.make_step_fn(sem_b, CFG, exact_solves=False)
  got, _ = advance(*interop.el_state_from_arrays(*state, device='cpu',
                                                 dtype=torch.float64))
  assert len(calls) >= CFG.num_steps_per_cycle
  _assert_state_close(got, want)
  _, _, _, aux = advance.one_step(*got)
  assert aux['u_star_info']['num_iterations'] <= 2

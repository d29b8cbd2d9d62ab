"""Parity of the port's generic q-function forms with ``swirlfem_tpu.core.fespace``.

Both packages build the same space (a 3x3 box, order 3, on Gauss-Legendre
and on collocated GLL quadrature) and evaluate the same forms on the same
numpy-seeded nodal values in float64: integrals, gradients and the
`local_covector` operator actions (mass, stiffness, convection, the mixed
divergence form), to 1e-12.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.core import fespace as jfes
from swirlfem_tpu.core.quadrature import Nodes1D as JNodes1D
from swirlfem_tpu.core.quadrature import NodeType as JNodeType
from swirlfem_tpu.core.quadrature import Quadrature1D as JQuadrature1D
from swirlfem_tpu.core.refine import refine_premesh as jrefine
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch.core import fespace
from swirlfem_tpu_torch.core.quadrature import Nodes1D
from swirlfem_tpu_torch.core.quadrature import NodeType
from swirlfem_tpu_torch.core.quadrature import Quadrature1D
from swirlfem_tpu_torch.core.refine import refine_premesh
from swirlfem_tpu_torch.utils.box import unit_cube_mesh

TOL = 1e-12


def _warp(c):
  """A smooth interior warp, so that every geometric factor counts."""
  bump = 0.05 * np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
  return np.stack([c[:, 0] + bump, c[:, 1] - 0.5 * bump], axis=-1)


@functools.lru_cache(maxsize=None)
def _spaces(quad: str, order: int = 3, n: int = 3):
  """(JAX mesh, JAX space, port mesh, port space) on the same geometry."""
  def build(ucm, refine, nodes, ntype, qcls, fes_cls, **finalize):
    pm = ucm(n, ndim=2)
    grid = nodes.create(order + 1, ntype.GAUSS_LOBATTO_LEGENDRE)
    refined = refine(pm, grid)
    refined = refined.replace(node_coords=_warp(np.asarray(
        refined.node_coords, dtype=np.float64)))
    mesh = refined.finalize(**finalize)
    if quad == 'gl':
      q = qcls.create(order + 2, ntype.GAUSS_LEGENDRE)
    else:
      q = qcls.create_from_nodes_1d(grid)
    return mesh, fes_cls.create(mesh, q)

  jmesh, jspace = build(junit_cube_mesh, jrefine, JNodes1D, JNodeType,
                        JQuadrature1D, jfes.FiniteElementSpace)
  mesh, space = build(unit_cube_mesh, refine_premesh, Nodes1D, NodeType,
                      Quadrature1D, fespace.FiniteElementSpace,
                      device='cpu')
  return jmesh, jspace, mesh, space


def _rel(got, want):
  got, want = np.asarray(got), np.asarray(want)
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _fields(mesh, seed):
  rng = np.random.default_rng(seed)
  return (rng.standard_normal(mesh.num_nodes),
          rng.standard_normal((mesh.num_nodes, 2)))


def _gather(mesh, u, to):
  if u.ndim == 1:
    return mesh.gather(to(u))
  return (jax.vmap(mesh.gather, in_axes=-1, out_axes=-1)(to(u))
          if to is jnp.asarray else
          torch.stack([mesh.gather(to(u[:, i])) for i in range(u.shape[1])],
                      dim=-1))


@pytest.mark.parametrize('quad', ['gl', 'gll'])
def test_space_factors_match(quad):
  _, jspace, _, space = _spaces(quad)
  for name in ('invjacs', 'jacdets', 'quad_coords'):
    assert _rel(getattr(space, name).numpy(),
                getattr(jspace, name)) <= TOL, name


@pytest.mark.parametrize('quad', ['gl', 'gll'])
def test_integrals_match(quad):
  jmesh, jspace, mesh, space = _spaces(quad)
  s, _ = _fields(mesh, 0)
  jq = jspace.scalar_function(jmesh.gather(jnp.asarray(s)))
  q = space.scalar_function(mesh.gather(torch.as_tensor(s)))
  cases = [
      # a nodal field, a batch-style closed form, a pointwise closed form
      (lambda x: q(x), lambda x: jq(x)),
      (lambda x: x[..., 0] ** 2 * x[..., 1], lambda x: x[..., 0] ** 2 * x[..., 1]),
      (lambda x: torch.sin(x[0]) * x[1], lambda x: jnp.sin(x[0]) * x[1]),
      (lambda x: fespace.grad(q)(x)[..., 1] * q(x),
       lambda x: jfes.grad(jq)(x)[..., 1] * jq(x)),
  ]
  for i, (f, jf) in enumerate(cases):
    got, want = float(space.integrate(f)), float(jspace.integrate(jf))
    assert abs(got - want) <= TOL * max(abs(want), 1.0), (i, got, want)


def test_closed_form_and_nodal_gradients():
  jmesh, jspace, mesh, space = _spaces('gl')
  f = lambda x: x[0] ** 2 * x[1] + torch.sin(x[1])
  jf = lambda x: x[0] ** 2 * x[1] + jnp.sin(x[1])
  assert _rel(space.evaluate(fespace.grad(f)).numpy(),
              jspace.evaluate(jfes.grad(jf))) <= TOL
  _, u = _fields(mesh, 4)
  jv = jspace.vector_function(_gather(jmesh, u, jnp.asarray))
  v = space.vector_function(_gather(mesh, u, torch.as_tensor))
  assert _rel(space.evaluate(fespace.grad(v)).numpy(),
              jspace.evaluate(jfes.grad(jv))) <= TOL
  assert _rel(space.evaluate(fespace.div(v)).numpy(),
              jspace.evaluate(jfes.div(jv))) <= TOL


def _mass(a, b):
  return lambda x: a(x) * b(x)


def _stiff_t(inner):
  def form(grad):
    return lambda a, b: (lambda x: inner(grad(a)(x), grad(b)(x)))
  return form


@pytest.mark.parametrize('quad', ['gl', 'gll'])
@pytest.mark.parametrize('form', ['mass', 'stiffness', 'convection',
                                  'vector_stiffness', 'divergence'])
def test_local_covector_matches(quad, form):
  jmesh, jspace, mesh, space = _spaces(quad)
  s, u = _fields(mesh, 1)
  js, ts = jnp.asarray, torch.as_tensor
  jsl, sl = jmesh.gather(js(s)), mesh.gather(ts(s))
  jul, ul = _gather(jmesh, u, js), _gather(mesh, u, ts)
  if form == 'mass':
    jf, f = _mass, _mass
    jargs = (jspace.scalar_function(jsl), jspace.scalar_function(None))
    args = (space.scalar_function(sl), space.scalar_function(None))
  elif form in ('stiffness', 'vector_stiffness'):
    jf = _stiff_t(jfes.inner)(jfes.grad)
    f = _stiff_t(fespace.inner)(fespace.grad)
    if form == 'stiffness':
      jargs = (jspace.scalar_function(jsl), jspace.scalar_function(None))
      args = (space.scalar_function(sl), space.scalar_function(None))
    else:
      jargs = (jspace.vector_function(jul), jspace.vector_function(None))
      args = (space.vector_function(ul), space.vector_function(None))
  elif form == 'convection':
    # int (u . grad theta) v: the scalar transport's trilinear form.
    def jf(a, t, v):
      return lambda x: jnp.einsum('eqi,eqi,eq->eq', a(x), jfes.grad(t)(x),
                                  v(x))

    def f(a, t, v):
      return lambda x: (a(x) * fespace.grad(t)(x)).sum(-1) * v(x)

    jargs = (jspace.vector_function(jul), jspace.scalar_function(jsl),
             jspace.scalar_function(None))
    args = (space.vector_function(ul), space.scalar_function(sl),
            space.scalar_function(None))
  else:
    # b(v, q) = int div(v) q with the vector slot open.
    def jf(v, q):
      return lambda x: jfes.div(v)(x) * q(x)

    def f(v, q):
      return lambda x: fespace.div(v)(x) * q(x)

    jargs = (jspace.vector_function(None), jspace.scalar_function(jsl))
    args = (space.vector_function(None), space.scalar_function(sl))
  want = jspace.local_covector(jf, jargs)
  got = space.local_covector(f, args)
  assert tuple(got.shape) == tuple(want.shape)
  assert _rel(got.numpy(), want) <= TOL, _rel(got.numpy(), want)


def test_local_covector_validates_its_slot():
  _, _, mesh, space = _spaces('gl')
  s = mesh.gather(torch.as_tensor(_fields(mesh, 2)[0]))
  with pytest.raises(ValueError, match='open slot'):
    space.local_covector(_mass, (space.scalar_function(s),
                                 space.scalar_function(s)))
  # The transpose is taken under no_grad callers too and carries no graph.
  with torch.no_grad():
    cov = space.local_covector(_mass, (space.scalar_function(s),
                                       space.scalar_function(None)))
  assert not cov.requires_grad


def test_mass_local_is_the_mass_form():
  _, _, mesh, space = _spaces('gl')
  _, u = _fields(mesh, 3)
  ul = _gather(mesh, u, torch.as_tensor)
  want = space.local_covector(
      lambda a, b: (lambda x: fespace.inner(a(x), b(x))),
      (space.vector_function(ul), space.vector_function(None)))
  assert _rel(space.mass_local(ul).numpy(), want.numpy()) <= TOL

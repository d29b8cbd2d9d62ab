"""The two-level Schwarz pressure preconditioner: the port against the JAX
package in float64 on the CPU.

Cases: the 6x6 order-5 cavity (enclosed: E singular, the constant pressure
projected), the small Schaefer-Turek cylinder (``ns=4, nr=3, nx_down=10``,
order 4: the do-nothing outflow makes E nonsingular) and the 2^3 order-3
cube; the 3^3 cube and the mixed-orientation cube of ``tests/test_schwarz.py``
for the 3D tables.  The host tables, colourings and adjacencies are held bitwise to the
JAX functions', the probed blocks and ``M(r)`` to 1e-10 (with the p1dg, the
vertex and the Chebyshev vertex coarse spaces), the PCG iteration counts
within one, and one cylinder step to 1e-8.

The JAX builder probes E through ``lax.map`` outside any jit, which compiles
each probe colour anew, and rebuilds its Q1 element stiffness at each call;
here the oracle's probe applies run under one ``jax.jit`` of the same
vmapped E and its element stiffness is computed once a premesh
(``torch_port_jax_probes``).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.core.bc import BCType as JBC
from swirlfem_tpu.linalg.cg import cg as jcg
from swirlfem_tpu.nse.solver import StokesSEM as JSEM
from swirlfem_tpu.ops import schwarz as js
from swirlfem_tpu.utils.box import unit_cube_mesh as jbox
from swirlfem_tpu.utils.cylinder import cylinder_channel_premesh as jcyl_mesh
from swirlfem_tpu.utils.cylinder import make_cylinder_snap as jsnap
from swirlfem_tpu_torch.core.bc import BCType as TBC
from swirlfem_tpu_torch.linalg.cg import cg as tcg
from swirlfem_tpu_torch.nse.solver import StokesSEM as TSEM
from swirlfem_tpu_torch.ops import schwarz as ts
from swirlfem_tpu_torch.utils.box import unit_cube_mesh as tbox
from swirlfem_tpu_torch.utils.cylinder import cylinder_channel_premesh as tcyl_mesh
from swirlfem_tpu_torch.utils.cylinder import make_cylinder_snap as tsnap
import torch_port_jax_probes
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

DT, TIME_ORDER = 1e-3, 2
F64 = dict(device='cpu', dtype=torch.float64)
CYLINDER = dict(ns=4, nr=3, nx_down=10)


def _rel(a, b):
  a, b = np.asarray(a), np.asarray(b)
  return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope='module', autouse=True)
def _fast_jax_probes():
  with torch_port_jax_probes.patched():
    yield


def _cavity():
  bcs = ({'boundary': (JBC.DIRICHLET, 0.0)},
         {'boundary': (TBC.DIRICHLET, 0.0)})
  return jbox(6, ndim=2), tbox(6, ndim=2), bcs, 5, {}


def _cylinder():
  names = ('cylinder', 'walls', 'inflow')
  bcs = ({n: (JBC.DIRICHLET, 0.0) for n in names},
         {n: (TBC.DIRICHLET, 0.0) for n in names})
  jpm, tpm = jcyl_mesh(**CYLINDER), tcyl_mesh(**CYLINDER)
  snaps = (dict(coord_transform=jsnap(jpm, radius=0.05, center=(0.2, 0.2))),
           dict(coord_transform=tsnap(tpm, radius=0.05, center=(0.2, 0.2))))
  return jpm, tpm, bcs, 4, snaps


def _cube():
  bcs = ({'boundary': (JBC.DIRICHLET, 0.0)},
         {'boundary': (TBC.DIRICHLET, 0.0)})
  return jbox(2, ndim=3), tbox(2, ndim=3), bcs, 3, {}


_MAKERS = {'cavity': _cavity, 'cylinder': _cylinder, 'cube': _cube}


class _Cases:
  """Each case's premeshes and solvers in both packages, built once; each
  preconditioner built once per (case, coarse, overlap)."""

  def __init__(self):
    self._cases, self._pre = {}, {}

  def __getitem__(self, name):
    if name not in self._cases:
      jpm, tpm, (jbcs, tbcs), order, snaps = _MAKERS[name]()
      jkw, tkw = snaps or ({}, {})
      jsem = JSEM.create(jpm, boundary_conditions=jbcs, order=order, **jkw)
      tsem = TSEM.create(tpm, boundary_conditions=tbcs, order=order, **F64,
                         **tkw)
      self._cases[name] = dict(jpm=jpm, tpm=tpm, jbcs=jbcs, tbcs=tbcs,
                               jsem=jsem, tsem=tsem)
    return self._cases[name]

  def pre(self, name, coarse='auto', overlap='auto'):
    key = (name, coarse, overlap)
    if key not in self._pre:
      c = self[name]
      self._pre[key] = (
          c['jsem'].schwarz_pressure_preconditioner(
              c['jpm'], c['jbcs'], DT, TIME_ORDER, coarse=coarse,
              overlap=overlap),
          c['tsem'].schwarz_pressure_preconditioner(
              c['tpm'], c['tbcs'], DT, TIME_ORDER, coarse=coarse,
              overlap=overlap))
    return self._pre[key]


@pytest.fixture(scope='module')
def cases():
  return _Cases()


def _vertex_tables(mod, premesh):
  uid = mod._vertex_unique_ids(premesh)  # pylint: disable=protected-access
  el_uid = uid[np.asarray(premesh.elements)]
  return uid, el_uid, int(uid.max()) + 1


@pytest.mark.parametrize('name', ['cavity', 'cylinder'])
def test_host_tables_2d_are_the_jax_tables(cases, name):
  c = cases[name]
  juid, jel_uid, jnv = _vertex_tables(js, c['jpm'])
  tuid, tel_uid, tnv = _vertex_tables(ts, c['tpm'])
  np.testing.assert_array_equal(tuid, juid)
  np.testing.assert_array_equal(tel_uid, jel_uid)
  assert tnv == jnv
  adj = js._element_adjacency(jel_uid)  # pylint: disable=protected-access
  assert ts._element_adjacency(jel_uid) == adj  # pylint: disable=protected-access
  for fn in ('_greedy_coloring', '_distance2_coloring'):
    np.testing.assert_array_equal(getattr(ts, fn)(adj), getattr(js, fn)(adj))
  elements = c['tsem'].pressure.pspace.mesh.elements.numpy()
  np.testing.assert_array_equal(
      elements, np.asarray(c['jsem'].pressure.pspace.mesh.elements))
  np.testing.assert_array_equal(
      ts._boundary_vertices(np.asarray(c['tpm'].elements), tuid, 2),  # pylint: disable=protected-access
      js._boundary_vertices(np.asarray(c['jpm'].elements), juid, 2))  # pylint: disable=protected-access
  assert (ts._has_outflow(c['tpm'], c['tbcs'], tuid)  # pylint: disable=protected-access
          == js._has_outflow(c['jpm'], c['jbcs'], juid) == (name == 'cylinder'))  # pylint: disable=protected-access
  np.testing.assert_array_equal(
      ts._outflow_vertices(c['tpm'], c['tbcs'], tuid),  # pylint: disable=protected-access
      js._outflow_vertices(c['jpm'], c['jbcs'], juid))  # pylint: disable=protected-access
  assert (ts._face_adjacency_2d(jel_uid)  # pylint: disable=protected-access
          == js._face_adjacency_2d(jel_uid))  # pylint: disable=protected-access
  m = c['tsem'].pressure.pspace.mesh.order + 1
  for got, want in zip(ts._extended_tables(jel_uid, elements, m, 2),  # pylint: disable=protected-access
                       js._extended_tables(jel_uid, elements, m, 2)):  # pylint: disable=protected-access
    np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(
      ts._vertex_stencil(c['tsem'].pressure.pspace.mesh, 2),  # pylint: disable=protected-access
      js._vertex_stencil(c['jsem'].pressure.pspace.mesh, 2))  # pylint: disable=protected-access
  # The Q1 vertex coarse operator's COO triplets (its element stiffness
  # inside; its inverse is held through `test_apply_matches_jax`'s vertex
  # coarse cases).
  has_null = name == 'cavity'
  got = ts._vertex_coarse_coo(c['tpm'], c['tbcs'], tuid, tel_uid, tnv,  # pylint: disable=protected-access
                              has_null, ground_vertex0=True)
  want = js._vertex_coarse_coo(c['jpm'], c['jbcs'], juid, jel_uid, jnv,  # pylint: disable=protected-access
                               has_null, ground_vertex0=True)
  for a, b in zip(got[:2], want[:2]):
    np.testing.assert_array_equal(a, b)
  assert _rel(got[2], want[2]) <= 1e-12 and abs(got[3] - want[3]) <= (
      1e-12 * abs(want[3]))
  sym = np.random.default_rng(1).standard_normal((9, 9))
  sym = sym @ sym.T
  sym[:, 0] = sym[0, :] = 0.0
  got, want = ts._pinv_psd(sym), js._pinv_psd(sym)  # pylint: disable=protected-access
  assert got[1] == want[1] is True and _rel(got[0], want[0]) <= 1e-12


def _rotated_cube_elements(mod):
  """The mixed-orientation cube of ``tests/test_schwarz.py``: every
  element's corners under a random proper rotation."""
  corners = np.array([[(i >> 2) & 1, (i >> 1) & 1, i & 1]
                      for i in range(8)]) * 2 - 1
  rots = []
  for perm in itertools.permutations(range(3)):
    for signs in itertools.product((1, -1), repeat=3):
      m = np.zeros((3, 3))
      for i, p in enumerate(perm):
        m[i, p] = signs[i]
      if np.linalg.det(m) > 0:
        rc = corners @ m.T
        rots.append(np.array(
            [np.nonzero((corners == r).all(1))[0][0] for r in rc]))
  premesh = mod(3, ndim=3)
  elements = np.array(premesh.elements)
  rng = np.random.default_rng(7)
  for e in range(len(elements)):
    elements[e] = elements[e][rots[rng.integers(len(rots))]]
  return premesh.replace(elements=elements)


@pytest.mark.parametrize('mixed', [False, True])
def test_host_tables_3d_are_the_jax_tables(mixed):
  jpm = _rotated_cube_elements(jbox) if mixed else jbox(3, ndim=3)
  tpm = _rotated_cube_elements(tbox) if mixed else tbox(3, ndim=3)
  np.testing.assert_array_equal(np.asarray(tpm.elements),
                                np.asarray(jpm.elements))
  _, el_uid, _ = _vertex_tables(js, jpm)
  np.testing.assert_array_equal(_vertex_tables(ts, tpm)[1], el_uid)
  adj = js._element_adjacency(el_uid)  # pylint: disable=protected-access
  assert ts._element_adjacency(el_uid) == adj  # pylint: disable=protected-access
  np.testing.assert_array_equal(ts._distance2_coloring(adj),  # pylint: disable=protected-access
                                js._distance2_coloring(adj))  # pylint: disable=protected-access
  assert ts._face_adjacency_3d(el_uid) == js._face_adjacency_3d(el_uid)  # pylint: disable=protected-access
  m = 2  # order 3: the pressure's GL points per axis
  elements = np.arange(27 * m ** 3).reshape(27, m ** 3)
  got = ts._extended_tables(el_uid, elements, m, 3)  # pylint: disable=protected-access
  for a, b in zip(got, js._extended_tables(el_uid, elements, m, 3)):  # pylint: disable=protected-access
    np.testing.assert_array_equal(a, b)
  ext_nodes, ext_owner, ext_local = got
  live = ext_owner >= 0
  np.testing.assert_array_equal(ext_nodes[live],
                                elements[ext_owner[live], ext_local[live]])


@pytest.mark.parametrize('name', ['cavity', 'cylinder'])
def test_probed_blocks_match_jax(cases, name):
  c = cases[name]
  _, el_uid, _ = _vertex_tables(ts, c['tpm'])
  adj = ts._element_adjacency(el_uid)  # pylint: disable=protected-access
  colors = ts._distance2_coloring(adj)  # pylint: disable=protected-access
  elements = c['tsem'].pressure.pspace.mesh.elements.numpy()
  npn = c['tsem'].pressure.pspace.mesh.num_nodes
  tb, tpairs = ts._probe_element_blocks(  # pylint: disable=protected-access
      ts._matvec64(c['tsem'], DT, TIME_ORDER), elements, colors, npn,  # pylint: disable=protected-access
      adj=adj)
  jb, jpairs = js._probe_element_blocks(  # pylint: disable=protected-access
      torch_port_jax_probes.jitted_matvec64(c['jsem'], DT, TIME_ORDER), elements, colors, npn,
      adj=adj)
  assert _rel(tb, jb) <= 1e-10
  assert sorted(tpairs) == sorted(jpairs)
  scale = float(np.abs(jb).max())
  assert max(float(np.abs(tpairs[k] - jpairs[k]).max())
             for k in jpairs) <= 1e-10 * scale
  # The extended blocks built from them.
  m = c['tsem'].pressure.pspace.mesh.order + 1
  _, ext_owner, ext_local = ts._extended_tables(el_uid, elements, m, 2)  # pylint: disable=protected-access
  assert _rel(ts._extended_blocks(tpairs, adj, ext_owner, ext_local),  # pylint: disable=protected-access
              js._extended_blocks(jpairs, adj, ext_owner, ext_local)) <= 1e-10  # pylint: disable=protected-access


@pytest.mark.parametrize('name,coarse,overlap', [
    (name, coarse, overlap) for name in ('cavity', 'cylinder')
    for coarse in ('p1dg', 'vertex') for overlap in (0, 1)] + [
        ('cube', 'auto', 0), ('cube', 'auto', 1),
        # The matrix-free Chebyshev vertex coarse (ops.coarse_cheb), which
        # a vertex space past `max_coarse_dofs` takes.
        ('cavity', 'vertex-cheb', 1), ('cylinder', 'vertex-cheb', 0)])
def test_apply_matches_jax(cases, name, coarse, overlap):
  jm, tm = cases.pre(name, coarse, overlap)
  c = cases[name]
  npn = c['tsem'].pressure.pspace.mesh.num_nodes
  rng = np.random.default_rng(11)
  r, q = rng.standard_normal(npn), rng.standard_normal(npn)
  assert tm.has_nullspace == jm.has_nullspace == (name != 'cylinder')
  assert tm.coarse == ('p1dg' if coarse == 'auto' else coarse)
  assert tm.overlap == overlap
  got = tm(torch.as_tensor(r)).numpy()
  assert _rel(got, jm(jnp.asarray(r))) <= 1e-10
  assert _rel(tm.fast_matvec(torch.as_tensor(r)).numpy(),
              jm.fast_matvec(jnp.asarray(r))) <= 1e-10
  # Symmetric positive, on the mean-free space where E is singular (the
  # projection follows the apply there).
  if tm.has_nullspace:
    assert abs(float(got.sum())) <= 1e-10 * float(np.abs(got).sum())
    r, q = r - r.mean(), q - q.mean()
    got = tm(torch.as_tensor(r)).numpy()
  mq = tm(torch.as_tensor(q)).numpy()
  assert abs(r @ mq - q @ got) <= 1e-10 * abs(q @ mq)
  assert q @ mq > 0 and r @ got > 0


@pytest.mark.parametrize('name', ['cavity', 'cylinder'])
def test_pcg_iterations_match_jax(cases, name):
  jm, tm = cases.pre(name)
  c = cases[name]
  npn = c['tsem'].pressure.pspace.mesh.num_nodes
  r = np.random.default_rng(13).standard_normal(npn)
  if tm.has_nullspace:
    r = r - r.mean()
  jsem, tsem = c['jsem'], c['tsem']
  jx, jinfo = jcg(jax.jit(lambda p: jsem.E(p, DT, TIME_ORDER)),
                  jnp.asarray(r), M=jm, tol=1e-8, maxiter=500)
  tx, tinfo = tcg(lambda p: tsem.E(p, DT, TIME_ORDER), torch.as_tensor(r),
                  M=tm, tol=1e-8, maxiter=500)
  ji, ti = int(jinfo['num_iterations']), int(tinfo['num_iterations'])
  assert abs(ti - ji) <= 1, (ti, ji)
  assert ti < 60, ti
  assert _rel(tx.numpy(), jx) <= 1e-6


def test_cylinder_step_with_schwarz_matches_jax(cases):
  jm, tm = cases.pre('cylinder')
  c = cases['cylinder']
  jsem, tsem = c['jsem'], c['tsem']
  nv = tsem.velocity.mesh.num_nodes
  npn = tsem.pressure.pspace.mesh.num_nodes
  mask = np.asarray(tsem.velocity.interior_mask)
  u0 = np.random.default_rng(3).standard_normal((nv, 2)) * 1e-2 * mask
  kwargs = dict(mu=1e-3, dt=DT, time_order=TIME_ORDER, tol=1e-10,
                project_out_nullspace=False)

  @jax.jit
  def jstep(u):
    p = jnp.zeros(npn)
    return jsem.stokes_one_step([u, u], [p, p], jnp.zeros_like(u),
                                pressure_preconditioner=jm, **kwargs)

  ju, jp, jaux = jstep(jnp.asarray(u0))
  tu0 = torch.as_tensor(u0)
  tp0 = torch.zeros(npn, dtype=torch.float64)
  tu, tp, taux = tsem.stokes_one_step(
      [tu0, tu0], [tp0, tp0], torch.zeros_like(tu0),
      pressure_preconditioner=tm, **kwargs)
  assert _rel(tu.numpy(), ju) <= 1e-8
  assert _rel(tp.numpy(), jp) <= 1e-8
  ti = int(taux['dp_info']['num_iterations'])
  assert abs(ti - int(jaux['dp_info']['num_iterations'])) <= 1


def test_partitioned_premesh_is_refused(cases):
  c = cases['cavity']
  parts = c['tpm'].replace(partitions=np.zeros(c['tpm'].num_elements,
                                                 dtype=np.int64))
  with pytest.raises(NotImplementedError, match='item 17'):
    ts.build_schwarz_pressure_solver(c['tsem'], parts, c['tbcs'], DT,
                                     TIME_ORDER)
  with pytest.raises(ValueError, match='order-1'):
    ts.build_schwarz_pressure_solver(
        c['tsem'], c['tpm'].replace(order=2), c['tbcs'], DT, TIME_ORDER)

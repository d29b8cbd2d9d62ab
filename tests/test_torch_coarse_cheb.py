"""The matrix-free Chebyshev vertex coarse solve: the port against the JAX
package in float64 on the CPU.

`ChebCoarse`'s tables (the padded ELL operator, the Jacobi diagonal, the
aggregates and their dense inverse), its seeded PCG eigenvalue bounds and
its verified degree are the JAX package's, from the same coarse operator;
`solve` agrees to 1e-10 on an enclosed cavity (the constant pressure
projected) and on a small Schaefer-Turek cylinder (outflow pinned).  Inside
the Schwarz preconditioner (``coarse='vertex-cheb'``) ``M(r)`` is held to the
JAX package's in ``tests/test_torch_schwarz.py::test_apply_matches_jax``,
beside the other coarse spaces, on that file's solvers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.core.bc import BCType as JBC
from swirlfem_tpu.ops import coarse_cheb as jcc
from swirlfem_tpu.ops import schwarz as js
from swirlfem_tpu.utils.box import unit_cube_mesh as jbox
from swirlfem_tpu.utils.cylinder import cylinder_channel_premesh as jcyl_mesh
from swirlfem_tpu_torch.core.bc import BCType as TBC
from swirlfem_tpu_torch.ops import coarse_cheb as tcc
from swirlfem_tpu_torch.ops import schwarz as ts
from swirlfem_tpu_torch.utils.box import unit_cube_mesh as tbox
from swirlfem_tpu_torch.utils.cylinder import cylinder_channel_premesh as tcyl_mesh
import torch_port_jax_probes
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

DT, TIME_ORDER = 1e-3, 2
WALLS = ('cylinder', 'walls', 'inflow')


def _rel(a, b):
  a, b = np.asarray(a), np.asarray(b)
  return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _case(name):
  if name == 'cavity':
    return (jbox(8, ndim=2), tbox(8, ndim=2),
            {'boundary': (JBC.DIRICHLET, 0.0)},
            {'boundary': (TBC.DIRICHLET, 0.0)})
  return (jcyl_mesh(ns=4, nr=3, nx_down=6), tcyl_mesh(ns=4, nr=3, nx_down=6),
          {n: (JBC.DIRICHLET, 0.0) for n in WALLS},
          {n: (TBC.DIRICHLET, 0.0) for n in WALLS})


def _ell_dense(idx, val, nv):
  dense = np.zeros((nv, nv))
  np.add.at(dense, (np.repeat(np.arange(nv), idx.shape[1]), idx.reshape(-1)),
            val.reshape(-1))
  return dense


@pytest.fixture(scope='module', autouse=True)
def _cheap_jax_setup():
  with torch_port_jax_probes.patched():
    yield


@pytest.fixture(scope='module', params=['cavity', 'cylinder'])
def both(request):
  """The JAX `ChebCoarse` of one coarse operator, the port's of its own
  operator, and the port's of the JAX operator's triplets."""
  jpm, tpm, jbcs, tbcs = _case(request.param)
  uid = js._vertex_unique_ids(jpm)  # pylint: disable=protected-access
  el_uid = uid[np.asarray(jpm.elements)]
  nv = int(uid.max()) + 1
  has_null = not js._has_outflow(jpm, jbcs, uid)  # pylint: disable=protected-access
  args = (uid, el_uid, nv, DT, TIME_ORDER, has_null)
  jc = jcc.build_cheb_vertex_coarse(jpm, jbcs, *args, rdtype=np.float64,
                                    tol=1e-6)
  port = dict(dtype=torch.float64, device='cpu', tol=1e-6)
  tc = tcc.build_cheb_vertex_coarse(tpm, tbcs, *args, **port)
  coo = js._vertex_coarse_coo(jpm, jbcs, uid, el_uid, nv, has_null,  # pylint: disable=protected-access
                              ground_vertex0=False)
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(ts, '_vertex_coarse_coo', lambda *a, **k: coo)
    tc_jop = tcc.build_cheb_vertex_coarse(tpm, tbcs, *args, **port)
  return request.param, jc, tc, tc_jop, nv


def test_tables_bounds_and_degree_are_the_jax_ones(both):
  name, jc, tc, tc_jop, nv = both
  assert tc.has_nullspace == jc.has_nullspace == (name == 'cavity')
  # The set-up is a function of the coarse operator: from the JAX
  # operator's own triplets the port's tables, bounds and degree are the
  # JAX package's.
  for field in ('ell_idx', 'agg_id'):
    np.testing.assert_array_equal(getattr(tc_jop, field).numpy(),
                                  np.asarray(getattr(jc, field)))
  for field in ('num_aggregates', 'degree', 'has_nullspace'):
    assert getattr(tc_jop, field) == getattr(jc, field), field
  for field in ('ell_val', 'dinv', 'acc_inv'):
    assert _rel(getattr(tc_jop, field).numpy(),
                np.asarray(getattr(jc, field))) <= 1e-12, field
  for field in ('lam_min', 'lam_max', 'scale', 'verified_rel_residual'):
    assert abs(getattr(tc_jop, field) - float(getattr(jc, field))) <= (
        1e-12 * abs(float(getattr(jc, field)))), field
  # The port's own operator is the JAX one to rounding.  Entries that
  # cancel to rounding level (true value 0) may round to an exact zero,
  # which the set-up drops, in one package and not in the other (on the
  # cylinder one entry of 915 does), and the aggregation reads that
  # pattern; every entry above rounding is in both patterns.
  jdense, tdense = (_ell_dense(np.asarray(c.ell_idx), np.asarray(c.ell_val),
                               nv) for c in (jc, tc))
  assert _rel(tdense, jdense) <= 1e-12
  cut = 1e-12 * np.abs(jdense).max()
  np.testing.assert_array_equal(np.abs(tdense) > cut, np.abs(jdense) > cut)
  assert tc.verified_rel_residual <= 1e-6
  if name == 'cavity':  # no such entry: the same tables
    np.testing.assert_array_equal(tc.agg_id.numpy(), np.asarray(jc.agg_id))
    assert tc.degree == jc.degree
  # The aggregates' fixed-order sum is the segment sum over `agg_id`.
  r = np.random.default_rng(0).standard_normal(nv)
  np.testing.assert_allclose(
      tc.agg_sum.sum(torch.as_tensor(r)).numpy(),
      np.bincount(tc.agg_id.numpy(), weights=r,
                  minlength=tc.num_aggregates), rtol=0, atol=1e-13)


def test_solve_matches_jax(both):
  name, jc, tc, tc_jop, nv = both
  rng = np.random.default_rng(1)
  r = rng.standard_normal(nv)
  want = np.asarray(jax.jit(jc.solve)(jnp.asarray(r)))
  assert _rel(tc_jop.solve(torch.as_tensor(r)).numpy(), want) <= 1e-10
  got = tc.solve(torch.as_tensor(r)).numpy()
  # From its own operator: to 1e-10 where the tables are the same, else to
  # the solve's verified contraction (1e-6).
  assert _rel(got, want) <= (1e-10 if name == 'cavity' else 1e-5)
  # Linear, and the numpy twin of the set-up is the deployed polynomial.
  q = rng.standard_normal(nv)
  lin = tc.solve(torch.as_tensor(2.0 * r - 3.0 * q)).numpy()
  assert _rel(lin, 2.0 * got - 3.0 * tc.solve(torch.as_tensor(q)).numpy()
              ) <= 1e-10
  twin, _ = tcc._cheb_solve_np(  # pylint: disable=protected-access
      lambda v: (tc.ell_val * torch.as_tensor(v)[tc.ell_idx]).sum(1).numpy(),
      lambda v: tc._precond(torch.as_tensor(v)).numpy(),  # pylint: disable=protected-access
      r, tc.lam_min, tc.lam_max, tc.degree, tc.has_nullspace)
  assert _rel(got, tc.scale * twin) <= 1e-12
  if name == 'cavity':
    assert float(tc.solve(torch.ones(nv, dtype=torch.float64)).abs().max()
                 ) <= 1e-8

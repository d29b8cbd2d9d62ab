"""The fixed-order scatter-add of the unstructured paths.

`topology.ScatterTable` sums each target's copies by a padded copy table
(ascending source positions) instead of an ``index_add_``, whose colliding
adds run in no fixed order on CUDA.  Here, on the CPU: the scatter, the
shared-dof exchange and the solver's E-last sum against the ``index_add_``
form, under `torch.func.vmap` and through autograd, on the Schaefer-Turek
cylinder's meshes; and the table against a brute-force one.  The card's
run-to-run equality is the `cuda`-marked test at the end (skipped here).
"""

import numpy as np
import pytest
import torch

from swirlfem_tpu_torch.core import topology
from swirlfem_tpu_torch.examples import cylinder as tcyl
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

SMALL = dict(ns=4, nr=3, nx_down=10)


def _rel(a, b):
  a, b = np.asarray(a), np.asarray(b)
  return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope='module')
def sem():
  return tcyl.make_cylinder_sem(4, **SMALL, device='cpu', dtype=torch.float64,
                                unstructured_el_ops=True)


def _index_add(values, indices, num):
  keep = indices.reshape(-1) >= 0
  return values.new_zeros((num,) + values.shape[1:]).index_add_(
      0, indices.reshape(-1)[keep], values[keep])


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_copy_table_lists_every_copy_in_ascending_order(seed):
  rng = np.random.default_rng(seed)
  num = 17
  indices = rng.integers(-1, num, size=(9, 7))
  indices[0, :] = topology.SENTINEL
  table = topology.copy_table(indices, num)
  flat = indices.reshape(-1)
  for i in range(num):
    want = np.nonzero(flat == i)[0]
    got = table[i][table[i] != topology.SENTINEL]
    np.testing.assert_array_equal(got, want)
    assert (table[i, len(want):] == topology.SENTINEL).all()
  assert table.shape[1] == max(1, np.bincount(flat[flat >= 0]).max())


def test_scatter_and_exchange_match_index_add(sem):
  rng = np.random.default_rng(3)
  vmesh = sem.velocity.mesh
  pmesh = sem.pressure.pspace.mesh
  for mesh in (vmesh, pmesh):
    u = torch.as_tensor(rng.standard_normal(tuple(mesh.elements.shape)))
    want = _index_add(u.reshape(-1), mesh.elements, mesh.num_nodes)
    got = mesh.scatter(u)
    # Bitwise on the CPU: the copies are added in ascending position.
    assert torch.equal(got, want)
    assert _rel(got, want) <= 1e-14
  # The velocity's components in one sum, and the E-last transposed table.
  w = torch.as_tensor(rng.standard_normal(tuple(vmesh.elements.shape) + (2,)))
  want = _index_add(w.reshape(-1, 2), vmesh.elements, vmesh.num_nodes)
  assert torch.equal(sem.velocity.scatter(w), want)
  w_el = torch.as_tensor(rng.standard_normal(
      tuple(sem.nodal.v_el_t.shape)))
  want = _index_add(w_el.reshape(-1), sem.nodal.v_el_t, vmesh.num_nodes)
  assert torch.equal(sem._v_el_cov(w_el), want)  # pylint: disable=protected-access


def test_weighted_sum_is_the_sum(sem):
  """The card's form (the copies against the mask as weights in one
  `torch.bmm`) gives the CPU's sums to rounding, one and two components."""
  rng = np.random.default_rng(7)
  for mesh in (sem.velocity.mesh, sem.pressure.pspace.mesh):
    table = mesh.scatter_table
    for shape in ((mesh.elements.numel(),), (mesh.elements.numel(), 2)):
      v = torch.as_tensor(rng.standard_normal(shape))
      want = table.sum(v)
      got = table.weighted_sum(v)
      assert got.shape == want.shape
      assert _rel(got, want) <= 1e-14
      assert torch.equal(table.weighted_sum(v), got)


def test_exchange_matches_index_add_on_a_periodic_mesh():
  from swirlfem_tpu_torch.core.quadrature import Nodes1D, NodeType
  from swirlfem_tpu_torch.core.refine import refine_premesh
  # Without its box descriptor the box takes the generic refiner: node ids
  # by index, periodic images shared through the exchange tables.
  box = unit_cube_mesh(3, ndim=2, periodic_dims=(0, 1)).replace(box_info=None)
  pm = refine_premesh(box, Nodes1D.create(4, NodeType.GAUSS_LOBATTO_LEGENDRE))
  mesh = pm.finalize(device='cpu', dtype=torch.float64)
  assert mesh.exchange_table is not None
  u = torch.as_tensor(np.random.default_rng(4).standard_normal(
      mesh.num_nodes))
  gi, ui = mesh.exchange_gather_indices, mesh.exchange_unique_indices
  summed = u.new_zeros(int(ui.max()) + 1).index_add_(0, ui, u[gi])
  want = u.clone()
  want[gi] = summed[ui]
  got = mesh.exchange(u)
  assert torch.equal(got, want)
  # Every copy of a shared dof holds the same total.
  totals = got[gi]
  assert torch.equal(totals, summed[ui])


def test_scatter_under_vmap_and_autograd(sem):
  rng = np.random.default_rng(5)
  pmesh = sem.velocity.mesh
  batch = torch.as_tensor(rng.standard_normal(
      (4,) + tuple(pmesh.elements.shape)))
  got = torch.func.vmap(pmesh.scatter)(batch)
  for b in range(4):
    assert torch.equal(got[b], pmesh.scatter(batch[b]))
  # The gather's backward writes each element-local copy once: d/du of
  # <g, scatter(u)> is g gathered back to every copy.
  u = batch[0].clone().requires_grad_(True)
  g = torch.as_tensor(rng.standard_normal(pmesh.num_nodes))
  (grad,) = torch.autograd.grad((pmesh.scatter(u) * g).sum(), u)
  assert torch.equal(grad, g[pmesh.elements])
  (grad2,) = torch.autograd.grad((pmesh.scatter(u) * g).sum(), u)
  assert torch.equal(grad, grad2)


@pytest.mark.cuda
def test_scatter_on_the_card_is_bitwise_repeatable(sem):
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  device = torch.device('cuda', 0)
  mesh = sem.velocity.mesh.to(device, torch.float32)
  gen = torch.Generator(device=device).manual_seed(6)
  u = torch.randn(tuple(mesh.elements.shape), generator=gen, device=device)
  first = mesh.scatter(u)
  ex_first = mesh.exchange(first)
  for _ in range(20):
    assert torch.equal(mesh.scatter(u), first)
    assert torch.equal(mesh.exchange(first), ex_first)
  want = _index_add(u.double().reshape(-1).cpu(), mesh.elements.cpu(),
                    mesh.num_nodes)
  assert _rel(first.double().cpu(), want) <= 1e-6

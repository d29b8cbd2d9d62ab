"""Parity of the PyTorch port's host-side mesh setup with the JAX package.

Quadrature tables, refined periodic box meshes (structured and generic
refiner), exchange tables, structured gather/scatter/exchange and the
geometric factors must be identical (tables) or agree to float64 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.core import fespace as jfespace
from swirlfem_tpu.core import quadrature as jquad
from swirlfem_tpu.core.refine import refine_premesh as jrefine
from swirlfem_tpu.nse.solver import StokesSEM as JStokesSEM
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch.core import fespace
from swirlfem_tpu_torch.core import quadrature as quad
from swirlfem_tpu_torch.core.refine import refine_premesh
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

NODE_TYPES = ('GAUSS_LOBATTO_LEGENDRE', 'GAUSS_LEGENDRE', 'NEWTON_COTES')


@pytest.mark.parametrize('node_type', NODE_TYPES)
@pytest.mark.parametrize('num_points', [2, 4, 9])
def test_quadrature_tables_identical(node_type, num_points):
  jn = jquad.Nodes1D.create(num_points, getattr(jquad.NodeType, node_type))
  tn = quad.Nodes1D.create(num_points, getattr(quad.NodeType, node_type))
  np.testing.assert_array_equal(tn.points, jn.points)
  np.testing.assert_array_equal(
      quad.Quadrature1D.create_from_nodes_1d(tn).weights,
      jquad.Quadrature1D.create_from_nodes_1d(jn).weights)
  np.testing.assert_array_equal(quad.barycentric_weights(tn),
                                jquad.barycentric_weights(jn))
  np.testing.assert_array_equal(quad.differentiation_matrix_1d(tn),
                                jquad.differentiation_matrix_1d(jn))
  jg = jquad.Nodes1D.create(num_points + 2,
                            jquad.NodeType.GAUSS_LOBATTO_LEGENDRE)
  tg = quad.Nodes1D.create(num_points + 2,
                           quad.NodeType.GAUSS_LOBATTO_LEGENDRE)
  np.testing.assert_array_equal(quad.interpolation_matrix_1d(tn, tg),
                                jquad.interpolation_matrix_1d(jn, jg))
  np.testing.assert_array_equal(quad.interpolation_grad_matrix_1d(tn, tg),
                                jquad.interpolation_grad_matrix_1d(jn, jg))


def _assert_mesh_equal(tmesh, jmesh):
  np.testing.assert_array_equal(tmesh.node_coords.numpy(),
                                np.asarray(jmesh.node_coords))
  np.testing.assert_array_equal(tmesh.elements.numpy(),
                                np.asarray(jmesh.elements))
  np.testing.assert_array_equal(tmesh.node_indices.numpy(),
                                np.asarray(jmesh.node_indices))
  np.testing.assert_array_equal(tmesh.exchange_gather_indices.numpy(),
                                np.asarray(jmesh.exchange_gather_indices))
  np.testing.assert_array_equal(tmesh.exchange_unique_indices.numpy(),
                                np.asarray(jmesh.exchange_unique_indices))
  assert set(tmesh.physical_masks) == set(jmesh.physical_masks)
  for name, mask in jmesh.physical_masks.items():
    np.testing.assert_array_equal(tmesh.physical_masks[name].numpy(),
                                  np.asarray(mask))
  assert tmesh.order == jmesh.order
  if jmesh.structured is None:
    assert tmesh.structured is None
  else:
    assert vars(tmesh.structured) == vars(jmesh.structured)


@pytest.mark.parametrize('n,order,periodic,node_type', [
    (4, 3, (0, 1), 'GAUSS_LOBATTO_LEGENDRE'),
    (3, 5, (0,), 'GAUSS_LOBATTO_LEGENDRE'),
    (4, 4, (0, 1), 'GAUSS_LEGENDRE'),
    (2, 2, (), 'GAUSS_LOBATTO_LEGENDRE'),
])
@pytest.mark.parametrize('generic', [False, True])
def test_refined_box_mesh_identical(n, order, periodic, node_type, generic):
  """Structured fast path and (box_info dropped) the generic refiner."""
  jpm = junit_cube_mesh(n, ndim=2, periodic_dims=periodic)
  tpm = unit_cube_mesh(n, ndim=2, periodic_dims=periodic)
  if generic:
    jpm, tpm = jpm.replace(box_info=None), tpm.replace(box_info=None)
  npts = order + 1 if node_type == 'GAUSS_LOBATTO_LEGENDRE' else order - 1
  jgrid = jquad.Nodes1D.create(npts, getattr(jquad.NodeType, node_type))
  tgrid = quad.Nodes1D.create(npts, getattr(quad.NodeType, node_type))
  jref, tref = jrefine(jpm, jgrid), refine_premesh(tpm, tgrid)
  np.testing.assert_array_equal(tref.node_coords, jref.node_coords)
  np.testing.assert_array_equal(tref.elements, jref.elements)
  if jref.periodic_links is None:
    assert tref.periodic_links is None
  else:
    np.testing.assert_array_equal(tref.periodic_links, jref.periodic_links)
  _assert_mesh_equal(tref.finalize(device='cpu'), jref.finalize())


def test_refine_3d_generic_identical():
  jpm = junit_cube_mesh(2, ndim=3, periodic_dims=(2,)).replace(box_info=None)
  tpm = unit_cube_mesh(2, ndim=3, periodic_dims=(2,)).replace(box_info=None)
  jgrid = jquad.Nodes1D.create(3, jquad.NodeType.GAUSS_LOBATTO_LEGENDRE)
  tgrid = quad.Nodes1D.create(3, quad.NodeType.GAUSS_LOBATTO_LEGENDRE)
  _assert_mesh_equal(refine_premesh(tpm, tgrid).finalize(device='cpu'),
                     jrefine(jpm, jgrid).finalize())


@pytest.mark.parametrize('structured', [True, False])
def test_gather_scatter_exchange_match(structured):
  jpm = junit_cube_mesh(4, ndim=2, periodic_dims=(0, 1))
  tpm = unit_cube_mesh(4, ndim=2, periodic_dims=(0, 1))
  if not structured:
    jpm, tpm = jpm.replace(box_info=None), tpm.replace(box_info=None)
  jgrid = jquad.Nodes1D.create(5, jquad.NodeType.GAUSS_LOBATTO_LEGENDRE)
  tgrid = quad.Nodes1D.create(5, quad.NodeType.GAUSS_LOBATTO_LEGENDRE)
  jmesh = jrefine(jpm, jgrid).finalize()
  tmesh = refine_premesh(tpm, tgrid).finalize(device='cpu')
  assert (tmesh.structured is not None) == structured
  rng = np.random.default_rng(1)
  u = rng.standard_normal(tmesh.num_nodes)
  w = rng.standard_normal((tmesh.num_elements, tmesh.num_nodes_per_element))
  np.testing.assert_array_equal(tmesh.gather(torch.as_tensor(u)).numpy(),
                                np.asarray(jmesh.gather(jnp.asarray(u))))
  np.testing.assert_allclose(tmesh.scatter(torch.as_tensor(w)).numpy(),
                             np.asarray(jmesh.scatter(jnp.asarray(w))),
                             rtol=1e-14, atol=1e-14)
  np.testing.assert_allclose(tmesh.exchange(torch.as_tensor(u)).numpy(),
                             np.asarray(jmesh.exchange(jnp.asarray(u))),
                             rtol=1e-14, atol=1e-14)
  np.testing.assert_array_equal(tmesh.element_coords().numpy(),
                                np.asarray(jmesh.element_coords()))


@pytest.mark.parametrize('order', [3, 5])
def test_geometric_factors_and_mass_match(order):
  jsem = JStokesSEM.create(junit_cube_mesh(3, ndim=2, periodic_dims=(0, 1)),
                           {}, order=order)
  sem = StokesSEM.create(unit_cube_mesh(3, ndim=2, periodic_dims=(0, 1)),
                         {}, order=order, device='cpu', dtype=torch.float64)
  for tspace, jspace in ((sem.velocity.vspace, jsem.velocity.vspace),
                         (sem.velocity.overint_space,
                          jsem.velocity.overint_space),
                         (sem.pressure.pspace, jsem.pressure.pspace)):
    for name in ('jacdets', 'invjacs', 'quad_coords'):
      np.testing.assert_allclose(getattr(tspace, name).numpy(),
                                 np.asarray(getattr(jspace, name)),
                                 rtol=1e-12, atol=1e-12, err_msg=name)
  np.testing.assert_allclose(sem.velocity_mass_diag.numpy(),
                             np.asarray(jsem.velocity_mass_diag),
                             rtol=1e-12, atol=1e-15)
  assert isinstance(sem.velocity.vspace, fespace.FiniteElementSpace)
  assert isinstance(jsem.velocity.vspace, jfespace.FiniteElementSpace)


@pytest.mark.parametrize('order', [3, 7])
@pytest.mark.parametrize('n', [2, 3])
def test_periodic_cube_mesh_and_factors_match(n, order):
  """The 3D setup of the Taylor-Green path: tables identical, geometric
  factors to 1e-13 of their largest entry in float64."""
  jpm = junit_cube_mesh(n, ndim=3, periodic_dims=(0, 1, 2))
  tpm = unit_cube_mesh(n, ndim=3, periodic_dims=(0, 1, 2))
  for node_type, npts, quad_points in (
      ('GAUSS_LOBATTO_LEGENDRE', order + 1, (order + 1, order + 3)),
      ('GAUSS_LEGENDRE', order - 1, (order + 1,))):
    jmesh = jrefine(jpm, jquad.Nodes1D.create(
        npts, getattr(jquad.NodeType, node_type))).finalize()
    tmesh = refine_premesh(tpm, quad.Nodes1D.create(
        npts, getattr(quad.NodeType, node_type))).finalize(device='cpu')
    _assert_mesh_equal(tmesh, jmesh)
    for q in quad_points:
      jspace = jfespace.FiniteElementSpace.create(
          jmesh, jquad.Quadrature1D.create(
              num_points=q,
              quadrature_type=jquad.NodeType.GAUSS_LOBATTO_LEGENDRE))
      tspace = fespace.FiniteElementSpace.create(
          tmesh, quad.Quadrature1D.create(
              num_points=q,
              quadrature_type=quad.NodeType.GAUSS_LOBATTO_LEGENDRE))
      for name in ('jacdets', 'invjacs', 'quad_coords'):
        got = getattr(tspace, name).numpy()
        want = np.asarray(getattr(jspace, name))
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max(), name


@pytest.mark.parametrize('entry', ['finalize', 'create', 'multiplicity_el'])
def test_mesh_layer_takes_no_default_device(entry):
  """The mesh layer's entry points name no device of their own: a caller
  who leaves `device` out gets a TypeError, not the CPU."""
  from swirlfem_tpu_torch.core.mesh import Mesh  # pylint: disable=import-outside-toplevel
  from swirlfem_tpu_torch.ops import sem3d  # pylint: disable=import-outside-toplevel
  pm = refine_premesh(unit_cube_mesh(2, ndim=3, periodic_dims=(0, 1, 2)),
                      quad.Nodes1D.create(3, quad.NodeType.GAUSS_LOBATTO_LEGENDRE))
  calls = {
      'finalize': lambda **kw: pm.finalize(**kw),
      'create': lambda **kw: Mesh.create(pm.node_coords, pm.elements,
                                         gridpoints_1d=pm.gridpoints_1d,
                                         **kw),
      'multiplicity_el': lambda **kw: sem3d.multiplicity_el(pm.structured,
                                                            **kw)}
  with pytest.raises(TypeError, match='device'):
    calls[entry]()
  out = calls[entry](device='cpu')
  tensor = out if isinstance(out, torch.Tensor) else out.node_coords
  assert tensor.device.type == 'cpu'

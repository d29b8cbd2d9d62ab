"""The port's element partitioner (`utils.partition`) against the JAX
package's: the same partition arrays, edge cuts and interface-node counts
for the same meshes, exactly (both are numpy; the multilevel recipe's
random choices come from the same seed)."""

import numpy as np
import pytest

from swirlfem_tpu.utils import partition as jpart
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu.utils.cylinder import cylinder_channel_premesh as jcyl
from swirlfem_tpu_torch.utils import partition
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
from swirlfem_tpu_torch.utils.cylinder import cylinder_channel_premesh
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

MESHES = {
    'box8': (lambda: unit_cube_mesh(8, ndim=2),
             lambda: junit_cube_mesh(8, ndim=2)),
    'box6': (lambda: unit_cube_mesh(6, ndim=2),
             lambda: junit_cube_mesh(6, ndim=2)),
    'box12_periodic': (
        lambda: unit_cube_mesh(12, ndim=2, periodic_dims=(0, 1)),
        lambda: junit_cube_mesh(12, ndim=2, periodic_dims=(0, 1))),
    'cube4': (lambda: unit_cube_mesh(4, ndim=3),
              lambda: junit_cube_mesh(4, ndim=3)),
    'cylinder': (cylinder_channel_premesh, jcyl),
}


@pytest.fixture(scope='module')
def meshes():
  return {name: (port(), jax_()) for name, (port, jax_) in MESHES.items()}


@pytest.mark.parametrize('name', sorted(MESHES))
def test_adjacency_matches_jax(meshes, name):
  pm, jpm = meshes[name]
  assert partition.element_adjacency(pm) == jpart.element_adjacency(jpm)


@pytest.mark.parametrize('name,k', [('box8', 4), ('box6', 3),
                                    ('box12_periodic', 4), ('cube4', 4),
                                    ('cylinder', 3), ('cylinder', 8)])
def test_partitions_cuts_and_interfaces_match_jax(meshes, name, k):
  pm, jpm = meshes[name]
  for method in ('multilevel', 'rcb', 'auto'):
    got = partition.partition(pm, k, method=method)
    want = jpart.partition(jpm, k, method=method)
    np.testing.assert_array_equal(got, want, err_msg=method)
    assert got.dtype == want.dtype
    assert partition.edge_cut(pm, got) == jpart.edge_cut(jpm, want)
    assert (partition.interface_nodes(pm, got)
            == jpart.interface_nodes(jpm, want))
  np.testing.assert_array_equal(partition.partition_rcb(pm, k),
                                jpart.partition_rcb(jpm, k))
  np.testing.assert_array_equal(
      partition.partition_multilevel(pm, k, seed=3),
      jpart.partition_multilevel(jpm, k, seed=3))


def test_one_partition_and_bad_arguments():
  pm = unit_cube_mesh(4, ndim=2)
  np.testing.assert_array_equal(partition.partition(pm, 1),
                                np.zeros(16, dtype=np.int32))
  with pytest.raises(ValueError):
    partition.partition(pm, 0)
  with pytest.raises(ValueError):
    partition.partition(pm, 2, method='spectral')

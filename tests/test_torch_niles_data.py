"""The port's DNS -> LES restriction and input pipeline against the JAX
package's.

`coarsen.make_restriction` against the JAX restriction on the same DNS
fields (8x8 order 6 -> 4x4 order 3, float64: 1e-12 relative) and against
the exact fields (spectral accuracy, ``tests/test_niles.py:172``); the
debug split's batches equal to the JAX package's, bitwise (``:244``,
``:251``); a datagen run's frames in memory and as ``.npz`` shards through
`create_split` with the restriction (``:217``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from swirlfem_tpu.niles import coarsen as jcoarsen
from swirlfem_tpu.niles import input_pipeline as jpipeline
from swirlfem_tpu_torch.core.quadrature import Nodes1D, NodeType
from swirlfem_tpu_torch.core.refine import refine_premesh
from swirlfem_tpu_torch.niles import coarsen
from swirlfem_tpu_torch.niles import datagen
from swirlfem_tpu_torch.niles import input_pipeline
from swirlfem_tpu_torch.utils.box import unit_cube_mesh

from torch_niles_configs import jax_tiny_config, torch_tiny_config
import torch_port_threads  # noqa: F401  pylint: disable=unused-import


@dataclasses.dataclass
class _Les:
  ndim: int = 2
  element_grid_size: int = 4
  order: int = 3


def _coords(n, nodes):
  pm = refine_premesh(unit_cube_mesh(n, ndim=2, periodic_dims=(0, 1)), nodes)
  return np.asarray(pm.node_coords, np.float64)


def test_restriction_matches_jax_and_is_spectral():
  dns_grid, dns_order = 8, 6
  restrict = coarsen.make_restriction(dns_grid, dns_order, _Les())
  jrestrict = jcoarsen.make_restriction(dns_grid, dns_order, _Les())
  gll = lambda n: Nodes1D.create(n, NodeType.GAUSS_LOBATTO_LEGENDRE)
  gl = lambda n: Nodes1D.create(n, NodeType.GAUSS_LEGENDRE)
  cu, cp = _coords(dns_grid, gll(dns_order + 1)), _coords(dns_grid,
                                                          gl(dns_order - 1))
  f = lambda c: np.sin(2 * np.pi * c[:, 0]) * np.cos(2 * np.pi * c[:, 1])
  u = np.stack([f(cu), 2 * f(cu)], axis=-1)
  window = {'u': np.stack([u, 0.5 * u]), 'p': np.stack([f(cp), -f(cp)]),
            't': np.arange(2.0)}
  out, want = restrict(window), jrestrict(window)
  assert set(out) == {'u', 'p', 't'}
  for key in ('u', 'p'):
    assert out[key].shape == want[key].shape
    np.testing.assert_allclose(out[key], want[key], rtol=0,
                               atol=1e-12 * np.abs(want[key]).max())
  cl = _coords(4, gll(4))
  exact = np.stack([f(cl), 2 * f(cl)], axis=-1)
  assert np.abs(out['u'][0] - exact).max() < 1e-4
  assert np.abs(out['u'][1] - 0.5 * exact).max() < 1e-4
  assert np.abs(out['p'][0] - f(_coords(4, gl(2)))).max() < 1e-4


@pytest.mark.parametrize('train', [True, False])
def test_debug_split_matches_jax(train):
  cfg, jcfg = torch_tiny_config(), jax_tiny_config()
  it = input_pipeline.create_split(2, train, cfg, prefetch=0)
  jit = jpipeline.create_split(2, train, jcfg, prefetch=0)
  first = None
  for _ in range(3):
    got, want = next(it), next(jit)
    for key in ('u', 'p'):
      np.testing.assert_array_equal(got[key], want[key])
    first = got if first is None else first
  window = cfg.train_window_size if train else cfg.eval_window_size
  assert first['u'].shape == (2, window, cfg.num_nodes, 2)
  assert input_pipeline.get_num_examples(
      '', train, window, 1 if train else 4, debug=True) == (
          jpipeline.get_num_examples('', train, window, 1 if train else 4,
                                     debug=True))


def test_split_rejects_a_batch_it_cannot_fill():
  with pytest.raises(ValueError):
    next(input_pipeline.create_split(10_000, True, torch_tiny_config(),
                                     prefetch=0))


@pytest.fixture(scope='module')
def dns_frames():
  cfg = datagen.DatagenConfig(resolution=8, order=4, time_order=2,
                              reynolds_number=1000.0, num_cycles=1,
                              num_steps_per_cycle=8, dt=1e-3,
                              snapshot_every=1)
  frames = []
  datagen.run_simulation(None, cfg, device='cpu', dtype=torch.float64,
                         frames_out=frames)
  return frames


def test_pipeline_from_datagen_frames(dns_frames, tmp_path):
  """In memory, and as .npz shards under dataset_dir (prefetch thread)."""
  assert len(dns_frames) == 1 and dns_frames[0]['u'].shape[0] == 9
  cfg = torch_tiny_config(debug=False, train_window_size=4,
                          dataset_dir=str(tmp_path))
  restrict = coarsen.make_restriction(8, 4, cfg)
  np.savez(tmp_path / 'train_0.npz', **dns_frames[0])
  n_les_p = cfg.num_elements * (cfg.order - 1) ** 2
  for frames, prefetch in ((dns_frames, 0), (None, 2)):
    batch = next(input_pipeline.create_split(
        2, True, cfg, prefetch=prefetch, restrict_fn=restrict,
        frames=frames))
    assert batch['u'].shape == (2, 4, cfg.num_nodes, 2)
    assert batch['p'].shape == (2, 4, n_les_p)
    assert np.isfinite(batch['u']).all()
  assert input_pipeline.get_num_examples(str(tmp_path), True, 4, 1) == 6

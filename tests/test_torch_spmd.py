"""The port's collective axis and rank launcher (`parallel.spmd`) on gloo
ranks of this host, against numpy.

Ranks start once per rank count (a module fixture); each runs every
collective on inputs seeded from its rank, so the expected values are
computed here.  psum must give bitwise the same total on every rank (CG's
host-side stopping tests read it), ppermute must leave zeros where a rank
receives nothing (as ``lax.ppermute``), all_to_all must split one axis and
concatenate another (as tiled ``lax.all_to_all``).
"""

import numpy as np
import pytest
import torch

from swirlfem_tpu_torch.parallel import spmd
import torch_port_ranks
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

SEED = 7


@pytest.fixture(scope='module', params=[2, 4])
def ranks(request):
  size = request.param
  return size, spmd.launch(torch_port_ranks.collectives,
                           [{'seed': SEED}] * size)


def test_ranks_import_no_jax(ranks):
  _, outs = ranks
  assert all(o['no_jax'] for o in outs)


def test_psum_matches_numpy_and_is_bitwise_equal(ranks):
  size, outs = ranks
  xs = np.stack([o['x'] for o in outs])
  # Added in ascending rank order: numpy's left-to-right sum of the rows.
  total = xs[0]
  for x in xs[1:]:
    total = total + x
  for o in outs:
    np.testing.assert_array_equal(o['psum'], total)
    np.testing.assert_array_equal(o['psum_f32'], outs[0]['psum_f32'])
  np.testing.assert_allclose(outs[0]['psum_f32'], xs.sum(0) / 3.0,
                             rtol=1e-6)
  assert outs[0]['stats']['host_bytes'] == 0  # CPU tensors stay put
  assert size == len(outs)


def test_shared_slots_and_gloo_agree(ranks):
  """Small payloads go through the launch's shared slots (on x86 hosts),
  large ones through gloo: both psums add in ascending rank order, and
  ppermute and all_to_all move the same chunks."""
  size, outs = ranks
  assert all(o['shared'] == spmd.shared_slots_supported() for o in outs)
  for key, src in (('psum_big', 'big'), ('psum_0d', None)):
    vals = [o[src] if src else o['x'][0, 0] for o in outs]
    total = vals[0]
    for v in vals[1:]:
      total = total + v
    for o in outs:
      np.testing.assert_array_equal(o[key], total, err_msg=key)
  assert outs[0]['psum_0d'].shape == ()
  for r, o in enumerate(outs):
    np.testing.assert_array_equal(o['ring_big'], outs[(r - 1) % size]['big'])
    np.testing.assert_array_equal(o['tiled_big'], np.concatenate(
        [p['blocks_big'][2 * r:2 * r + 2] for p in outs], axis=1))


def test_ppermute_ring_and_zeros(ranks):
  size, outs = ranks
  for r, o in enumerate(outs):
    np.testing.assert_array_equal(o['ring'], outs[(r - 1) % size]['x'])
    want = np.zeros_like(o['x']) if r == 0 else outs[r - 1]['x']
    np.testing.assert_array_equal(o['partial'], want)


def test_all_to_all_tiled_and_untiled(ranks):
  size, outs = ranks
  for r, o in enumerate(outs):
    # Chunk r of every rank's split axis, concatenated in rank order.
    chunks = [p['blocks'][2 * r:2 * r + 2] for p in outs]
    np.testing.assert_array_equal(o['tiled'], np.concatenate(
        [c for c in chunks], axis=2))
    np.testing.assert_array_equal(o['tiled_neg'], np.concatenate(
        [np.moveaxis(c, 0, 1) for c in chunks], axis=-1))
    np.testing.assert_array_equal(
        o['untiled'], np.stack([p['rows'][r] for p in outs], axis=1))
    np.testing.assert_array_equal(o['complex'], np.concatenate(
        [p['z'][:, 2 * r:2 * r + 2] for p in outs], axis=0))
  assert outs[0]['stats']['collectives'] == 12


def test_a_failing_rank_fails_the_launch():
  with pytest.raises(RuntimeError, match='failed on purpose'):
    spmd.launch(torch_port_ranks.fail_on_rank, [1, 1, 1], timeout=60)


def test_single_axis_is_the_identity():
  ax = spmd.Axis(size=1, index=0)
  x = torch.arange(6.0).reshape(2, 3)
  assert torch.equal(ax.psum(x), x)
  assert torch.equal(ax.ppermute(x, [(0, 0)]), x)
  assert torch.equal(ax.ppermute(x, []), torch.zeros_like(x))
  assert torch.equal(ax.all_to_all(x, 1, 0), x)

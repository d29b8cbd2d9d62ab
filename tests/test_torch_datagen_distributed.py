"""Distributed datagen (`niles.datagen_distributed`) on 4 gloo ranks against
the JAX package's single-device datagen.

At ``tests/test_datagen_distributed.py:22-26``'s configuration (8^2
elements, order 3, BDF2, Re 1000, 2 cycles of 6 steps, a frame every 2),
in float64: the frames of `run_simulation_distributed` (the ranks' slabs
joined on the host) must match the shards the JAX `run_simulation` writes,
1e-9; the shards this run writes must hold the same frames; and the flow
must have evolved.
"""

import dataclasses
import glob
import os

import h5py
import numpy as np
import pytest
import torch

from swirlfem_tpu.niles import datagen as jdatagen
from swirlfem_tpu_torch.niles import datagen
from swirlfem_tpu_torch.niles import datagen_distributed
import torch_port_ranks
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

CFG = datagen.DatagenConfig(
    resolution=8, order=3, time_order=2, reynolds_number=1000.0,
    num_cycles=2, num_steps_per_cycle=6, dt=1e-3, snapshot_every=2,
    split='train')


def _read(workdir):
  out = {}
  for path in sorted(glob.glob(os.path.join(workdir, 'train_*.h5'))):
    with h5py.File(path, 'r') as f:
      out[os.path.basename(path)] = {k: f[k][:] for k in f}
  return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  jax_dir = str(tmp_path_factory.mktemp('jax'))
  port_dir = str(tmp_path_factory.mktemp('port'))
  frames = []
  port = torch_port_ranks.in_background(
      datagen_distributed.run_simulation_distributed, port_dir, CFG,
      num_ranks=4, device='cpu', dtype=torch.float64, frames_out=frames)
  jdatagen.run_simulation(jax_dir,
                          jdatagen.DatagenConfig(**dataclasses.asdict(CFG)))
  walls, sem, state, stats = port.result()
  return {'jax': _read(jax_dir), 'port': _read(port_dir), 'frames': frames,
          'walls': walls, 'sem': sem, 'state': state, 'stats': stats}


def test_frames_match_jax(runs):
  want = runs['jax']
  assert len(want) == CFG.num_cycles
  for (name, ref), got in zip(sorted(want.items()), runs['frames']):
    for key in ('t', 'u', 'p'):
      np.testing.assert_allclose(got[key], ref[key], atol=1e-9, rtol=0,
                                 err_msg=f'{name}/{key}')
  u = runs['frames'][0]['u']
  assert np.abs(u[-1] - u[0]).max() > 1e-6


def test_written_shards_hold_the_frames(runs):
  got = runs['port']
  assert sorted(got) == sorted(runs['jax'])
  for (_, shard), frames in zip(sorted(got.items()), runs['frames']):
    for key in ('t', 'u', 'p'):
      np.testing.assert_array_equal(shard[key], frames[key])


def test_state_and_counters(runs):
  us, ps, cus = runs['state']
  assert len(us) == len(ps) == len(cus) == CFG.time_order
  k, n = CFG.order + 1, CFG.resolution
  assert us[-1][0].shape == (k, k, n, n)
  # The last frame is the final state.
  u_last = runs['sem'].velocity_from_el(
      tuple(torch.as_tensor(c) for c in us[-1]))
  np.testing.assert_array_equal(
      np.stack([c.numpy() for c in u_last], axis=-1),
      runs['frames'][-1]['u'][-1])
  assert len(runs['walls']) == CFG.num_cycles
  assert runs['stats']['collectives_per_step'] > 0
  assert runs['stats']['host_bytes_per_step'] == 0  # CPU ranks

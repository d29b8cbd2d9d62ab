"""Input pipeline over DNS snapshot frames.

Counterpart of ``swirlfem_tpu/niles/input_pipeline.py``: windows of
(u, p) trajectories are formed by index arithmetic over the frames,
shuffled per epoch, and yielded as numpy batches (a background prefetch
thread by default).  One process reads everything (the JAX package's
per-host slice with one host).

Sources, in order: frames in memory (`frames`: one ``{'u': (F, N, d),
'p': (F, P)}`` dict per trajectory, such as `datagen.run_simulation`'s
``frames_out``), the synthetic debug split (``config.debug``: the JAX
package's arrays from the same numpy seeds), or shards under
``config.dataset_dir``: ``train_*.h5`` / ``valid_*.h5`` (datasets ``u``,
``p``; `h5py` is imported only to read them) or ``train_*.npz`` /
``valid_*.npz`` (arrays ``u``, ``p``).
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator

import numpy as np


def _list_shards(dataset_dir: str, train: bool) -> list[str]:
  prefix = 'train_' if train else 'valid_'
  shards = sorted(glob.glob(os.path.join(dataset_dir, prefix + '*.h5'))
                  + glob.glob(os.path.join(dataset_dir, prefix + '*.npz')))
  if not shards:
    raise FileNotFoundError(
        f'no {prefix}*.h5 / {prefix}*.npz shards under {dataset_dir!r}; run '
        'the datagen or set config.debug=True for a synthetic dataset')
  return shards


def _open(path: str):
  """A shard's ``u`` and ``p`` (lazy HDF5 datasets or npz arrays)."""
  if path.endswith('.npz'):
    data = np.load(path)
    return {'u': data['u'], 'p': data['p']}
  import h5py  # only HDF5 shards need it
  f = h5py.File(path, 'r')
  return {'u': f['u'], 'p': f['p']}


def _windows_per_shard(num_frames: int, window_size: int,
                       window_stride: int) -> int:
  return max(0, (num_frames - window_size) // window_stride + 1)


def get_num_examples(dataset_dir: str, train: bool, window_size: int,
                     window_stride: int, debug: bool = False,
                     frames=None) -> int:
  """Number of windows across all shards (or trajectories) of the split."""
  if frames is not None:
    return sum(_windows_per_shard(len(f['u']), window_size, window_stride)
               for f in frames)
  if debug:
    # Must match _WindowDataset's synthetic split (window_size + 64 frames).
    return _windows_per_shard(window_size + 64, window_size, window_stride)
  return sum(_windows_per_shard(len(_open(path)['u']), window_size,
                                window_stride)
             for path in _list_shards(dataset_dir, train))


def _synthetic_frames(config, num_frames: int, seed: int):
  rng = np.random.default_rng(seed)
  num_nodes = config.num_nodes
  num_pnodes = config.num_elements * (config.order - 1) ** config.ndim
  u = rng.standard_normal((num_frames, num_nodes, config.ndim)) * 1e-2
  p = rng.standard_normal((num_frames, num_pnodes)) * 1e-2
  return u.astype(np.float32), p.astype(np.float32)


class _WindowDataset:
  """Random-access view of (u, p) windows across shards."""

  def __init__(self, config, train: bool, window_size: int,
               window_stride: int, frames=None):
    self.window_size = window_size
    if frames is not None:
      self._sources = list(frames)
    elif config.debug:
      u, p = _synthetic_frames(config, window_size + 64,
                               seed=0 if train else 1)
      self._sources = [{'u': u, 'p': p}]
    else:
      self._sources = [_open(path)
                       for path in _list_shards(config.dataset_dir, train)]
    self._index = []
    for s, src in enumerate(self._sources):
      count = _windows_per_shard(len(src['u']), window_size, window_stride)
      self._index.extend((s, i * window_stride) for i in range(count))

  def __len__(self):
    return len(self._index)

  def get(self, idx: int):
    s, start = self._index[idx]
    src = self._sources[s]
    end = start + self.window_size
    return {'u': np.asarray(src['u'][start:end], np.float32),
            'p': np.asarray(src['p'][start:end], np.float32)}


def create_split(batch_size: int, train: bool, config, prefetch: int = 2,
                 seed: int = 0, restrict_fn=None,
                 frames=None) -> Iterator[dict]:
  """Yields batches ``{'u': (B, W, nodes, ndim), 'p': (B, W, pnodes)}``.

  Iterates forever, reshuffling each epoch for training.  `restrict_fn`
  (e.g. `niles.coarsen.make_restriction`) is applied to each window as it
  is read: the DNS -> LES resolution bridge.  `frames`: trajectories in
  memory (see the module docstring) in place of the config's source.
  """
  window = config.train_window_size if train else config.eval_window_size
  stride = config.train_window_stride if train else config.eval_window_stride
  ds = _WindowDataset(config, train, window, stride, frames)
  if len(ds) < batch_size:
    raise ValueError(
        f'example count {len(ds)} is smaller than batch_size {batch_size}: '
        'the loader would never yield a batch')

  def generate():
    rng = np.random.default_rng(seed)
    while True:
      order = np.arange(len(ds))
      if train:
        order = rng.permutation(len(ds))
      for i in range(0, len(order) - batch_size + 1, batch_size):
        items = [ds.get(int(j)) for j in order[i:i + batch_size]]
        if restrict_fn is not None:
          items = [restrict_fn(it) for it in items]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}

  if prefetch <= 0:
    yield from generate()
    return

  q: queue.Queue = queue.Queue(maxsize=prefetch)

  def worker():
    for batch in generate():
      q.put(batch)

  threading.Thread(target=worker, daemon=True).start()
  while True:
    yield q.get()

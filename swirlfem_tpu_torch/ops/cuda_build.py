"""Builds and loads the port's hand-written Hopper kernels (csrc/*.cu).

The CUDA sources are compiled by ``nvcc`` for ``sm_90a``, one process per
source, all started together, and linked into ONE shared library with a
plain C interface, loaded with `ctypes` (no PyTorch headers, so a build
takes seconds).  The build happens at first use, into
``swirlfem_tpu_torch/_build/<hash>/``, keyed by a hash of the sources and
flags; a later process with the same sources reuses it.  Importing this
module builds nothing and needs no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parents[1]
_CSRC = _PKG / 'csrc'
_BUILD = _PKG / '_build'
_SOURCES = ('exchange2d.cu', 'stiffness_uniform.cu', 'stiffness2d_general.cu',
            'stiffness2d_affine.cu', 'stiffness3d_uniform.cu',
            'stiffness3d_general.cu', 'stiffness3d_dense.cu',
            'stiffness3d_dense_split.cu', 'stiffness3d_pair.cu',
            'stiffness3d_pair_general.cu', 'stiffness3d_pair_affine.cu',
            'stiffness2d_affine_split.cu')
# Headers the sources include; part of the build's hash.
_HEADERS = ('stiffness3d_pair_columns.cuh', 'split_bf16_mma.cuh',
            'stiffness2d_fp32.cuh', 'stiffness3d_dense.cuh', 'tma.cuh')
_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
          '-Xcompiler', '-fPIC')

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_I = ctypes.c_int
_SIGNATURES = {
    # (ws[], outs[], num_fields, k, nb, n0, n1, vec, tx, ty, shuffle, stream)
    'exchange2d_f32': (_PP, _PP, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    'exchange2d_f64': (_PP, _PP, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # (amat layout, us[], outs[], num_c, k2, num_e, panels, rows, splits,
    #  blocks, stream)
    'stiffness_uniform_f32': (_P, _PP, _PP, _I, _I, _I, _I, _I, _I, _I, _P),
    'stiffness_uniform_f64': (_P, _PP, _PP, _I, _I, _I, _I, _I, _I, _I, _P),
    # (dmat, us[], gs[3], outs[], num_c, k, num_e, tile_e, grid, span,
    #  stream)
    'stiffness2d_general_f32': (_P, _PP, _PP, _PP, _I, _I, _I, _I, _I, _I,
                                _P),
    'stiffness2d_general_f64': (_P, _PP, _PP, _PP, _I, _I, _I, _I, _I, _I,
                                _P),
    # (k, f64, tile_e, out[4]: tile_e, threads, shared bytes, blocks per SM)
    'stiffness2d_general_layout': (_I, _I, _I, ctypes.POINTER(_I)),
    # (mstack layout, c_aff, us[], outs[], num_c, k2, num_e, panels, rows,
    #  splits, blocks, stream)
    'stiffness2d_affine_f32': (_P, _P, _PP, _PP, _I, _I, _I, _I, _I, _I, _I,
                               _P),
    'stiffness2d_affine_f64': (_P, _P, _PP, _PP, _I, _I, _I, _I, _I, _I, _I,
                               _P),
    # (table, us[], outs[], num_c, k, num_e, grid, stream)
    'stiffness3d_uniform_f32': (_P, _PP, _PP, _I, _I, _I, _I, _P),
    'stiffness3d_uniform_f64': (_P, _PP, _PP, _I, _I, _I, _I, _P),
    # (k, f64, out[4]: tile_e, threads, shared bytes, blocks per SM)
    'stiffness3d_uniform_layout': (_I, _I, ctypes.POINTER(_I)),
    # (dmat, us[], gs[6], outs[], num_c, k, num_e, grid, stream)
    'stiffness3d_general_f32': (_P, _PP, _PP, _PP, _I, _I, _I, _I, _P),
    'stiffness3d_general_f64': (_P, _PP, _PP, _PP, _I, _I, _I, _I, _P),
    # (k, f64, out[4]: tile_e, threads, shared bytes, blocks per SM)
    'stiffness3d_general_layout': (_I, _I, ctypes.POINTER(_I)),
    # (amat_t, us[], outs[], num_c, k3, num_e, stream)
    'stiffness3d_dense_f32': (_P, _PP, _PP, _I, _I, _I, _P),
    'stiffness3d_dense_f64': (_P, _PP, _PP, _I, _I, _I, _P),
    # (bf16 layout, us[], outs[], num_c, k3, num_e, stream)
    'stiffness3d_dense_split_f32': (_P, _PP, _PP, _I, _I, _I, _P),
    # (a2 split, table, us[], outs[], num_c, k, num_e, grid, stream)
    'stiffness3d_pair_f32': (_P, _P, _PP, _PP, _I, _I, _I, _I, _P),
    # (k, out[4]: tile_e, threads, shared bytes, blocks per SM)
    'stiffness3d_pair_layout': (_I, ctypes.POINTER(_I)),
    # (dp split, dmat, us[], gs[6], outs[], num_c, k, num_e, grid, stream)
    'stiffness3d_pair_general_f32': (_P, _P, _PP, _PP, _PP, _I, _I, _I, _I,
                                     _P),
    'stiffness3d_pairz_general_f32': (_P, _P, _PP, _PP, _PP, _I, _I, _I, _I,
                                      _P),
    # (k, zeta, out[4]: tile_e, threads, shared bytes, blocks per SM)
    'stiffness3d_pair_columns_layout': (_I, _I, ctypes.POINTER(_I)),
    # (k, out[4])
    'stiffness3d_pair_affine_layout': (_I, ctypes.POINTER(_I)),
    # (dp split, T fragments, table, c_affine, us[], outs[], num_c, k, num_e,
    #  grid, stream)
    'stiffness3d_pair_affine_f32': (_P, _P, _P, _P, _PP, _PP, _I, _I, _I, _I,
                                    _P),
    # (bf16 layout, us[], outs[], num_c, rows, num_e, passes, panel, stream)
    'stiffness_uniform_split_f32': (_P, _PP, _PP, _I, _I, _I, _I, _I, _P),
    # (frags, c_aff, us[], outs[], num_c, rows, rows_pad, depth_pad, num_e,
    #  passes, panels, panel_rows, tile, splits, blocks, stream)
    'stiffness2d_affine_split_f32': (_P, _P, _PP, _PP, _I, _I, _I, _I, _I, _I,
                                     _I, _I, _I, _I, _I, _P),
}

# Appended to the launch checks that refuse an order: the plain versions
# take any order when the caller asks for them.
PLAIN_PATH_HINT = ('; use_kernels=False (StokesSEM.create, build_sem2d_ops, '
                   'build_sem3d_ops) runs the plain versions at any order '
                   '(ROADMAP.md, Queue 3 item 6)')

_library: ctypes.CDLL | None = None
build_seconds: float | None = None


def _nvcc() -> str:
  for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
               shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc'):
    if cand and os.path.isfile(cand):
      return cand
  raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); '
                     'the CUDA kernels cannot be built')


def _source_hash() -> str:
  h = hashlib.sha256(' '.join(_FLAGS).encode())
  for name in _SOURCES + _HEADERS:
    h.update(name.encode())
    h.update((_CSRC / name).read_bytes())
  return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
  """Where the shared library for the current sources lives (or will)."""
  return _BUILD / _source_hash() / 'libswirlfem_kernels.so'


def _run_all(cmds) -> None:
  """Runs the commands concurrently; raises with the output of any failure."""
  procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
           for cmd in cmds]
  failed = []
  for cmd, proc in zip(cmds, procs):
    out, _ = proc.communicate()
    if proc.returncode != 0:
      failed.append(f'nvcc failed ({proc.returncode}):\n{" ".join(cmd)}\n'
                    f'{out}')
  if failed:
    raise RuntimeError('\n'.join(failed))


def _compile(so: pathlib.Path) -> None:
  """One nvcc per source, all started together, then one link."""
  so.parent.mkdir(parents=True, exist_ok=True)
  with tempfile.TemporaryDirectory(dir=so.parent) as tmpdir:
    objs = [os.path.join(tmpdir, s.replace('.cu', '.o')) for s in _SOURCES]
    _run_all([[_nvcc(), *_FLAGS, '-c', '-o', obj, str(_CSRC / s)]
              for s, obj in zip(_SOURCES, objs)])
    tmp = os.path.join(tmpdir, so.name)
    _run_all([[_nvcc(), *_FLAGS, '-shared', '-o', tmp, *objs]])
    os.replace(tmp, so)  # atomic: a concurrent build never sees a partial file


def library() -> ctypes.CDLL:
  """The loaded kernel library, built from csrc/ on first use."""
  global _library, build_seconds
  if _library is None:
    start = time.perf_counter()
    so = library_path()
    if not so.exists():
      _compile(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
      fn = getattr(lib, name)
      fn.argtypes = argtypes
      fn.restype = ctypes.c_int
    build_seconds = time.perf_counter() - start
    _library = lib
  return _library


def check(rc: int, what: str) -> None:
  """Raises if a kernel's C entry point returned a CUDA error code."""
  if rc != 0:
    raise RuntimeError(f'{what}: CUDA error {rc} at launch')


# Resident blocks per SM of each persistent kernel instance on each device.
_OCCUPANCY = {}


def blocks_per_sm(fn, args, want, what, device) -> int:
  """Resident blocks per SM of one kernel instance (the C side's occupancy
  query `fn(*args, out)`, which also returns its tile, threads and shared
  memory, held against the host's mirror `want`); cached per kernel and
  device."""
  key = (what,) + tuple(args) + (device.index,)
  if key not in _OCCUPANCY:
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
      check(fn(*args, out), what)
    got = dict(tile_e=out[0], threads=out[1], smem_bytes=out[2])
    if any(want[name] != got[name] for name in got) or out[3] < 1:
      raise RuntimeError(f'{what} {tuple(args)}: the kernel has {got} and '
                         f'{out[3]} blocks per SM, the host expects {want}')
    _OCCUPANCY[key] = out[3]
  return _OCCUPANCY[key]

"""What holds the two congruent bf16x3 3D kernels: variant builds, timed.

The dense operator on ``wgmma`` (``csrc/stiffness3d_dense_split.cu``, with
``csrc/stiffness3d_dense.cuh``) and the pair form on the columns layout
(``csrc/stiffness3d_pair.cu``, with ``csrc/stiffness3d_pair_columns.cuh``).
Copies each kernel's sources once per variant, patches the copy (each
variant removes or changes one cost), builds each with ``nvcc`` under its
own kernel name, and times every variant at 16^3 elements, order 7, C = 3,
on random fields, with CUDA events (``kernel_checks.time_ms``); each
variant's output is held to the plain version and the difference printed
(only the full builds and the candidate changes compute the function).
Builds go to ``swirlfem_tpu_torch/_build/congruent_variants/``.  On a GPU
host, from the root of the checkout:

    python tests/torch_port_congruent_bf16x3_variants.py

Dense variants: ``full``; ``no_operator_copies`` and ``no_field_copies``
(the producer's TMA copies of the operator chunk or of the field boxes
skipped), ``no_copies`` (both skipped); ``no_products`` (the wgmma of
each chunk skipped); ``no_stores`` (the outputs not written);
``one_product`` (one product of the three a step); ``steps1``, ``steps4``
(stages of one 16-deep step, eight of them, or of four steps, two of them,
in place of two steps and four stages; at k = 8 only, where the depth is a
multiple of 64);
``operator_footprint`` (every chunk copies the operator's first chunk, a
footprint the caches hold); ``field_footprint`` (every tile copies the
field boxes of elements 0..); ``stages3`` (three stages in place of
four).  Pair variants:
``full``; ``no_field_loads`` (every unit keeps the field of its block's
first unit); ``field_footprint`` (every unit loads the field of tile 0);
``no_products`` (the mma.sync of each slab skipped); ``no_stores``.
"""

import ctypes
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

from swirlfem_tpu_torch.core.quadrature import differentiation_matrix_1d  # pylint: disable=wrong-import-position
from swirlfem_tpu_torch.core.quadrature import NodeType  # pylint: disable=wrong-import-position
from swirlfem_tpu_torch.core.quadrature import Quadrature1D  # pylint: disable=wrong-import-position
from swirlfem_tpu_torch.ops import cuda_split  # pylint: disable=wrong-import-position
from swirlfem_tpu_torch.ops import cuda_stiffness3d as cs3  # pylint: disable=wrong-import-position
from swirlfem_tpu_torch.ops import kernel_checks  # pylint: disable=wrong-import-position

_CSRC = _ROOT / 'swirlfem_tpu_torch' / 'csrc'
_OUT = _ROOT / 'swirlfem_tpu_torch' / '_build' / 'congruent_variants'
_DENSE = 'stiffness3d_dense_split.cu'
_DENSE_H = 'stiffness3d_dense.cuh'
_PAIR = 'stiffness3d_pair.cu'
_PAIR_H = 'stiffness3d_pair_columns.cuh'

# Per kernel: (main source, the kernel's name, its sources) and, per
# variant, (file, text in it, its replacement).
KERNELS = {
    'dense': (_DENSE, 'stiffness3d_dense_split_kernel',
              (_DENSE, _DENSE_H, 'split_bf16_mma.cuh')),
    'pair': (_PAIR, 'pair_congruent_kernel',
             (_PAIR, _PAIR_H, 'split_bf16_mma.cuh')),
}
VARIANTS = {
    'dense': {
        'full': [],
        'no_operator_copies': [
            (_DENSE, 'kOpBytes + (vec ? segs * kSegBytes : 0)',
             '(vec ? segs * kSegBytes : 0)'),
            (_DENSE, '      bulk_copy(stage,\n', '      if (false) bulk_copy(stage,\n')],
        'no_field_copies': [
            (_DENSE, 'kOpBytes + (vec ? segs * kSegBytes : 0)', 'kOpBytes'),
            (_DENSE, '    if (vec && 1 <= lane && lane <= segs) {',
             '    if (false) {')],
        'no_products': [
            (_DENSE, '        wgmma_bf16_n256(acc[0], acc[1], alo[B][kk], dhi, sc);\n'
             '        wgmma_bf16_n256(acc[0], acc[1], ahi[B][kk], dlo, 1);\n'
             '        wgmma_bf16_n256(acc[0], acc[1], ahi[B][kk], dhi, 1);\n', ''),
            (_DENSE, '        wgmma_bf16(acc[0], alo[B][kk], dhi, sc);\n'
             '        wgmma_bf16(acc[0], ahi[B][kk], dlo, 1);\n'
             '        wgmma_bf16(acc[0], ahi[B][kk], dhi, 1);\n', '')],
        'steps1': [
            (_DENSE, 'constexpr int kSteps = 2;', 'constexpr int kSteps = 1;'),
            (_DENSE, 'constexpr int kStages = 4;', 'constexpr int kStages = 8;')],
        'steps4': [
            (_DENSE, 'constexpr int kSteps = 2;', 'constexpr int kSteps = 4;'),
            (_DENSE, 'constexpr int kStages = 4;', 'constexpr int kStages = 2;')],
        'no_copies': [
            (_DENSE, 'kOpBytes + (vec ? segs * kSegBytes : 0)', '0'),
            (_DENSE, '      bulk_copy(stage,\n', '      if (false) bulk_copy(stage,\n'),
            (_DENSE, '    if (vec && 1 <= lane && lane <= segs) {',
             '    if (false) {')],
        'no_stores': [
            (_DENSE, '            if (row < s.k3 && col < s.num_e) {',
             '            if (row < 0) {')],
        'one_product': [
            (_DENSE, '        wgmma_bf16_n256(acc[0], acc[1], ahi[B][kk], dlo, 1);\n'
             '        wgmma_bf16_n256(acc[0], acc[1], ahi[B][kk], dhi, 1);\n', ''),
            (_DENSE, '        wgmma_bf16(acc[0], ahi[B][kk], dlo, 1);\n'
             '        wgmma_bf16(acc[0], ahi[B][kk], dhi, 1);\n', '')],
        'operator_footprint': [
            (_DENSE, 'op + (static_cast<long long>(w.p) * s.chunks + w.chunk) *'
             '\n                         kOpBytes,', 'op,')],
        'field_footprint': [
            (_DENSE, 'e0 + (lane - 1) * kSeg, k0, full + slot);',
             '(lane - 1) * kSeg, k0, full + slot);')],
        'stages3': [
            (_DENSE, 'constexpr int kStages = 4;', 'constexpr int kStages = 3;')],
    },
    'pair': {
        'full': [],
        'no_field_loads': [
            (_PAIR_H, '    if (next_tile < num_tiles) load_field(next_tile, '
             'next_comp);\n\n    // mm3(A2, U)',
             '\n    // mm3(A2, U)')],
        'field_footprint': [
            (_PAIR_H, '    if (next_tile < num_tiles) load_field(next_tile, '
             'next_comp);\n\n    // mm3(A2, U)',
             '    if (next_tile < num_tiles) load_field(0, next_comp);\n\n'
             '    // mm3(A2, U)')],
        'no_products': [
            (_PAIR_H, '        mma(acc[a], ah, b[0], b[1]);\n'
             '        mma(acc[a], ah, b[2], b[3]);\n'
             '        mma(acc[a], al, b[0], b[1]);\n', '')],
        'no_stores': [
            (_PAIR_H, '        store2(out + roff[r] + a * slab_step + e, e, '
             'num_e, vec,\n               fmaf(wa, acc[a][2 * r], '
             'ch[a][r][0]),\n               fmaf(wa, acc[a][2 * r + 1], '
             'ch[a][r][1]));\n', '')],
    },
}


def _nvcc() -> str:
  for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
               shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc'):
    if cand and os.path.isfile(cand):
      return cand
  raise RuntimeError('nvcc not found')


def build_all():
  """One shared library per (kernel, variant), all compiled together."""
  procs = {}
  for kernel, (main, symbol, files) in KERNELS.items():
    for name, patches in VARIANTS[kernel].items():
      src = _OUT / kernel / name
      shutil.rmtree(src, ignore_errors=True)
      src.mkdir(parents=True)
      texts = {f: (_CSRC / f).read_text() for f in files}
      for f, old, new in patches:
        if texts[f].count(old) != 1:
          raise RuntimeError(f'{kernel} {name}: the patch anchor {old!r} is '
                             'not unique')
        texts[f] = texts[f].replace(old, new)
      for f, text in texts.items():
        (src / f).write_text(text)
      # A kernel name per variant: two libraries with the same kernel
      # symbols in one process fail at launch.
      procs[kernel, name] = subprocess.Popen(
          [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
           '-O3', '-Xcompiler', '-fPIC', '-shared', '-cudart', 'shared',
           '-Xptxas', '-v', f'-D{symbol}={kernel}_{name}', '-o',
           str(src / 'lib.so'), str(src / main)],
          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  for (kernel, name), proc in procs.items():
    out, _ = proc.communicate()
    if proc.returncode:
      raise RuntimeError(f'{kernel} {name}: nvcc failed\n{out}')
    lines = out.splitlines()
    for i, line in enumerate(lines):
      if 'Compiling' in line and (kernel == 'dense' or 'ILi8E' in line):
        print(f'{kernel} {name}: ' + ' '.join(
            x.strip() for x in lines[i + 2:i + 4]))


def main() -> int:
  if not torch.cuda.is_available():
    print('needs a CUDA device')
    return 1
  dev = torch.device('cuda', 0)
  print(torch.cuda.get_device_name(0), subprocess.run(
      ['nvidia-smi', '--query-gpu=power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=False).stdout.strip())
  build_all()
  order, num_e, num_c = 7, 16 ** 3, 3
  k = order + 1
  quad = Quadrature1D.create(k, NodeType.GAUSS_LOBATTO_LEGENDRE)
  w1, dmat = quad.weights, differentiation_matrix_1d(quad.nodes)
  c = (1.3, 0.8, 0.5)
  a64 = cs3.uniform_amat3d_np(c, w1, dmat)
  bf16 = lambda x: torch.as_tensor(x, device=dev).to(torch.bfloat16)
  split = bf16(cuda_split.split_operator_np(a64))
  layout = bf16(cuda_split.dense_bf16_layout_np(a64))
  a2, table = cuda_split.pair_uniform_split_np(c, w1, dmat)
  a2 = bf16(a2)
  table = torch.as_tensor(table, dtype=torch.float32, device=dev)
  rng = np.random.default_rng(0)
  us = tuple(torch.as_tensor(rng.standard_normal((k, k, k, num_e)),
                             dtype=torch.float32, device=dev)
             for _ in range(num_c))
  plains = {
      'dense': cuda_split.stiffness_uniform_split_plain(us, split[0],
                                                        split[1], 3),
      'pair': cs3.stiffness3d_pair_plain(us, a2, table)}
  grid = cs3.pair_columns_grid(
      num_e, k, torch.cuda.get_device_properties(dev).multi_processor_count,
      1)
  pv = ctypes.c_void_p
  ptrs = lambda ts: (pv * len(ts))(*(t.data_ptr() for t in ts))
  stream = torch.cuda.current_stream(dev).cuda_stream
  outs = tuple(torch.empty_like(u) for u in us)
  for kernel in KERNELS:
    for name in VARIANTS[kernel]:
      lib = ctypes.CDLL(str(_OUT / kernel / name / 'lib.so'))
      if kernel == 'dense':
        fn = lib.stiffness3d_dense_split_f32
        fn.argtypes = (pv, ctypes.POINTER(pv), ctypes.POINTER(pv),
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, pv)
        args = (layout.data_ptr(), ptrs(us), ptrs(outs), num_c, k ** 3,
                num_e, stream)
      else:
        fn = lib.stiffness3d_pair_f32
        fn.argtypes = (pv, pv, ctypes.POINTER(pv), ctypes.POINTER(pv),
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, pv)
        args = (a2.data_ptr(), table.data_ptr(), ptrs(us), ptrs(outs),
                num_c, k, num_e, grid, stream)
      fn.restype = ctypes.c_int
      for o in outs:
        o.zero_()
      if fn(*args) != 0:
        raise RuntimeError(f'{kernel} {name}: launch failed')
      torch.cuda.synchronize(dev)
      plain = plains[kernel]
      scale = max(float(p.abs().max()) for p in plain)
      err = max(float((a - b).abs().max())
                for a, b in zip(outs, plain)) / scale
      us_time = kernel_checks.time_ms(lambda: fn(*args), device=dev) * 1e3
      print(f'{kernel:5s} {name:20s}: {us_time:8.2f} us, vs plain {err:.2e}',
            flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())

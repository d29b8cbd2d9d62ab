"""What holds the congruent 2D split kernel and the congruent FP32 3D kernel:
variant builds, timed.

The 2D congruent stiffness in the split-bf16 classes on the dense split
kernel (``csrc/stiffness3d_dense_split.cu`` at a 2D panel, with
``csrc/stiffness3d_dense.cuh`` and ``csrc/tma.cuh``) and the congruent FP32
3D stiffness (``csrc/stiffness3d_uniform.cu``).  Copies each kernel's
sources once per variant, patches the copy (each variant removes one
cost), builds each with ``nvcc`` under its own kernel name, and times every
variant with CUDA events (``kernel_checks.time_ms``) on random fields:
the 2D kernel at the uniform lid-driven shape (16^2 elements, order 7,
C = 2) and the datagen shape (64^2 elements, order 8, C = 2), at 'bf16x3'
and 'default'; the 3D kernel at 16^3 elements, order 7, C = 3, float32.
Each variant's output is held to the plain version and the difference
printed (only the full builds and the earlier designs compute the
function).  With ``--parent DIR`` (an unpacked checkout of an earlier
tree), that tree's ``stiffness_split.cu`` (the 2D operator's earlier
``mma.sync`` kernel) and ``stiffness3d_uniform.cu`` are built and timed in
the same process.  Builds go to
``swirlfem_tpu_torch/_build/split2d_uniform3d_variants/``.  On a GPU host,
from the root of the checkout:

    python tests/torch_port_split2d_uniform3d_variants.py [--parent DIR]

2D variants: ``full`` (also with a half and a quarter of the panel: two or
four panels, as many times the blocks); ``no_copies`` (the producer's TMA
copies of the operator chunk and the field boxes skipped),
``no_operator_copies`` and ``no_field_copies`` (one of them skipped);
``no_products`` (the wgmma of each chunk skipped); ``no_stores`` (the
outputs not written); ``loads_only``, ``stores_only`` and
``prologue_only`` (the other costs skipped); ``empty`` (every block
returns at once: the launch alone); ``direct_stores`` (each thread stores
its accumulators straight to device memory, as the 3D tiles do, in place
of the staged rows); ``single`` (one fragment buffer, each chunk waiting
for its own products: half the code); ``cs_stores`` (evict-first stores);
``stages2`` (a ring of two stages); ``no_clock`` and
``prologue_no_clock`` (the mbarrier waits without their clock reads and
trap); ``no_init_fence``; ``two_chains`` ('bf16x3' only: the correction
products in a second accumulator, added at the end); ``trace`` (block 0
prints the SM clock at its milestones; one launch, untimed).  The full
builds print ptxas's registers and spills.  Beside each time between
CUDA events, the kernel's own duration from ``torch.profiler``.  3D
variants: ``full``; ``no_field_copies`` (the producer's TMA boxes
skipped); ``no_products`` (the FFMA stages skipped: stage A, and stage
B's contraction); ``no_stores`` (the outputs not written).
"""

import argparse
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
from swirlfem_tpu_torch.ops import cuda_stiffness  # pylint: disable=wrong-import-position
from swirlfem_tpu_torch.ops import cuda_stiffness3d as cs3  # pylint: disable=wrong-import-position
from swirlfem_tpu_torch.ops import kernel_checks  # pylint: disable=wrong-import-position

_CSRC = pathlib.Path('swirlfem_tpu_torch') / 'csrc'
_OUT = _ROOT / 'swirlfem_tpu_torch' / '_build' / 'split2d_uniform3d_variants'
_DENSE = 'stiffness3d_dense_split.cu'
_UNI = 'stiffness3d_uniform.cu'

# Per kernel: (main source, the kernel's name, its sources, whether the
# sources come from the parent tree) and, per variant, (file, text in it,
# its replacement).
KERNELS = {
    'split2d': (_DENSE, 'stiffness3d_dense_split_kernel',
                (_DENSE, 'stiffness3d_dense.cuh', 'split_bf16_mma.cuh',
                 'tma.cuh'), False),
    'split2d_parent': ('stiffness_split.cu', 'stiffness_split_kernel',
                       ('stiffness_split.cu', 'split_bf16_mma.cuh'), True),
    'uniform3d': (_UNI, 'stiffness3d_uniform_kernel', (_UNI, 'tma.cuh'),
                  False),
    'uniform3d_parent': (_UNI, 'stiffness3d_uniform_kernel', (_UNI,), True),
}
_NO_COPIES_2D = [
    (_DENSE, 'Cfg::kOpBytes + (vec ? segs * kSegBytes : 0));', '0);'),
    (_DENSE, '      tma::bulk_copy(stage,', '      if (false) tma::bulk_copy(stage,'),
    (_DENSE, '    if (vec && 1 <= lane && lane <= segs) {', '    if (false) {')]
_NO_PRODUCTS_2D = [
    (_DENSE, '        Wgmma<kPanel>::mma(acc[0], alo[B][kk], dhi, sc);\n'
     '        Wgmma<kPanel>::mma(acc[0], ahi[B][kk], dlo, 1);\n'
     '        Wgmma<kPanel>::mma(acc[0], ahi[B][kk], dhi, 1);\n', ''),
    (_DENSE, '        Wgmma<kPanel>::mma(acc[0], ahi[B][kk], dhi, sc);\n', '')]
_NO_STORES_2D = (
    _DENSE,
    '        for (int idx = threadIdx.x; idx < rows * (kUnitE / 4); idx += 128) {',
    '        for (int idx = threadIdx.x; idx < rows * (kUnitE / 4) && s.num_e < 0;'
    ' idx += 128) {')
# The mbarrier waits without their clock reads (and without the trap that
# bounds them).
_NO_CLOCK = [
    ('tma.cuh', '  const long long start = clock64();\n', ''),
    ('tma.cuh', '    if (clock64() - start > (1LL << 32)) __trap();\n', '')]
# Thread 0 keeps the SM clock at the kernel's milestones in shared memory
# (setup done; each of the first three chunks' data in; the products done;
# the last chunk's stores issued), and block 0 prints them at its end (one
# launch, untimed).
_MARK = 'if (threadIdx.x == 0) trace_t[{}] = clock64() - t_start;\n'
_TRACE = [
    (_DENSE, '#include <type_traits>\n', '#include <cstdio>\n#include <type_traits>\n'),
    (_DENSE, '  constexpr int kPanel = Cfg::kPanel;\n',
     '  constexpr int kPanel = Cfg::kPanel;\n  const long long t_start = clock64();\n'
     '  __shared__ long long trace_t[8];\n'),
    (_DENSE, '  Walk comp = dense3d::first_tile<Cfg::kGroups>(s, total_units);\n',
     '  Walk comp = dense3d::first_tile<Cfg::kGroups>(s, total_units);\n'
     + _MARK.format(0)),
    (_DENSE, '    tma::mbar_wait(full + slot, (i / Cfg::kStages) & 1);\n',
     '    tma::mbar_wait(full + slot, (i / Cfg::kStages) & 1);\n'
     'if (i < 3) ' + _MARK.format('1 + i')),
    (_DENSE, '      dense3d::wgmma_wait<0>();\n#pragma unroll\n',
     '      dense3d::wgmma_wait<0>();\n' + _MARK.format(4) + '#pragma unroll\n'),
    (_DENSE, '    dense3d::advance<Cfg::kGroups>(comp, s);\n    ++i;\n',
     _MARK.format(5) + '    dense3d::advance<Cfg::kGroups>(comp, s);\n    ++i;\n'),
    (_DENSE, '    chunk(std::integral_constant<int, 1>());\n  }\n  dense3d::wgmma_wait<0>();\n',
     '    chunk(std::integral_constant<int, 1>());\n  }\n  dense3d::wgmma_wait<0>();\n'
     '  if (threadIdx.x == 0 && blockIdx.x == 0) printf("setup %lld full %lld '
     '%lld %lld products %lld stored %lld end %lld\\n", trace_t[0], '
     'trace_t[1], trace_t[2], trace_t[3], trace_t[4], trace_t[5], '
     'clock64() - t_start);\n'),
]
VARIANTS = {
    'split2d': {
        'full': [],
        'empty': [
            (_DENSE, '  constexpr int kPanel = Cfg::kPanel;\n',
             '  constexpr int kPanel = Cfg::kPanel;\n'
             '  if (total_units > 0) return;\n')],
        'direct_stores': [
            (_DENSE, '  static constexpr bool kStaged = kGroups == 1;',
             '  static constexpr bool kStaged = false;')],
        'single': [
            (_DENSE, '    dense3d::wgmma_wait<1>();  // the products of the chunk before',
             '    dense3d::wgmma_wait<0>();'),
            (_DENSE, '    if (!comp.valid) break;\n'
             '    chunk(std::integral_constant<int, 1>());\n', '')],
        'cs_stores': [
            (_DENSE, '  asm volatile("st.global.f32 [%0], %1;\\n" ::"l"(p), "f"(v) : "memory");',
             '  asm volatile("st.global.cs.f32 [%0], %1;\\n" ::"l"(p), "f"(v) : "memory");')],
        'stages2': [
            (_DENSE, 'using Config2D = Config<kPanel, kPasses, 1, 3>;',
             'using Config2D = Config<kPanel, kPasses, 1, 2>;')],
        'no_copies': _NO_COPIES_2D,
        'no_products': _NO_PRODUCTS_2D,
        'no_stores': [_NO_STORES_2D],
        'loads_only': _NO_PRODUCTS_2D + [_NO_STORES_2D],
        'stores_only': _NO_COPIES_2D + _NO_PRODUCTS_2D,
        'prologue_only': _NO_COPIES_2D + _NO_PRODUCTS_2D + [_NO_STORES_2D],
        'no_clock': _NO_CLOCK,
        'prologue_no_clock': (_NO_COPIES_2D + _NO_PRODUCTS_2D
                              + [_NO_STORES_2D] + _NO_CLOCK),
        'no_init_fence': [
            (_DENSE, '    tma::fence_mbar_init();\n', '')],
        'trace': _TRACE,
        'no_operator_copies': [
            (_DENSE, 'Cfg::kOpBytes + (vec ? segs * kSegBytes : 0));',
             '(vec ? segs * kSegBytes : 0));'),
            (_DENSE, '      tma::bulk_copy(stage,', '      if (false) tma::bulk_copy(stage,')],
        'no_field_copies': [
            (_DENSE, 'Cfg::kOpBytes + (vec ? segs * kSegBytes : 0));',
             'Cfg::kOpBytes);'),
            (_DENSE, '    if (vec && 1 <= lane && lane <= segs) {', '    if (false) {')],
        'two_chains': [
            (_DENSE, '  float acc[Cfg::kAccs][Cfg::kAccRegs];\n',
             '  float acc[Cfg::kAccs][Cfg::kAccRegs];\n  float acc2[Cfg::kAccRegs];\n'),
            (_DENSE, '        Wgmma<kPanel>::mma(acc[0], alo[B][kk], dhi, sc);\n'
             '        Wgmma<kPanel>::mma(acc[0], ahi[B][kk], dlo, 1);\n'
             '        Wgmma<kPanel>::mma(acc[0], ahi[B][kk], dhi, 1);\n',
             '        Wgmma<kPanel>::mma(acc2, alo[B][kk], dhi, sc);\n'
             '        Wgmma<kPanel>::mma(acc[0], ahi[B][kk], dhi, sc);\n'
             '        Wgmma<kPanel>::mma(acc2, ahi[B][kk], dlo, 1);\n'),
            (_DENSE, '                      acc[0][4 * n + q]);\n',
             '                      acc[0][4 * n + q], acc2[4 * n + q]);\n'),
            (_DENSE, '__device__ __forceinline__ void st_shared(float* p, float v) {\n'
             '  asm volatile("st.shared.f32 [%0], %1;\\n" ::"r"(smem_addr(p)), "f"(v)\n'
             '               : "memory");\n}\n',
             '__device__ __forceinline__ void st_shared(float* p, float v, float w) {\n'
             '  asm volatile("{\\n.reg .f32 s;\\nadd.f32 s, %1, %2;\\n'
             'st.shared.f32 [%0], s;\\n}\\n" ::"r"(smem_addr(p)), "f"(v), "f"(w)\n'
             '               : "memory");\n}\n')],
    },
    'split2d_parent': {
        'parent': [],
        'parent_empty': [
            ('stiffness_split.cu', '  const int m0 = blockIdx.y * Cfg::BM;\n',
             '  if (num_e > 0) return;\n'
             '  const int m0 = blockIdx.y * Cfg::BM;\n')]},
    'uniform3d': {
        'full': [],
        'no_field_copies': [
            (_UNI, '      if (lane == 0) tma::mbar_expect(full + slot, '
             'P::kStageBytes);', '      if (lane == 0) tma::mbar_arrive('
             'full + slot);'),
            (_UNI, '      if (lane < P::kBoxes) {', '      if (false) {')],
        'no_products': [
            (_UNI, '    if (slot < K) {', '    if (false) {'),
            (_UNI, '        axpy_row<T, K>(ats + cc * kLd, u_s[l0 + cc * TE], '
             'acc);\n', '')],
        'no_stores': [
            (_UNI, '      if (e < num_e) {', '      if (e < num_e && num_e < 0) {')],
    },
    'uniform3d_parent': {'parent': []},
}


def _nvcc() -> str:
  for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
               shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc'):
    if cand and os.path.isfile(cand):
      return cand
  raise RuntimeError('nvcc not found')


def build_all(parent):
  """One shared library per (kernel, variant), all compiled together;
  returns the (kernel, variant) pairs built."""
  procs = {}
  for kernel, (main, symbol, files, from_parent) in KERNELS.items():
    if from_parent and parent is None:
      continue
    root = parent if from_parent else _ROOT
    for name, patches in VARIANTS[kernel].items():
      src = _OUT / kernel / name
      shutil.rmtree(src, ignore_errors=True)
      src.mkdir(parents=True)
      texts = {f: (root / _CSRC / f).read_text() for f in files}
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
           str(src / 'lib.so'),
           str(src / main)],
          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  for (kernel, name), proc in procs.items():
    out, _ = proc.communicate()
    if proc.returncode:
      raise RuntimeError(f'{kernel} {name}: nvcc failed\n{out}')
    if name == 'full':
      lines = out.splitlines()
      for i, line in enumerate(lines):
        if 'Compiling entry function' in line:
          print(f'{kernel}: {line.split("for")[0].split("function")[-1]}'
                + ' '.join(x.strip() for x in lines[i + 1:i + 4]
                           if 'registers' in x or 'spill' in x))
  return list(procs)


def _gll(order):
  quad = Quadrature1D.create(order + 1, NodeType.GAUSS_LOBATTO_LEGENDRE)
  return quad.weights, differentiation_matrix_1d(quad.nodes)


def main() -> int:
  parser = argparse.ArgumentParser()
  parser.add_argument('--parent', type=pathlib.Path, default=None,
                      help='an unpacked checkout of an earlier tree')
  args = parser.parse_args()
  if not torch.cuda.is_available():
    print('needs a CUDA device')
    return 1
  dev = torch.device('cuda', 0)
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=False).stdout.strip())
  built = build_all(args.parent)
  pv, ci = ctypes.c_void_p, ctypes.c_int
  ptrs = lambda ts: (pv * len(ts))(*(t.data_ptr() for t in ts))
  stream = torch.cuda.current_stream(dev).cuda_stream
  rng = np.random.default_rng(0)
  sms = torch.cuda.get_device_properties(dev).multi_processor_count

  def kernel_us(call, symbol):
    """The mean duration of the kernel `symbol` over 20 calls, from the
    profiler's device trace (None where it records no such kernel)."""
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
      for _ in range(20):
        call()
      torch.cuda.synchronize(dev)
    times = [e.device_time for e in prof.events() if symbol in e.name]
    return sum(times) / len(times) if times else None

  def run(label, fn, argtypes, args_, outs, plain, symbol):
    fn.argtypes = argtypes
    fn.restype = ci
    for o in outs:
      o.zero_()
    if fn(*args_) != 0:
      raise RuntimeError(f'{label}: launch failed')
    torch.cuda.synchronize(dev)
    if symbol.endswith('_trace'):
      print(f'{label}: traced above', flush=True)
      return
    scale = max(float(p.abs().max()) for p in plain)
    err = max(float((a - b).abs().max()) for a, b in zip(outs, plain)) / scale
    us_time = kernel_checks.time_ms(lambda: fn(*args_), device=dev) * 1e3
    own = kernel_us(lambda: fn(*args_), symbol)
    own = 'n/a' if own is None else f'{own:6.2f} us'
    print(f'{label:48s}: {us_time:8.2f} us (kernel {own}), vs plain '
          f'{err:.2e}', flush=True)

  # The 2D operator at both shapes and both classes.
  for order, num_e in ((7, 256), (8, 4096)):
    w1, dmat = _gll(order)
    k2 = (order + 1) ** 2
    a64 = cuda_stiffness.uniform_amat_np((1.0, 0.0, 1.0), np.outer(w1, w1),
                                         dmat)
    split = torch.as_tensor(cuda_split.split_operator_np(a64),
                            device=dev).to(torch.bfloat16)
    us = tuple(torch.as_tensor(rng.standard_normal((k2, num_e)),
                               dtype=torch.float32, device=dev)
               for _ in range(2))
    outs = tuple(torch.empty_like(u) for u in us)
    for precision, passes in cuda_split.PASSES.items():
      plain = cuda_split.stiffness_uniform_split_plain(us, split[0],
                                                       split[1], passes)
      panel = cuda_split.uniform_split_panel(k2)
      for kernel, name in built:
        lib_path = str(_OUT / kernel / name / 'lib.so')
        label = f'{kernel} {name} order {order} E {num_e} {precision}'
        symbol = f'{kernel}_{name}'
        if kernel == 'split2d':
          for pnl in ((panel, panel // 2, panel // 4) if name == 'full'
                      else (panel,)):
            if pnl % 16:
              pnl += 8
            layout = cuda_split.dense_bf16_layout(split[0], split[1], k2, pnl,
                                                  2 if passes == 3 else 1)
            run(f'{label} P {pnl}',
                ctypes.CDLL(lib_path).stiffness_uniform_split_f32,
                (pv, ctypes.POINTER(pv), ctypes.POINTER(pv), ci, ci, ci, ci,
                 ci, pv),
                (layout.data_ptr(), ptrs(us), ptrs(outs), 2, k2, num_e,
                 passes, pnl, stream), outs, plain, symbol)
        elif kernel == 'split2d_parent':
          run(label, ctypes.CDLL(lib_path).stiffness_uniform_split_f32,
              (pv, pv, ctypes.POINTER(pv), ctypes.POINTER(pv), ci, ci, ci,
               ci, ci, ci, pv),
              (split[0].data_ptr(), split[1].data_ptr(), ptrs(us), ptrs(outs),
               2, k2, split.shape[1], split.shape[2], num_e, passes, stream),
              outs, plain, symbol)

  # The congruent FP32 3D kernel at the TGV shape.
  order, num_e, num_c = 7, 16 ** 3, 3
  k = order + 1
  w1, dmat = _gll(order)
  table = torch.as_tensor(cs3.uniform_table_np((1.3, 0.8, 0.5), w1, dmat),
                          dtype=torch.float32, device=dev)
  us = tuple(torch.as_tensor(rng.standard_normal((k, k, k, num_e)),
                             dtype=torch.float32, device=dev)
             for _ in range(num_c))
  outs = tuple(torch.empty_like(u) for u in us)
  plain = cs3.stiffness3d_uniform_plain(us, table)
  grid = cs3.uniform3d_grid(num_e, k, num_c, sms, 1)
  for kernel, name in built:
    if not kernel.startswith('uniform3d'):
      continue
    fn = ctypes.CDLL(str(_OUT / kernel / name / 'lib.so')).stiffness3d_uniform_f32
    head = (pv, ctypes.POINTER(pv), ctypes.POINTER(pv), ci, ci, ci)
    label = f'{kernel} {name} order {order} E {num_e} C {num_c}'
    symbol = f'{kernel}_{name}'
    if kernel == 'uniform3d':
      run(label, fn, head + (ci, pv), (table.data_ptr(), ptrs(us), ptrs(outs),
                                       num_c, k, num_e, grid, stream),
          outs, plain, symbol)
    else:
      run(label, fn, head + (pv,), (table.data_ptr(), ptrs(us), ptrs(outs),
                                    num_c, k, num_e, stream), outs, plain,
          symbol)
  return 0


if __name__ == '__main__':
  sys.exit(main())

"""What holds the periodic exchange and the general 2D stiffness: variant
builds, timed.

The exchange (``csrc/exchange2d.cu``, row 1) and the general 2D stiffness
(``csrc/stiffness2d_general.cu``, rows 3 and 5).  Copies each kernel's
source once per variant, patches the copy (each variant removes one cost),
builds each with ``nvcc`` under its own kernel name, and times every variant
with CUDA events (``kernel_checks.time_ms``) beside the kernel's own
duration from ``torch.profiler``, on random fields: the exchange at the
datagen shape (9, 9, 64, 64) float32, one field, two fields in one launch
and two one-field launches (the full build also with blocks of 128 and
512 threads); the general kernel at the heated cavity's
shape (k = 8, E = 144, C = 2), the datagen shape (k = 9, E = 4096) at C = 2
(row 3) and C = 1 (row 5), on the host's plan and, for the full build, on
the other tile, grids and walks (one unit or whole tiles a run).  Each
variant's output is held to the plain version and the difference printed
(only the full builds and the parent's compute the function).  With
``--parent DIR`` (an unpacked checkout of an earlier tree), that tree's
``exchange2d.cu`` and ``stiffness2d_general.cu`` are built and timed in
the same process.  Builds go to
``swirlfem_tpu_torch/_build/exchange_general2d_variants/``.  On a GPU host,
from the root of the checkout:

    python tests/torch_port_exchange_general2d_variants.py [--parent DIR]

Variants of both: ``full``; ``empty`` (every block returns at once: the
launch alone); ``no_loads`` (the exchange: every load replaced by a value
made from its address) or ``no_copies`` (the general kernel: the cp.async
staging skipped); ``no_products`` (the exchange: every plane a straight
copy; the general kernel: stages 1 and 2 and stage 3's contraction
skipped); ``no_stores`` (the outputs computed but not written).  The
general kernel also ``d_shared`` (D read from shared tables of D and D^T
as 16-byte broadcasts, as float64 does, in place of each thread's
registers: fewer registers, two blocks an SM).
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

from swirlfem_tpu_torch.ops import cuda_exchange  # pylint: disable=wrong-import-position
from swirlfem_tpu_torch.ops import cuda_stiffness2d as cs2  # pylint: disable=wrong-import-position
from swirlfem_tpu_torch.ops import kernel_checks  # pylint: disable=wrong-import-position

_CSRC = pathlib.Path('swirlfem_tpu_torch') / 'csrc'
_OUT = _ROOT / 'swirlfem_tpu_torch' / '_build' / 'exchange_general2d_variants'
_EX = 'exchange2d.cu'
_GEN = 'stiffness2d_general.cu'

# Per kernel: (source, the kernel's name, whether the source comes from the
# parent tree) and, per variant, (text in the source, its replacement).
KERNELS = {
    'exchange': (_EX, 'exchange2d_kernel', False),
    'exchange_parent': (_EX, 'exchange2d_kernel', True),
    'general': (_GEN, 'stiffness2d_general_kernel', False),
    'general_parent': (_GEN, 'stiffness2d_general_kernel', True),
}
# A store that depends on the value, so that nothing is dead code.
_NEVER = 'T(12345.678)'
VARIANTS = {
    'exchange': {
        'full': [],
        'empty': [('  const int a = blockIdx.y;\n',
                   '  if (n0 > 0) return;\n  const int a = blockIdx.y;\n')],
        'no_loads': [
            ('  return *reinterpret_cast<const Pack<T, V>*>(p);\n',
             '  Pack<T, V> r;\n  for (int i = 0; i < V; ++i) '
             'r.v[i] = T(reinterpret_cast<uintptr_t>(p) & 7);\n  return r;\n'),
            ('    return row[cn * V + elem];\n',
             '    return T(reinterpret_cast<uintptr_t>(row + cn * V) & 7);\n')],
        'no_products': [
            ('  if (b != 0 && b != p) return load', '  if (true) return load'),
            ('    if (a == p || a == 0) {', '    if (false) {')],
        'no_stores': [
            ('    if (live) *reinterpret_cast',
             f'    if (live && v.v[0] == {_NEVER}) *reinterpret_cast')],
    },
    'exchange_parent': {'parent': []},
    'general': {
        'full': [],
        'empty': [('  const int first =',
                   '  if (num_units > 0) return;\n  const int first =')],
        'no_copies': [
            ('    const int e0 = tile * TE;\n',
             '    if (num_e > 0) return;\n    const int e0 = tile * TE;\n')],
        'no_products': [
            ('    T us[K];\n    if (owner) {',
             '    T us[K];\n    if (false) {'),
            ('    // 2. Row a: the fluxes; fa into R\'s row, D_eta^T fb into '
             'U\'s row.\n    if (owner) {',
             '    if (false) {'),
            ('      for (int q = 0; q < K; ++q) dm.template axpy<false>(q, '
             'fa[q], oa);\n',
             '      for (int q = 0; q < K; ++q) oa[q] += fa[q];\n')],
        'd_shared': [
            ('  static constexpr bool kDRegs = sizeof(T) == 4;',
             '  static constexpr bool kDRegs = false;')],
        'no_stores': [
            ('        out[a * K * num_e] = oa[a] + u_t[a * kLine + col];\n',
             '        const T v = oa[a] + u_t[a * kLine + col];\n'
             f'        if (v == {_NEVER}) out[a * K * num_e] = v;\n')],
    },
    'general_parent': {'parent': []},
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
  for kernel, (source, symbol, from_parent) in KERNELS.items():
    if from_parent and parent is None:
      continue
    root = parent if from_parent else _ROOT
    for name, patches in VARIANTS[kernel].items():
      src = _OUT / kernel / name
      shutil.rmtree(src, ignore_errors=True)
      src.mkdir(parents=True)
      text = (root / _CSRC / source).read_text()
      for old, new in patches:
        if text.count(old) != 1:
          raise RuntimeError(f'{kernel} {name}: the patch anchor {old!r} is '
                             'not unique')
        text = text.replace(old, new)
      (src / source).write_text(text)
      # A kernel name per variant: two libraries with the same kernel
      # symbols in one process fail at launch.
      procs[kernel, name] = subprocess.Popen(
          [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
           '-O3', '-Xcompiler', '-fPIC', '-shared', '-cudart', 'shared',
           '-Xptxas', '-v', f'-D{symbol}={kernel}_{name}', '-o',
           str(src / 'lib.so'), str(src / source)],
          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  for (kernel, name), proc in procs.items():
    out, _ = proc.communicate()
    if proc.returncode:
      raise RuntimeError(f'{kernel} {name}: nvcc failed\n{out}')
    if name in ('full', 'parent'):
      lines = out.splitlines()
      for i, line in enumerate(lines):
        if 'Compiling entry function' in line and ('Li9E' in line or
                                                   'Li4ELb1E' in line):
          print(f'{kernel} {name}: {line.split("function")[-1].strip()} '
                + ' '.join(x.strip() for x in lines[i + 1:i + 4]
                           if 'registers' in x or 'spill' in x))
  return list(procs)


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
  pp = ctypes.POINTER(pv)
  ptrs = lambda ts: (pv * len(ts))(*(t.data_ptr() for t in ts))
  stream = torch.cuda.current_stream(dev).cuda_stream
  rng = np.random.default_rng(0)
  sms = torch.cuda.get_device_properties(dev).multi_processor_count
  lib = lambda kernel, name: ctypes.CDLL(str(_OUT / kernel / name / 'lib.so'))

  def run(label, call, outs, plain, symbol):
    for o in outs:
      o.zero_()
    if call() != 0:
      raise RuntimeError(f'{label}: launch failed')
    torch.cuda.synchronize(dev)
    scale = max(float(p.abs().max()) for p in plain)
    err = max(float((a - b).abs().max()) for a, b in zip(outs, plain)) / scale
    us_time = kernel_checks.time_ms(call, device=dev) * 1e3
    own = kernel_checks.kernel_us(call, symbol, device=dev)
    own = 'n/a' if own is None else f'{own:6.2f} us'
    print(f'{label:56s}: {us_time:8.2f} us (kernel {own}), vs plain '
          f'{err:.2e}', flush=True)

  # The exchange at the datagen shape: one field, two in one launch, two
  # one-field launches.
  k, n = 9, 64
  ws = tuple(torch.as_tensor(rng.standard_normal((k, k, n, n)),
                             dtype=torch.float32, device=dev)
             for _ in range(2))
  outs = tuple(torch.empty_like(w) for w in ws)
  plain = tuple(cuda_exchange.exchange2d_plain(w) for w in ws)
  for kernel, name in built:
    if not kernel.startswith('exchange'):
      continue
    fn = lib(kernel, name).exchange2d_f32
    symbol = f'{kernel}_{name}'
    if kernel == 'exchange_parent':
      fn.argtypes = (pv, pv, ci, ci, ci, pv)
      one = lambda i: fn(ws[i].data_ptr(), outs[i].data_ptr(), k, n, n, stream)
      run(f'{kernel} {name} one field', lambda: one(0), outs[:1], plain[:1],
          symbol)
      run(f'{kernel} {name} two launches', lambda: one(0) or one(1), outs,
          plain, symbol)
      continue
    fn.argtypes = (pp, pp) + (ci,) * 9 + (pv,)

    def launch(fields, geo_fields, threads=cuda_exchange.THREADS):
      geo = cuda_exchange.launch_geometry(k, n, n, 4, geo_fields,
                                          threads=threads)
      return lambda: fn(ptrs(ws[fields]), ptrs(outs[fields]), geo_fields, k,
                        1, n, n, int(geo.vec), geo.tx, geo.ty,
                        int(geo.shuffle), stream)
    for threads in ((128, 256, 512) if name == 'full'
                    else (cuda_exchange.THREADS,)):
      tag = f'{kernel} {name} {threads} threads'
      run(f'{tag} one field', launch(slice(0, 1), 1, threads), outs[:1],
          plain[:1], symbol)
      run(f'{tag} two fields, one launch', launch(slice(0, 2), 2, threads),
          outs, plain, symbol)
      first = launch(slice(0, 1), 1, threads)
      second = launch(slice(1, 2), 1, threads)
      run(f'{tag} two launches', lambda: first() or second(), outs, plain,
          symbol)

  # The general kernel at the heated cavity's and the datagen shapes.
  for kk, num_e, num_c in ((8, 144, 2), (9, 4096, 2), (9, 4096, 1)):
    field = lambda: torch.as_tensor(rng.standard_normal((kk, kk, num_e)),
                                    dtype=torch.float32, device=dev)
    us = tuple(field() for _ in range(num_c))
    gs = tuple(field() for _ in range(3))
    dmat = torch.as_tensor(rng.standard_normal((kk, kk)),
                           dtype=torch.float32, device=dev)
    outs = tuple(torch.empty_like(u) for u in us)
    plain = cs2.stiffness2d_general_plain(us, gs, dmat)
    head = (dmat.data_ptr(), ptrs(us), ptrs(gs), ptrs(outs), num_c, kk,
            num_e)
    for kernel, name in built:
      if not kernel.startswith('general'):
        continue
      lib_ = lib(kernel, name)
      fn = lib_.stiffness2d_general_f32
      label = f'{kernel} {name} k {kk} E {num_e} C {num_c}'
      symbol = f'{kernel}_{name}'
      if kernel == 'general_parent':
        fn.argtypes = (pv, pp, pp, pp, ci, ci, ci, pv)
        run(label, lambda: fn(*head, stream), outs, plain, symbol)
        continue
      fn.argtypes = (pv, pp, pp, pp, ci, ci, ci, ci, ci, ci, pv)
      lib_.stiffness2d_general_layout.argtypes = (ci, ci, ci,
                                                  ctypes.POINTER(ci))
      tile = cs2.general2d_tile(num_e, num_c, 4, sms)
      out4 = (ci * 4)()
      if lib_.stiffness2d_general_layout(kk, 0, tile, out4) != 0:
        raise RuntimeError('layout query failed')
      grid, span = cs2.general2d_grid(num_e, num_c, tile, sms, out4[3])
      plans = [(f'plan: tile {tile} grid {grid} span {span} ({out4[3]} '
                'blocks/SM)', tile, grid, span)]
      if name == 'full':
        for te in (8, 32):
          tiles = -(-num_e // te)
          for grid, span in sorted({
              (num_c * tiles, 1), (min(sms, num_c * tiles), 1),
              (min(2 * sms, num_c * tiles), 1), (min(sms, tiles), num_c),
              (min(2 * sms, tiles), num_c)}):
            plans.append((f'tile {te} grid {grid} span {span}', te, grid,
                          span))
      for plan, te, grid, span in plans:
        run(f'{label} {plan}',
            lambda te=te, grid=grid, span=span: fn(*head, te, grid, span,
                                                   stream),
            outs, plain, symbol)
  return 0


if __name__ == '__main__':
  sys.exit(main())

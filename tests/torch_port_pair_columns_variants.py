"""What holds the general bf16x3 pair kernels: variant builds, timed.

Copies ``csrc/stiffness3d_pair_general.cu`` and its headers once per
variant, patches the copy (each variant removes or changes one cost of
``csrc/stiffness3d_pair_columns.cuh``), builds each with ``nvcc`` in its
own namespace, and times every variant's xi-slab and zeta-slab kernel at
16^3 elements, order 7, C = 1, 2 and 3, on random fields, with CUDA events
(``kernel_checks.time_ms``).  The unpatched build is also held to the plain
version.  Builds go to ``swirlfem_tpu_torch/_build/variants/``.  On a GPU
host, from the root of the checkout:

    python tests/torch_port_pair_columns_variants.py

Variants: ``full`` (as shipped); ``no_factor_loads`` (the factor fields
replaced by constants: what their loads cost); ``no_products`` (the
tensor-core products replaced by one integer op); ``rereads_cached``
(components past the first read the factor fields of tile 0, a footprint
the caches hold: what the re-reads cost beyond their requests);
``smaller_l1`` (73,856 bytes of idle shared memory at k = 8, which the L1
gives up); ``factors_not_in_l1`` (the factor fields loaded without L1
allocation).
"""

import ctypes
import os
import pathlib
import shutil
import subprocess
import sys

import torch

_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

from swirlfem_tpu_torch.examples import taylor_green_3d as tgv  # pylint: disable=wrong-import-position
from swirlfem_tpu_torch.ops import cuda_stiffness3d as cs3  # pylint: disable=wrong-import-position
from swirlfem_tpu_torch.ops import kernel_checks  # pylint: disable=wrong-import-position

_CSRC = _ROOT / 'swirlfem_tpu_torch' / 'csrc'
_OUT = _ROOT / 'swirlfem_tpu_torch' / '_build' / 'variants'
_HEADER = 'stiffness3d_pair_columns.cuh'

# (text in the header, its replacement) per variant.
VARIANTS = {
    'full': [],
    'no_factor_loads': [
        ('    load_metric(0, gv[0]);',
         '    for (int i = 0; i < 2; ++i) for (int f = 0; f < kFactors; ++f)'
         ' for (int r = 0; r < 2; ++r) for (int j = 0; j < 2; ++j)'
         ' gv[i][f][r][j] = d_s[f];'),
        ('      if (V != kAffine && a + 1 < K) load_metric(a + 1, '
         'gv[(a + 1) & 1]);', '')],
    'no_products': [
        ('  asm("mma.sync',
         '  d[0] += __uint_as_float(a[0] ^ b0);\n  return;\n  asm("mma.sync')],
    'rereads_cached': [
        ('          load2<false>(ptrs.g[f] + roff[r] + a * slab_step + e, '
         'plive[r], e,',
         '          const long long e2 = comp == 0 ? e : e % L::kTE;\n'
         '          load2<false>(ptrs.g[f] + roff[r] + a * slab_step + e2, '
         'plive[r], e2,')],
    'smaller_l1': [
        ('  static constexpr int kSmem = kTable * 4 + 4 * (kDPPart + kB1Part '
         '+ kB2Part);',
         '  static constexpr int kSmem = kTable * 4 + 4 * (kDPPart + kB1Part '
         '+ kB2Part) + (K == 8 ? 73856 : 0);')],
    'factors_not_in_l1': [
        ('      x = kStream ? __ldcs(q) : __ldg(q);',
         '      if (kStream) {\n        x = __ldcs(q);\n      } else {\n'
         '        asm volatile("ld.global.nc.L1::no_allocate.v2.f32 {%0, %1},'
         ' [%2];" : "=f"(x.x), "=f"(x.y) : "l"(q));\n      }')],
}


def _nvcc() -> str:
  for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
               shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc'):
    if cand and os.path.isfile(cand):
      return cand
  raise RuntimeError('nvcc not found')


def build_all():
  """One shared library per variant, all compiled together."""
  procs = {}
  for name, patches in VARIANTS.items():
    src = _OUT / name
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for f in ('stiffness3d_pair_general.cu', _HEADER, 'split_bf16_mma.cuh'):
      shutil.copy(_CSRC / f, src / f)
    text = (src / _HEADER).read_text()
    for old, new in patches:
      if text.count(old) != 1:
        raise RuntimeError(f'{name}: the patch anchor {old!r} is not unique')
      text = text.replace(old, new)
    (src / _HEADER).write_text(text)
    # A namespace per variant: two libraries with the same kernel symbols
    # in one process fail at launch.
    procs[name] = subprocess.Popen(
        [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
         '-O3', '-Xcompiler', '-fPIC', '-shared', '-cudart', 'shared',
         '-Xptxas', '-v', f'-Dpair_columns=pc_{name}', '-o',
         str(src / 'lib.so'), str(src / 'stiffness3d_pair_general.cu')],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  for name, proc in procs.items():
    out, _ = proc.communicate()
    if proc.returncode:
      raise RuntimeError(f'{name}: nvcc failed\n{out}')
    lines = out.splitlines()
    for i, line in enumerate(lines):
      if 'ILi8ELi0E' in line and 'Compiling' in line:
        print(f'{name}: k = 8 {" ".join(x.strip() for x in lines[i + 1:i + 3])}')


def main() -> int:
  if not torch.cuda.is_available():
    print('needs a CUDA device')
    return 1
  dev = torch.device('cuda', 0)
  print(torch.cuda.get_device_name(0), subprocess.run(
      ['nvidia-smi', '--query-gpu=power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=False).stdout.strip())
  build_all()
  k, num_e = 8, 16 ** 3
  ops = tgv.create_tgv(16, 7, dtype=torch.float32, device=dev).fast_ops
  field = lambda seed: kernel_checks.random_field(
      (k,) * 3 + (num_e,), dtype=torch.float32, device=dev, seed=seed)
  us = tuple(field(1 + s) for s in range(3))
  gs = tuple(field(10 + s) for s in range(6))
  dp, dmat = ops.pair_derivative_split(), ops.mats['dmat']
  grid = cs3.pair_columns_grid(
      num_e, k, torch.cuda.get_device_properties(dev).multi_processor_count,
      1)
  pv = ctypes.c_void_p
  ptrs = lambda ts: (pv * len(ts))(*(t.data_ptr() for t in ts))
  stream = torch.cuda.current_stream(dev).cuda_stream
  for name in VARIANTS:
    lib = ctypes.CDLL(str(_OUT / name / 'lib.so'))
    for zeta, entry in ((False, 'stiffness3d_pair_general_f32'),
                        (True, 'stiffness3d_pairz_general_f32')):
      fn = getattr(lib, entry)
      fn.argtypes = (pv, pv, ctypes.POINTER(pv), ctypes.POINTER(pv),
                     ctypes.POINTER(pv), ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, pv)
      fn.restype = ctypes.c_int
      outs = tuple(torch.empty_like(u) for u in us)
      args = (dp.data_ptr(), dmat.data_ptr(), ptrs(us), ptrs(gs), ptrs(outs))
      times = []
      for num_c in (1, 2, 3):
        call = lambda c=num_c: fn(*args, c, k, num_e, grid, stream)
        if call() != 0:
          raise RuntimeError(f'{name}: launch failed')
        times.append(kernel_checks.time_ms(call, device=dev) * 1e3)
      err = ''
      if name == 'full':
        plain = (cs3.stiffness3d_pairz_general_plain if zeta else
                 cs3.stiffness3d_pair_general_plain)(us, gs, dp, dmat)
        scale = max(float(p.abs().max()) for p in plain)
        err = (f', vs plain {max(float((a - b).abs().max()) for a, b in zip(outs, plain)) / scale:.2e}')
      print(f'{name:18s} {"zeta" if zeta else "xi  "}: C = 1, 2, 3: '
            + ', '.join(f'{t:.2f}' for t in times) + f' us{err}', flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())

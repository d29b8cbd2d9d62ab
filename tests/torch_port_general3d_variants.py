"""What holds the general FP32 3D stiffness kernel: variant builds, timed.

Copies ``csrc/stiffness3d_general.cu`` once per variant, patches the copy
(each variant removes or changes one cost), builds each with ``nvcc`` under
its own kernel name, and times every variant at 16^3 elements, order 7,
C = 1, 2 and 3, on random fields and factor fields, with CUDA events
(``kernel_checks.time_ms``).  The unpatched build is also held to the plain
version.  Builds go to ``swirlfem_tpu_torch/_build/general3d_variants/``.
On a GPU host, from the root of the checkout:

    python tests/torch_port_general3d_variants.py

Variants: ``full`` (as shipped); ``no_factor_loads`` (the factor fields'
copies into their shared tiles skipped: what their device-memory reads
cost); ``no_field_copies`` (the fields' copies skipped);
``small_footprint`` (every tile copies the fields and factor fields of
tile 0, a footprint the caches hold: what the device-memory bytes cost);
``no_contractions`` (each line contraction keeps one FFMA of its k^2: what
the FFMAs and the table loads cost; the shared-memory data traffic stays);
``warps16`` (at most 16 warps a block, half the lines a thread);
``no_factor_tiles`` (stage B reads the factor fields from device memory at
every component, as at k = 10: what keeping them in shared memory saves).
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

from swirlfem_tpu_torch.ops import cuda_stiffness3d as cs3  # pylint: disable=wrong-import-position
from swirlfem_tpu_torch.ops import kernel_checks  # pylint: disable=wrong-import-position

_CSRC = _ROOT / 'swirlfem_tpu_torch' / 'csrc'
_OUT = _ROOT / 'swirlfem_tpu_torch' / '_build' / 'general3d_variants'
_SOURCE = 'stiffness3d_general.cu'

# (text in the source, its replacement) per variant.
VARIANTS = {
    'full': [],
    'no_factor_loads': [
        ('        stage(static_cast<const T*>(ptrs.g[f]), g_s + f * L::kTile, '
         'tile);\n', '')],
    'no_field_copies': [
        ('    stage(static_cast<const T*>(ptrs.u[comp]), u_s, tile);\n', '')],
    'small_footprint': [
        ('    const long long e0 = static_cast<long long>(tile) * TE;',
         '    const long long e0 = 0 * tile;')],
    'no_contractions': [
        ('      if (i0 + t < K) {', '      if (i0 + t < 1) {')],
    'warps16': [
        ('  static constexpr int kRounds = (kLines + 8 * kSlots - 1) / '
         '(8 * kSlots);',
         '  static constexpr int kRounds = (kLines + 16 * kSlots - 1) / '
         '(16 * kSlots);')],
    'no_factor_tiles': [
        ('      kSmemLimit;\n  static constexpr int kTiles',
         '      kSmemLimit && false;\n  static constexpr int kTiles')],
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
    text = (_CSRC / _SOURCE).read_text()
    for old, new in patches:
      if text.count(old) != 1:
        raise RuntimeError(f'{name}: the patch anchor {old!r} is not unique')
      text = text.replace(old, new)
    (src / _SOURCE).write_text(text)
    # A kernel name per variant: two libraries with the same kernel symbols
    # in one process fail at launch.
    procs[name] = subprocess.Popen(
        [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
         '-O3', '-Xcompiler', '-fPIC', '-shared', '-cudart', 'shared',
         '-Xptxas', '-v', f'-Dstiffness3d_general_kernel=sg3_{name}', '-o',
         str(src / 'lib.so'), str(src / _SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  for name, proc in procs.items():
    out, _ = proc.communicate()
    if proc.returncode:
      raise RuntimeError(f'{name}: nvcc failed\n{out}')
    lines = out.splitlines()
    for i, line in enumerate(lines):
      if 'IfLi8E' in line and 'Compiling' in line:
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
  field = lambda seed: kernel_checks.random_field(
      (k,) * 3 + (num_e,), dtype=torch.float32, device=dev, seed=seed)
  us = tuple(field(1 + s) for s in range(3))
  gs = tuple(field(10 + s) for s in range(6))
  dmat = kernel_checks.random_field((k, k), dtype=torch.float32, device=dev,
                                    seed=20)
  grid = cs3.general3d_grid(
      num_e, k, torch.cuda.get_device_properties(dev).multi_processor_count,
      1)
  pv = ctypes.c_void_p
  ptrs = lambda ts: (pv * len(ts))(*(t.data_ptr() for t in ts))
  stream = torch.cuda.current_stream(dev).cuda_stream
  for name in VARIANTS:
    fn = ctypes.CDLL(str(_OUT / name / 'lib.so')).stiffness3d_general_f32
    fn.argtypes = (pv, ctypes.POINTER(pv), ctypes.POINTER(pv),
                   ctypes.POINTER(pv), ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, pv)
    fn.restype = ctypes.c_int
    outs = tuple(torch.empty_like(u) for u in us)
    args = (dmat.data_ptr(), ptrs(us), ptrs(gs), ptrs(outs))
    times = []
    for num_c in (1, 2, 3):
      call = lambda c=num_c: fn(*args, c, k, num_e, grid, stream)
      if call() != 0:
        raise RuntimeError(f'{name}: launch failed')
      times.append(kernel_checks.time_ms(call, device=dev) * 1e3)
    # The full build and the candidate changes compute the function; the
    # other variants do not, and their difference is printed as it is.
    plain = cs3.stiffness3d_general_plain(us, gs, dmat)
    scale = max(float(p.abs().max()) for p in plain)
    err = max(float((a - b).abs().max()) for a, b in zip(outs, plain)) / scale
    print(f'{name:16s}: C = 1, 2, 3: ' + ', '.join(f'{t:.2f}' for t in times)
          + f' us, vs plain {err:.2e}', flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())

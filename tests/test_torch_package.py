"""The port imports torch and never JAX, flax, optax, ml_collections or the
JAX package; nor does chip_smoke.py."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    'swirlfem_tpu_torch',
    'swirlfem_tpu_torch.interop',
    'swirlfem_tpu_torch.core.bc',
    'swirlfem_tpu_torch.core.fespace',
    'swirlfem_tpu_torch.core.mesh',
    'swirlfem_tpu_torch.core.premesh',
    'swirlfem_tpu_torch.core.quadrature',
    'swirlfem_tpu_torch.core.refine',
    'swirlfem_tpu_torch.core.structured',
    'swirlfem_tpu_torch.core.tensor',
    'swirlfem_tpu_torch.core.topology',
    'swirlfem_tpu_torch.examples.cavity',
    'swirlfem_tpu_torch.examples.cylinder',
    'swirlfem_tpu_torch.examples.natural_convection',
    'swirlfem_tpu_torch.examples.poisson',
    'swirlfem_tpu_torch.examples.taylor_green_3d',
    'swirlfem_tpu_torch.linalg.cg',
    'swirlfem_tpu_torch.linalg.linear_solve',
    'swirlfem_tpu_torch.linalg.projection',
    'swirlfem_tpu_torch.models.transformer',
    'swirlfem_tpu_torch.niles.coarsen',
    'swirlfem_tpu_torch.niles.config',
    'swirlfem_tpu_torch.niles.datagen',
    'swirlfem_tpu_torch.niles.datagen_config',
    'swirlfem_tpu_torch.niles.datagen_distributed',
    'swirlfem_tpu_torch.niles.input_pipeline',
    'swirlfem_tpu_torch.niles.main',
    'swirlfem_tpu_torch.niles.profile_datagen',
    'swirlfem_tpu_torch.niles.train',
    'swirlfem_tpu_torch.nse.distributed',
    'swirlfem_tpu_torch.nse.scalar',
    'swirlfem_tpu_torch.nse.solver',
    'swirlfem_tpu_torch.ops.assembled',
    'swirlfem_tpu_torch.ops.coarse_cheb',
    'swirlfem_tpu_torch.ops.cuda_build',
    'swirlfem_tpu_torch.ops.cuda_exchange',
    'swirlfem_tpu_torch.ops.cuda_split',
    'swirlfem_tpu_torch.ops.cuda_stiffness',
    'swirlfem_tpu_torch.ops.cuda_stiffness2d',
    'swirlfem_tpu_torch.ops.cuda_stiffness3d',
    'swirlfem_tpu_torch.ops.dense_schur',
    'swirlfem_tpu_torch.ops.fdm_element',
    'swirlfem_tpu_torch.ops.fdm_pressure',
    'swirlfem_tpu_torch.ops.fft_pressure',
    'swirlfem_tpu_torch.ops.kernel_checks',
    'swirlfem_tpu_torch.ops.schwarz',
    'swirlfem_tpu_torch.ops.schwarz_distributed',
    'swirlfem_tpu_torch.ops.sem2d',
    'swirlfem_tpu_torch.ops.sem3d',
    'swirlfem_tpu_torch.parallel.crystal_router',
    'swirlfem_tpu_torch.parallel.pscan',
    'swirlfem_tpu_torch.parallel.repartition',
    'swirlfem_tpu_torch.parallel.semi_traced',
    'swirlfem_tpu_torch.parallel.spmd',
    'swirlfem_tpu_torch.sde.nn_sde',
    'swirlfem_tpu_torch.sde.sdeint',
    'swirlfem_tpu_torch.utils.box',
    'swirlfem_tpu_torch.utils.cylinder',
    'swirlfem_tpu_torch.utils.facets',
    'swirlfem_tpu_torch.utils.gmsh',
    'swirlfem_tpu_torch.utils.partition',
    'swirlfem_tpu_torch.utils.profiling',
]

CHECK = """
import importlib, sys
for name in sys.argv[1:]:
  importlib.import_module(name)
banned = ('jax', 'jaxlib', 'flax', 'optax', 'ml_collections', 'orbax',
          'clu', 'absl', 'h5py', 'swirlfem_tpu')
bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)
assert not bad, bad
from swirlfem_tpu_torch.ops import cuda_build
assert cuda_build._library is None, 'importing built the kernels'
print('clean', len(sys.argv) - 1)
"""


def test_port_imports_no_jax():
  env = dict(os.environ, PYTHONPATH=REPO)
  proc = subprocess.run([sys.executable, '-c', CHECK, *MODULES], cwd=REPO,
                        env=env, capture_output=True, text=True, timeout=300,
                        check=False)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip() == f'clean {len(MODULES)}'


def test_module_list_covers_the_package():
  found = set()
  pkg = os.path.join(REPO, 'swirlfem_tpu_torch')
  for root, _, files in os.walk(pkg):
    for f in files:
      if f.endswith('.py'):
        rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
        name = rel.replace(os.sep, '.').removesuffix('.__init__')
        found.add(name)
  packages = {m for m in found if m.count('.') == 1
              and os.path.isdir(os.path.join(REPO, *m.split('.')))}
  assert found - packages == set(MODULES), found ^ set(MODULES)


BANNED_ROOTS = ('jax', 'jaxlib', 'flax', 'optax', 'ml_collections', 'orbax',
                'clu', 'absl', 'swirlfem_tpu')


def test_chip_smoke_imports_no_jax():
  with open(os.path.join(REPO, 'chip_smoke.py'), encoding='utf-8') as f:
    tree = ast.parse(f.read())
  roots = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      roots.update(a.name.split('.')[0] for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module:
      roots.add(node.module.split('.')[0])
  assert 'swirlfem_tpu_torch' in roots
  assert not roots & set(BANNED_ROOTS), roots & set(BANNED_ROOTS)

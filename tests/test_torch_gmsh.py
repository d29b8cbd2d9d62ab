"""The port's Gmsh reader (`utils.gmsh`) against the JAX package's, on
files this test writes itself: a small warped quad mesh, periodic in x,
with physical names (one of them non-ASCII, with a space), in MSH 4.1 and
2.2, ASCII and binary.  Every encoding reads to the same premesh in both
packages, and one generic step on the mesh matches the JAX step in
float64."""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.utils import gmsh as jgmsh
from swirlfem_tpu_torch.utils import gmsh as tgmsh
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

NX, NY = 4, 3
NAMES = {(1, 1): 'bottom', (1, 2): 'Deckel ü', (2, 3): 'fluid'}


def _mesh():
  """Nodes (tags, xyz), line blocks per curve, the quads, the periodic
  table (left curve -> right curve) and the entities."""
  ij = [(i, j) for j in range(NY + 1) for i in range(NX + 1)]
  index = {p: k for k, p in enumerate(ij)}
  x = np.array([i / NX for i, _ in ij])
  y = np.array([j / NY for _, j in ij])
  # Warped interior, straight edges: x in [0, 1] periodic, walls at y = 0, 1.
  xw = x + 0.04 * np.sin(2 * np.pi * x) * np.sin(np.pi * y)
  yw = y + 0.05 * np.sin(np.pi * y) * np.cos(2 * np.pi * x)
  tags = 7 + 2 * np.arange(len(ij))
  xyz = np.stack([xw, yw, np.zeros_like(x)], axis=-1)
  tag = lambda i, j: int(tags[index[(i, j)]])
  curves = {
      1: [(tag(i, 0), tag(i + 1, 0)) for i in range(NX)],            # bottom
      2: [(tag(NX, j), tag(NX, j + 1)) for j in range(NY)],          # right
      3: [(tag(i + 1, NY), tag(i, NY)) for i in range(NX)][::-1],    # top
      4: [(tag(0, j + 1), tag(0, j)) for j in range(NY)][::-1],      # left
  }
  quads = [(tag(i, j), tag(i + 1, j), tag(i + 1, j + 1), tag(i, j + 1))
           for j in range(NY) for i in range(NX)]
  periodic = {tag(0, j): tag(NX, j) for j in range(NY + 1)}
  corners = [tag(0, 0), tag(NX, 0), tag(NX, NY), tag(0, NY)]
  curve_phys = {1: [1], 2: [], 3: [2], 4: []}
  return tags, xyz, curves, quads, periodic, corners, curve_phys


def _write_41_ascii() -> str:
  tags, xyz, curves, quads, periodic, corners, curve_phys = _mesh()
  out = ['$MeshFormat', '4.1 0 8', '$EndMeshFormat', '$PhysicalNames',
         str(len(NAMES))]
  out += [f'{d} {t} "{n}"' for (d, t), n in NAMES.items()]
  out += ['$EndPhysicalNames', '$Entities', '4 4 1 0']
  for k, c in enumerate(corners, start=1):
    p = xyz[list(tags).index(c)]
    out.append(f'{k} {p[0]:.17g} {p[1]:.17g} 0 0')
  for c in range(1, 5):
    phys = curve_phys[c]
    out.append(f'{c} 0 0 0 1 1 0 {len(phys)} {" ".join(map(str, phys))} '
               f'2 {c} {-(c % 4 + 1)}')
  out.append('1 0 0 0 1 1 0 1 3 4 1 2 3 4')
  out += ['$EndEntities', '$Nodes',
          f'1 {len(tags)} {tags.min()} {tags.max()}', f'2 1 0 {len(tags)}']
  out += [str(t) for t in tags]
  out += [f'{p[0]:.17g} {p[1]:.17g} {p[2]:.17g}' for p in xyz]
  out.append('$EndNodes')
  num = sum(len(v) for v in curves.values()) + len(quads)
  out += ['$Elements', f'5 {num} 1 {num}']
  eid = 1
  for c, rows in curves.items():
    out.append(f'1 {c} 1 {len(rows)}')
    for row in rows:
      out.append(f'{eid} {row[0]} {row[1]}')
      eid += 1
  out.append(f'2 1 3 {len(quads)}')
  for row in quads:
    out.append(f'{eid} ' + ' '.join(map(str, row)))
    eid += 1
  out += ['$EndElements', '$Periodic', '1', '1 4 2', '0', str(len(periodic))]
  out += [f'{s} {m}' for s, m in periodic.items()]
  out.append('$EndPeriodic')
  return '\n'.join(out) + '\n'


def _i4(*v):
  return struct.pack(f'<{len(v)}i', *[int(x) for x in v])


def _szt(*v):
  return struct.pack(f'<{len(v)}q', *[int(x) for x in v])


def _f8(*v):
  return struct.pack(f'<{len(v)}d', *[float(x) for x in v])


def _names_block() -> bytes:
  body = '\n'.join(f'{d} {t} "{n}"' for (d, t), n in NAMES.items())
  return (f'$PhysicalNames\n{len(NAMES)}\n{body}\n$EndPhysicalNames\n'
          ).encode('utf-8')


def _write_41_binary() -> bytes:
  tags, xyz, curves, quads, periodic, corners, curve_phys = _mesh()
  out = bytearray(b'$MeshFormat\n4.1 1 8\n' + _i4(1) + b'\n$EndMeshFormat\n')
  out += _names_block()
  out += b'$Entities\n' + _szt(4, 4, 1, 0)
  for k, c in enumerate(corners, start=1):
    p = xyz[list(tags).index(c)]
    out += _i4(k) + _f8(p[0], p[1], 0.0) + _szt(0)
  for c in range(1, 5):
    phys = curve_phys[c]
    out += (_i4(c) + _f8(0, 0, 0, 1, 1, 0) + _szt(len(phys)) + _i4(*phys)
            + _szt(2) + _i4(c, -(c % 4 + 1)))
  out += (_i4(1) + _f8(0, 0, 0, 1, 1, 0) + _szt(1) + _i4(3) + _szt(4)
          + _i4(1, 2, 3, 4))
  out += b'\n$EndEntities\n'
  out += b'$Nodes\n' + _szt(1, len(tags), tags.min(), tags.max())
  out += _i4(2, 1, 0) + _szt(len(tags)) + _szt(*tags) + _f8(*xyz.reshape(-1))
  out += b'\n$EndNodes\n'
  num = sum(len(v) for v in curves.values()) + len(quads)
  out += b'$Elements\n' + _szt(5, num, 1, num)
  eid = 1
  for c, rows in curves.items():
    out += _i4(1, c, 1) + _szt(len(rows))
    for row in rows:
      out += _szt(eid, *row)
      eid += 1
  out += _i4(2, 1, 3) + _szt(len(quads))
  for row in quads:
    out += _szt(eid, *row)
    eid += 1
  out += b'\n$EndElements\n'
  out += b'$Periodic\n' + _szt(1) + _i4(1, 4, 2) + _szt(0)
  out += _szt(len(periodic))
  for s, m in periodic.items():
    out += _szt(s, m)
  out += b'\n$EndPeriodic\n'
  return bytes(out)


def _elements_22():
  """(etype, (physical, elementary), nodes) rows of the 2.2 encodings."""
  _, _, curves, quads, _, _, curve_phys = _mesh()
  rows = []
  for c, lines in curves.items():
    phys = curve_phys[c][0] if curve_phys[c] else 0
    rows += [(1, (phys, c), row) for row in lines]
  rows += [(3, (3, 1), row) for row in quads]
  return rows


def _periodic_22() -> str:
  periodic = _mesh()[4]
  body = '\n'.join(f'{s} {m}' for s, m in periodic.items())
  return f'$Periodic\n1\n1 4 2\n{len(periodic)}\n{body}\n$EndPeriodic\n'


def _write_22_ascii() -> str:
  tags, xyz = _mesh()[:2]
  out = ['$MeshFormat', '2.2 0 8', '$EndMeshFormat', '$PhysicalNames',
         str(len(NAMES))]
  out += [f'{d} {t} "{n}"' for (d, t), n in NAMES.items()]
  out += ['$EndPhysicalNames', '$Nodes', str(len(tags))]
  out += [f'{t} {p[0]:.17g} {p[1]:.17g} {p[2]:.17g}' for t, p in zip(tags, xyz)]
  rows = _elements_22()
  out += ['$EndNodes', '$Elements', str(len(rows))]
  for eid, (etype, (phys, ent), nodes) in enumerate(rows, start=1):
    out.append(f'{eid} {etype} 2 {phys} {ent} ' + ' '.join(map(str, nodes)))
  out.append('$EndElements')
  return '\n'.join(out) + '\n' + _periodic_22()


def _write_22_binary() -> bytes:
  tags, xyz = _mesh()[:2]
  out = bytearray(b'$MeshFormat\n2.2 1 8\n' + _i4(1) + b'\n$EndMeshFormat\n')
  out += _names_block()
  out += f'$Nodes\n{len(tags)}\n'.encode()
  for t, p in zip(tags, xyz):
    out += struct.pack('<i3d', int(t), *p)
  out += b'\n$EndNodes\n'
  rows = _elements_22()
  out += f'$Elements\n{len(rows)}\n'.encode()
  eid = 1
  for etype in (1, 3):
    block = [r for r in rows if r[0] == etype]
    out += _i4(etype, len(block), 2)
    for _, (phys, ent), nodes in block:
      out += _i4(eid, phys, ent, *nodes)
      eid += 1
  out += b'\n$EndElements\n' + _periodic_22().encode()
  return bytes(out)


@pytest.fixture(scope='module')
def msh_files(tmp_path_factory):
  d = tmp_path_factory.mktemp('msh')
  files = {}
  for name, write in (('41_ascii', _write_41_ascii),
                      ('41_binary', _write_41_binary),
                      ('22_ascii', _write_22_ascii),
                      ('22_binary', _write_22_binary)):
    data = write()
    path = d / f'{name}.msh'
    if isinstance(data, str):
      path.write_text(data, encoding='utf-8')
    else:
      path.write_bytes(data)
    files[name] = str(path)
  return files


def _premesh_equal(a, b):
  np.testing.assert_array_equal(np.asarray(a.node_coords),
                                np.asarray(b.node_coords))
  np.testing.assert_array_equal(np.asarray(a.elements), np.asarray(b.elements))
  assert sorted(a.physical_groups) == sorted(b.physical_groups)
  for name in a.physical_groups:
    np.testing.assert_array_equal(np.asarray(a.physical_groups[name]),
                                  np.asarray(b.physical_groups[name]))
  np.testing.assert_array_equal(np.asarray(a.periodic_links),
                                np.asarray(b.periodic_links))


@pytest.mark.parametrize('name', ['41_ascii', '41_binary', '22_ascii',
                                  '22_binary'])
def test_every_encoding_reads_as_the_jax_reader_does(msh_files, name):
  got = tgmsh.read(msh_files[name], ndim=2)
  _premesh_equal(got, jgmsh.read(msh_files[name], ndim=2))
  _premesh_equal(got, tgmsh.read(msh_files['41_ascii'], ndim=2))
  assert sorted(got.physical_groups) == ['Deckel ü', 'bottom']
  assert got.elements.shape == (NX * NY, 4)
  assert got.periodic_links.shape == (NY, 2, 2)


def test_reader_refuses_what_it_cannot_read(tmp_path):
  bad = tmp_path / 'bad.msh'
  bad.write_text('$MeshFormat\n2.2 0 8\n$EndMeshFormat\n')
  with pytest.raises(ValueError, match='Nodes'):
    tgmsh.read(str(bad), ndim=2)
  bad.write_text('not a mesh')
  with pytest.raises(ValueError, match='not a Gmsh MSH file'):
    tgmsh.read(str(bad), ndim=2)
  with pytest.raises(ValueError, match='invalid ndim'):
    tgmsh.read(str(bad), ndim=4)


def test_one_generic_step_on_the_gmsh_mesh_matches_jax(msh_files):
  """The periodic channel read from the file: walls on both named groups,
  the constant pressure null (enclosed in y, periodic in x), the dense
  Schur inverse composed with the projection."""
  from swirlfem_tpu.core.bc import BCType as JBC
  from swirlfem_tpu.nse.solver import StokesSEM as JSEM
  from swirlfem_tpu_torch.core.bc import BCType
  from swirlfem_tpu_torch.nse.solver import StokesSEM
  path = msh_files['41_binary']
  walls = ('bottom', 'Deckel ü')
  jsem = JSEM.create(jgmsh.read(path, ndim=2),
                     {g: (JBC.DIRICHLET, 0.0) for g in walls}, order=3)
  tsem = StokesSEM.create(tgmsh.read(path, ndim=2),
                          {g: (BCType.DIRICHLET, 0.0) for g in walls},
                          order=3, device='cpu', dtype=torch.float64)
  assert tsem.fast_ops is None and tsem.assembled_ops is not None
  assert tsem.velocity.mesh.exchange_gather_indices.numel() > 0  # periodic
  nv = tsem.velocity.mesh.num_nodes
  npn = tsem.pressure.pspace.mesh.num_nodes
  y = tsem.velocity.mesh.node_coords.numpy()[:, 1]
  mask = np.asarray(jsem.velocity.interior_mask)
  u0 = np.stack([y * (1 - y), 0.1 * np.sin(np.pi * y)], -1) * mask
  f = np.stack([np.ones_like(y), np.zeros_like(y)], -1) * 1e-2
  kw = dict(mu=1e-2, dt=1e-3, time_order=2, tol=1e-11)
  jpre = jsem.dense_pressure_preconditioner(1e-3, 2)
  tpre = tsem.dense_pressure_preconditioner(1e-3, 2)
  assert jpre.has_nullspace and tpre.has_nullspace
  ju0, jp0 = jnp.asarray(u0), jnp.zeros(npn)
  ju, jp, jaux = jax.jit(lambda u, f: jsem.stokes_one_step(
      [u, u], [jp0, jp0], jsem.B(f), pressure_preconditioner=jpre, **kw))(
          ju0, jnp.asarray(f))
  tu0 = torch.as_tensor(u0)
  tp0 = torch.zeros(npn, dtype=torch.float64)
  tu, tp, taux = tsem.stokes_one_step(
      [tu0, tu0], [tp0, tp0], tsem.B(torch.as_tensor(f)),
      pressure_preconditioner=tpre, **kw)
  assert tu.shape == (nv, 2)
  np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-10)
  np.testing.assert_allclose(tp.numpy(), np.asarray(jp),
                             atol=1e-9 * float(np.abs(np.asarray(jp)).max()))
  assert (taux['u_star_info']['num_iterations']
          == int(jaux['u_star_info']['num_iterations']))

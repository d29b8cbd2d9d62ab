"""Programmatic cylinder-in-channel quad mesh (Schaefer-Turek geometry).

The port's own copy of ``swirlfem_tpu/utils/cylinder.py`` (pure numpy).

Builds an unstructured conforming quadrilateral premesh for the classical
flow-past-a-cylinder benchmark (Schaefer & Turek 1996: channel 2.2 x 0.41,
cylinder of radius 0.05 centered at (0.2, 0.2)) without any external mesh
generator: a butterfly O-grid ring around the cylinder (radially graded
toward the boundary layer) is glued into a channel block grid whose lines
conform to the ring's outer square.  Physical groups: ``cylinder``,
``inflow``, ``outflow``, ``walls``.

This exercises the framework's unstructured path end-to-end (the reference
reads comparable meshes from Gmsh files, ``common/mesh_reader.py:78``; here
the geometry is generated natively).  After p-refinement, call
`snap_cylinder_boundary` to project the refined boundary nodes onto the
true circle (the refiner interpolates element corners, which leaves a
polygonal O(h^2) geometry error on curved boundaries).
"""

from __future__ import annotations

import numpy as np

from swirlfem_tpu_torch.core.premesh import Premesh
from swirlfem_tpu_torch.core.quadrature import Nodes1D
from swirlfem_tpu_torch.core.quadrature import NodeType


def _segment(a: float, b: float, n: int) -> np.ndarray:
  return np.linspace(a, b, n + 1)


def cylinder_channel_premesh(
    radius: float = 0.05,
    center: tuple[float, float] = (0.2, 0.2),
    length: float = 2.2,
    height: float = 0.41,
    box_half_width: float = 0.1,
    ns: int = 4,
    nr: int = 3,
    nx_up: int = 1,
    nx_down: int = 10,
    ny_low: int = 1,
    ny_high: int = 1,
    radial_grading: float = 1.4,
) -> Premesh:
  """Order-1 premesh of a channel with a cylindrical hole.

  Args:
    ns: elements per side of the O-grid square (ring has 4*ns elements per
      layer and the hole square is an ns x ns block of the channel grid).
    nr: radial element layers in the ring.
    nx_up/nx_down/ny_low/ny_high: channel elements upstream/downstream/
      below/above the hole square.
    radial_grading: >1 clusters ring layers toward the cylinder wall.
  """
  cx, cy = center
  a = box_half_width
  assert radius < a < min(cx, cy, height - cy), 'hole square must fit'

  xs = np.concatenate([
      _segment(0.0, cx - a, nx_up)[:-1],
      _segment(cx - a, cx + a, ns)[:-1],
      _segment(cx + a, length, nx_down)])
  ys = np.concatenate([
      _segment(0.0, cy - a, ny_low)[:-1],
      _segment(cy - a, cy + a, ns)[:-1],
      _segment(cy + a, height, ny_high)])
  hole_i0, hole_j0 = nx_up, ny_low  # hole cell-index window start

  nodes: list[tuple[float, float]] = []
  index: dict[tuple[int, int], int] = {}

  def node_id(x: float, y: float) -> int:
    key = (int(round(x * 1e9)), int(round(y * 1e9)))
    if key not in index:
      index[key] = len(nodes)
      nodes.append((x, y))
    return index[key]

  def in_hole(i: int, j: int) -> bool:
    return (hole_i0 <= i < hole_i0 + ns) and (hole_j0 <= j < hole_j0 + ns)

  elements = []
  for i in range(len(xs) - 1):
    for j in range(len(ys) - 1):
      if in_hole(i, j):
        continue
      n00 = node_id(xs[i], ys[j])
      n01 = node_id(xs[i], ys[j + 1])
      n10 = node_id(xs[i + 1], ys[j])
      n11 = node_id(xs[i + 1], ys[j + 1])
      elements.append((n00, n01, n10, n11))  # lexicographic (x, y)

  # Square-hole perimeter, counterclockwise from the (cx-a, cy-a) corner.
  side = _segment(-a, a, ns)
  perim = []
  perim += [(cx + s, cy - a) for s in side[:-1]]          # bottom, +x
  perim += [(cx + a, cy + s) for s in side[:-1]]          # right, +y
  perim += [(cx - s, cy + a) for s in side[:-1]]          # top, -x
  perim += [(cx - a, cy - s) for s in side[:-1]]          # left, -y
  perim = np.asarray(perim)  # (4*ns, 2)

  # Ring layers: blend from the circle (t=0) to the square (t=1); graded
  # radial spacing clusters layers at the cylinder wall.
  theta = np.arctan2(perim[:, 1] - cy, perim[:, 0] - cx)
  circle = np.stack([cx + radius * np.cos(theta),
                     cy + radius * np.sin(theta)], axis=-1)
  ts = (np.arange(nr + 1) / nr) ** radial_grading
  ring_ids = np.empty((nr + 1, len(perim)), dtype=np.int64)
  for l, t in enumerate(ts):
    layer = (1.0 - t) * circle + t * perim
    for k, (x, y) in enumerate(layer):
      ring_ids[l, k] = node_id(float(x), float(y))

  npm = len(perim)
  for l in range(nr):
    for k in range(npm):
      kn = (k + 1) % npm
      # lexicographic (radial out, tangential ccw): positive jacobian.
      elements.append((ring_ids[l, k], ring_ids[l, kn],
                       ring_ids[l + 1, k], ring_ids[l + 1, kn]))

  node_coords = np.asarray(nodes)
  elements = np.asarray(elements, dtype=np.int32)

  def grid_edges(fixed_x=None, fixed_y=None):
    out = []
    if fixed_x is not None:
      for j in range(len(ys) - 1):
        out.append((node_id(fixed_x, ys[j]), node_id(fixed_x, ys[j + 1])))
    else:
      for i in range(len(xs) - 1):
        out.append((node_id(xs[i], fixed_y), node_id(xs[i + 1], fixed_y)))
    return out

  cylinder_edges = [(int(ring_ids[0, k]), int(ring_ids[0, (k + 1) % npm]))
                    for k in range(npm)]
  physical_groups = {
      'inflow': np.asarray(grid_edges(fixed_x=0.0), dtype=np.int32),
      'outflow': np.asarray(grid_edges(fixed_x=float(xs[-1])),
                            dtype=np.int32),
      'walls': np.asarray(grid_edges(fixed_y=0.0)
                          + grid_edges(fixed_y=float(ys[-1])),
                          dtype=np.int32),
      'cylinder': np.asarray(cylinder_edges, dtype=np.int32),
  }
  return Premesh.create(
      node_coords=node_coords,
      elements=elements,
      gridpoints_1d=Nodes1D.create(2, NodeType.NEWTON_COTES),
      physical_groups=physical_groups)


def _blend_to_circle(coords, corner_angles, radius, center, blend_radius):
  """Applies the blended polygon->circle correction to arbitrary points."""
  c = np.asarray(center)
  rel = coords - c
  rho = np.linalg.norm(rel, axis=-1)
  theta = np.arctan2(rel[:, 1], rel[:, 0])
  cang = np.sort(np.asarray(corner_angles))
  cang = np.concatenate([cang, [cang[0] + 2 * np.pi]])

  th = theta.copy()
  th[th < cang[0]] += 2 * np.pi
  seg = np.clip(np.searchsorted(cang, th, side='right') - 1, 0,
                len(cang) - 2)
  alpha, beta = cang[seg], cang[seg + 1]
  rho_chord = (radius * np.cos((beta - alpha) / 2)
               / np.cos(th - (alpha + beta) / 2))
  delta = radius - rho_chord

  in_ring = (rho > 0.5 * radius) & (rho < blend_radius)
  s = np.clip((rho - rho_chord) / (blend_radius - rho_chord), 0.0, 1.0)
  new_rho = np.where(in_ring, rho + (1.0 - s) * delta, rho)
  scale = np.where(rho > 0, new_rho / np.where(rho > 0, rho, 1.0), 1.0)
  return c + rel * scale[:, None]


def make_cylinder_snap(premesh, radius: float = 0.05,
                       center: tuple[float, float] = (0.2, 0.2),
                       blend_radius: float | None = None):
  """Geometry transform morphing the polygonal cylinder wall to the circle.

  Corner-interpolating p-refinement leaves the cylinder wall a polygon of
  chords (an O(h^2) geometry error); snapping only the wall nodes outward
  would bulge the boundary face *into* thin first-layer elements and
  invert them at quadrature points.  Instead the radial correction
  ``delta(theta) = radius - rho_chord(theta)`` is applied to every node in
  the ring with a linear decay in radius (Gordon-Hall-style transfinite
  blending): nodes on the polygon land exactly on the circle, the
  correction vanishes at `blend_radius` (the ring's outer square, so the
  channel-grid interface stays conforming), and the radial map stays
  monotonic — no tangling.

  The polygon corner angles come from the ORDER-1 premesh (its ring nodes
  lie exactly on the circle), so the returned transform applies to any
  refined premesh — in particular to BOTH the velocity (GLL) and pressure
  (interior GL) meshes.  Using it for only one space leaves D and D^T
  with mismatched geometry and a (slightly) nonsymmetric Schur operator.
  Pass as ``coord_transform`` to `StokesSEM.create`.
  """
  if blend_radius is None:
    blend_radius = 2.0 * radius
  coords1 = np.asarray(premesh.node_coords)
  c = np.asarray(center)
  rho1 = np.linalg.norm(coords1 - c, axis=-1)
  on_circle = np.abs(rho1 - radius) < 1e-9 * radius
  assert on_circle.any(), 'no order-1 nodes found on the cylinder'
  rel = coords1[on_circle] - c
  corner_angles = np.arctan2(rel[:, 1], rel[:, 0])

  def transform(refined_premesh):
    return _blend_to_circle(np.array(refined_premesh.node_coords),
                            corner_angles, radius, center, blend_radius)

  return transform


def snap_cylinder_boundary(premesh, radius: float = 0.05,
                           center: tuple[float, float] = (0.2, 0.2),
                           blend_radius: float | None = None):
  """Blended circle snap reading corner angles from the refined premesh.

  Prefer `make_cylinder_snap` (order-1-derived corners, applicable to the
  pressure mesh too); this variant needs the refined ``cylinder`` group.
  """
  if blend_radius is None:
    blend_radius = 2.0 * radius
  coords = np.array(premesh.node_coords)
  c = np.asarray(center)
  ids = np.unique(np.asarray(premesh.physical_groups['cylinder']))
  rel = coords[ids] - c
  rho = np.linalg.norm(rel, axis=-1)
  corner = ids[np.abs(rho - radius) < 1e-9 * radius]
  crel = coords[corner] - c
  corner_angles = np.arctan2(crel[:, 1], crel[:, 0])
  return _blend_to_circle(coords, corner_angles, radius, center,
                          blend_radius)

"""Premesh warps shared by the port's tests (numpy only: usable on a GPU
host without JAX, and on either package's premesh)."""

import numpy as np


def affine_box(pm):
  """The graded and sheared periodic cube of tests/test_pallas.py:384-392:
  every element stays a parallelepiped, the box is not separable."""
  c = np.asarray(pm.node_coords, dtype=np.float64).copy()
  c[:, 0] = c[:, 0] + 0.15 * c[:, 0] ** 2
  c[:, 1] = c[:, 1] + 0.10 * c[:, 1] ** 2
  c[:, 0] += 0.3 * c[:, 1] + 0.1 * c[:, 2]
  c[:, 1] += 0.2 * c[:, 2]
  return pm.replace(node_coords=c)

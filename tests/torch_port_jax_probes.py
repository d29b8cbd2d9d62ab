"""The JAX Schwarz builder's set-up, made cheap to run as an oracle.

``swirlfem_tpu.ops.schwarz`` applies E to each colour's probes through
``lax.map`` outside any jit (`_matvec64`), which traces and compiles it anew
for every colour, and rebuilds the Q1 element stiffness of the premesh
eagerly at each call (`_coarse_element_stiffness`, ~4 s on a small mesh
here).  `patched` swaps in `jitted_matvec64`, the same vmapped float64 E
compiled once per solver and probe shape, and a memo of the element
stiffness per premesh; the values are the JAX functions' own.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swirlfem_tpu.ops import schwarz as js

_CACHE = {}
_STIFFNESS = js._coarse_element_stiffness  # pylint: disable=protected-access


def jitted_matvec64(sem, dt, time_order):
  """The JAX package's `_matvec64` contract: ``(B, N_p)`` rows in and out."""
  key = ('E', id(sem), dt, time_order)
  if key not in _CACHE:
    _CACHE[key] = (sem, jax.jit(jax.vmap(
        lambda p: sem.E(p, dt=dt, time_order=time_order))))
  apply_e = _CACHE[key][1]
  return lambda ps: np.asarray(apply_e(jnp.asarray(ps, np.float64)))


def element_stiffness(premesh):
  """`_coarse_element_stiffness` of `premesh`, computed once."""
  key = ('Q1', id(premesh))
  if key not in _CACHE:
    _CACHE[key] = (premesh, _STIFFNESS(premesh))
  return _CACHE[key][1]


@contextlib.contextmanager
def patched():
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(js, '_matvec64', jitted_matvec64)
    mp.setattr(js, '_coarse_element_stiffness', element_stiffness)
    try:
      yield
    finally:
      _CACHE.clear()

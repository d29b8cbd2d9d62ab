"""Parity of the port's `cg` and `near_exact_solve` with ``swirlfem_tpu.linalg.cg``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.linalg import cg as jcg
from swirlfem_tpu_torch.linalg import cg as tcg
import torch_port_threads  # noqa: F401  pylint: disable=unused-import


def _spd(n, cond, seed, clusters=None):
  """SPD matrix with eigenvalues geomspace(1, cond) (or `clusters` values)."""
  rng = np.random.default_rng(seed)
  q, _ = np.linalg.qr(rng.standard_normal((n, n)))
  lam = (np.geomspace(1.0, cond, n) if clusters is None
         else np.resize(np.geomspace(1.0, cond, clusters), n))
  return (q * lam) @ q.T, rng.standard_normal(n)


def _block_ops(a):
  """A two-block operator on (x, y) tuples, in numpy-backed torch and jax."""
  h = a.shape[0] // 2
  ta, ja = torch.as_tensor(a), jnp.asarray(a)

  def tA(v):
    out = ta @ torch.cat(v)
    return (out[:h], out[h:])

  def jA(v):
    out = ja @ jnp.concatenate(v)
    return (out[:h], out[h:])

  return tA, jA, h


@pytest.mark.parametrize('case', ['plain', 'jacobi', 'euclidean',
                                  'checkpoint', 'tuple', 'x0', 'converge'])
def test_cg_matches_jax(case):
  """Same iterates: a fixed number of iterations (maxiter) on a spread
  spectrum, or convergence on a clustered one (CG's iteration count on a
  spread spectrum past ~n iterations depends on rounding)."""
  if case == 'converge':
    a, b = _spd(40, 1e3, seed=1, clusters=5)
    kw = dict(tol=1e-10)
  else:
    a, b = _spd(40, 1e8 if case == 'checkpoint' else 1e3, seed=len(case))
    kw = dict(tol=1e-14, maxiter=12)
  kw_t, kw_j = {}, {}
  if case == 'jacobi':
    d = np.diag(a).copy()
    kw_t['M'] = lambda r: r / torch.as_tensor(d)
    kw_j['M'] = lambda r: r / jnp.asarray(d)
  if case == 'euclidean':
    kw['euclidean_stop'] = True
  if case == 'checkpoint':
    # The true-residual checkpoints and the final best-iterate selection.
    kw['checkpoint_every'] = 4
  if case == 'x0':
    x0 = np.linalg.solve(a, b) + 1e-3
    kw_t['x0'], kw_j['x0'] = torch.as_tensor(x0), jnp.asarray(x0)
  if case == 'tuple':
    tA, jA, h = _block_ops(a)
    x, info = tcg.cg(tA, (torch.as_tensor(b[:h]), torch.as_tensor(b[h:])),
                     **kw)
    jx, jinfo = jcg.cg(jA, (jnp.asarray(b[:h]), jnp.asarray(b[h:])), **kw)
    x, jx = torch.cat(x).numpy(), np.concatenate([np.asarray(v) for v in jx])
  else:
    ta, ja = torch.as_tensor(a), jnp.asarray(a)
    x, info = tcg.cg(lambda v: ta @ v, torch.as_tensor(b), **kw, **kw_t)
    jx, jinfo = jcg.cg(lambda v: ja @ v, jnp.asarray(b), **kw, **kw_j)
    x = x.numpy()
  assert info['num_iterations'] == int(jinfo['num_iterations'])
  if case == 'converge':
    assert info['num_iterations'] <= 8  # 5 eigenvalue clusters + rounding
  else:
    assert info['num_iterations'] == 12
  np.testing.assert_allclose(x, np.asarray(jx), rtol=0,
                             atol=1e-10 * np.abs(jx).max())
  if case == 'converge':  # both at the rounding floor, below threshold
    assert float(info['residual']) <= 1e-20 * float(b @ b)
  else:
    np.testing.assert_allclose(float(info['residual']),
                               float(jinfo['residual']), rtol=1e-6)


@pytest.mark.parametrize('noise', [1e-3, 0.9])
def test_near_exact_solve_matches_jax(noise):
  """Richardson sweeps with a perturbed inverse, then the CG certificate.

  noise 0.9 makes a sweep fail its 4x contraction test."""
  a, b = _spd(30, 1e4, seed=7)
  rng = np.random.default_rng(8)
  inv = np.linalg.inv(a) @ (np.eye(30) + noise * rng.standard_normal(
      (30, 30)) / np.sqrt(30))
  ta, tinv = torch.as_tensor(a), torch.as_tensor(inv)
  ja, jinv = jnp.asarray(a), jnp.asarray(inv)
  x, info = tcg.near_exact_solve(lambda v: ta @ v, torch.as_tensor(b),
                                 lambda r: tinv @ r, tol=1e-10, maxiter=10)
  jx, jinfo = jcg.near_exact_solve(lambda v: ja @ v, jnp.asarray(b),
                                   lambda r: jinv @ r, tol=1e-10, maxiter=10)
  assert info['num_iterations'] == int(jinfo['num_iterations'])
  np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0,
                             atol=1e-10 * np.abs(jx).max())

"""Fischer's successive-rhs projection (`linalg.projection`) against the JAX
package's, in float64: guesses and histories through a round-robin wrap and
a skipped degenerate insert."""

import jax.numpy as jnp
import numpy as np
import torch

from swirlfem_tpu.linalg import projection as jproj
from swirlfem_tpu_torch.linalg import projection as tproj
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

N, K = 30, 4


def _spd(rng):
  q = rng.standard_normal((N, N))
  return q @ q.T + N * np.eye(N)


def _states_equal(js, ts):
  for name in ('xs', 'axs', 'valid'):
    a = np.asarray(getattr(js, name))
    b = getattr(ts, name).numpy()
    np.testing.assert_allclose(b, a, atol=1e-12 * max(1.0, np.abs(a).max()),
                               rtol=0)
  assert int(js.head) == int(ts.head)


def test_history_and_guesses_match_jax():
  rng = np.random.default_rng(15)
  a = _spd(rng)
  ja, ta = jnp.asarray(a), torch.as_tensor(a)
  js = jproj.ProjectionState.create(jnp.zeros(N), K)
  ts = tproj.ProjectionState.create(torch.zeros(N, dtype=torch.float64), K)
  _states_equal(js, ts)
  b_prev = None
  # Six inserts wrap the K = 4 history; the fourth repeats the third rhs,
  # whose increment is then rounding-level and must be skipped.
  for step in range(6):
    b = b_prev if step == 3 else rng.standard_normal(N)
    b_prev = b
    x = np.linalg.solve(a, b)
    jx0, jax0 = jproj.project_guess(js, jnp.asarray(b))
    tx0, tax0 = tproj.project_guess(ts, torch.as_tensor(b))
    np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), atol=1e-12,
                               rtol=0)
    np.testing.assert_allclose(tax0.numpy(), np.asarray(jax0), atol=1e-12,
                               rtol=0)
    head = int(ts.head)
    js = jproj.update_history(js, jnp.asarray(x), jx0, lambda v: ja @ v,
                              ax0=jax0)
    ts = tproj.update_history(ts, torch.as_tensor(x), tx0,
                              lambda v: ta @ v, ax0=tax0)
    _states_equal(js, ts)
    if step == 3:
      assert int(ts.head) == head, 'the degenerate insert was not skipped'
    else:
      assert int(ts.head) == head + 1
  assert int(ts.head) == 5 and float(ts.valid.sum()) == K
  # The history is A-orthonormal, and the guess of a rhs in its span is
  # exact.
  xs = ts.xs.numpy()
  np.testing.assert_allclose(xs @ a @ xs.T, np.eye(K), atol=1e-10)
  b = a @ xs[1]
  x0, ax0 = tproj.project_guess(ts, torch.as_tensor(b))
  np.testing.assert_allclose(x0.numpy(), xs[1], atol=1e-10)
  np.testing.assert_allclose(ax0.numpy(), b, atol=1e-9)


def test_custom_dot_and_matrix_state_match_jax():
  """A state shaped like the velocity, ``(N, 2)``, and a dot given by the
  caller (the loop over the history rather than one product)."""
  rng = np.random.default_rng(16)
  a = _spd(rng)
  dot = lambda u, v: (u * v).sum()
  js = jproj.ProjectionState.create(jnp.zeros((N // 2, 2)), 3)
  ts = tproj.ProjectionState.create(
      torch.zeros((N // 2, 2), dtype=torch.float64), 3)
  matj = lambda v: (jnp.asarray(a) @ v.reshape(-1)).reshape(v.shape)
  matt = lambda v: (torch.as_tensor(a) @ v.reshape(-1)).reshape(v.shape)
  for _ in range(4):
    b = rng.standard_normal((N // 2, 2))
    x = np.linalg.solve(a, b.reshape(-1)).reshape(b.shape)
    jx0, jax0 = jproj.project_guess(js, jnp.asarray(b), dot)
    tx0, tax0 = tproj.project_guess(ts, torch.as_tensor(b), dot)
    np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), atol=1e-12)
    js = jproj.update_history(js, jnp.asarray(x), jx0, matj, dot, ax0=jax0)
    ts = tproj.update_history(ts, torch.as_tensor(x), tx0, matt, dot,
                              ax0=tax0)
    _states_equal(js, ts)

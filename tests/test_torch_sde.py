"""The port's SDE integrator and its adjoint against the JAX package.

Counterparts of ``tests/test_sde.py:15-131`` on the same Brownian
increments (the JAX package's draws passed in), in float64: paths within
1e-12 of `swirlfem_tpu.sde.sdeint` (and within the scheme's error of the
exact solutions), adjoint gradients within 1e-10 of the JAX adjoint and
within 1e-2 of central differences (the adjoint integrates the
continuous-time adjoint SDE, O(dt) from the discrete gradient).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from swirlfem_tpu.sde import flax_sde as jflax_sde
from swirlfem_tpu.sde import sdeint as jsde
from swirlfem_tpu_torch.sde.nn_sde import NNSDE
from swirlfem_tpu_torch.sde.sdeint import brownian_path
from swirlfem_tpu_torch.sde.sdeint import sdeint
import torch_port_threads  # noqa: F401  pylint: disable=unused-import


def _t(x):
  return torch.tensor(np.asarray(x))


def test_brownian_path_statistics():
  g = torch.Generator().manual_seed(0)
  dw = brownian_path(64, (2000,), generator=g, dtype=torch.float64)
  assert dw.shape == (64, 2000)
  w1 = dw.sum(0)
  assert abs(float(w1.mean())) < 0.1 and abs(float(w1.var()) - 1.0) < 0.1


def test_deterministic_exponential_decay():
  dw = np.zeros(256)
  ys = sdeint(lambda y, t, d: (-y, 0.0 * d * y), torch.tensor(1.0,
              dtype=torch.float64), (0.0, 1.0), _t(dw))
  want = jsde.sdeint(lambda y, t, d: (-y, 0.0 * d * y), 1.0, (0.0, 1.0),
                     jnp.asarray(dw))
  np.testing.assert_allclose(ys.numpy(), np.asarray(want), rtol=1e-12)
  np.testing.assert_allclose(float(ys[-1]), np.exp(-1.0), atol=1e-2)


def test_intermediate_outputs():
  dw = np.zeros(256)
  ts = (0.0, 0.25, 0.5, 0.75, 1.0)
  ys = sdeint(lambda y, t, d: (-y, 0.0 * d * y),
              torch.tensor(1.0, dtype=torch.float64), ts, _t(dw))
  want = jsde.sdeint(lambda y, t, d: (-y, 0.0 * d * y), 1.0, ts,
                     jnp.asarray(dw))
  assert ys.shape == (4,)
  np.testing.assert_allclose(ys.numpy(), np.asarray(want), rtol=1e-12)
  np.testing.assert_allclose(ys.numpy(), np.exp(-np.array(ts[1:])),
                             atol=1e-2)


def test_geometric_bm_pathwise():
  """Stratonovich GBM: y = exp(mu t + s W_t), on the JAX package's paths
  (all 200 integrated at once as one batched state)."""
  n, paths, mu, s = 512, 200, 0.3, 0.4
  keys = jax.random.split(jax.random.PRNGKey(0), paths)
  dw = np.stack([np.asarray(jsde.brownian_path(k, n, dtype=jnp.float64))
                 for k in keys], axis=1)                  # (n, paths)
  f = lambda y, t, d: (mu * y, s * y * d)
  got = sdeint(f, torch.ones(paths, dtype=torch.float64), (0.0, 1.0),
               _t(dw))[-1].numpy()
  want = np.asarray(jax.vmap(lambda d: jsde.sdeint(
      f, 1.0, (0.0, 1.0), d)[-1])(jnp.asarray(dw.T)))
  np.testing.assert_allclose(got, want, rtol=1e-12)
  np.testing.assert_allclose(got, np.exp(mu + s * dw.sum(0)), rtol=0.05)


def test_adjoint_gradient_in_an_argument():
  n = 128
  dw = np.asarray(jsde.brownian_path(jax.random.PRNGKey(1), n,
                                     dtype=jnp.float64))
  f = lambda y, t, d, theta: (theta * y, 0.3 * y * d)

  def jloss(theta):
    return jsde.sdeint(f, 1.0, (0.0, 1.0), jnp.asarray(dw), theta)[-1] ** 2

  def loss(theta):
    return sdeint(f, torch.tensor(1.0, dtype=torch.float64), (0.0, 1.0),
                  _t(dw), theta)[-1] ** 2

  theta = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
  loss(theta).backward()
  want = float(jax.grad(jloss)(0.5))
  assert abs(float(theta.grad) - want) <= 1e-10 * abs(want)
  eps = 1e-5
  fd = (float(loss(torch.tensor(0.5 + eps, dtype=torch.float64)))
        - float(loss(torch.tensor(0.5 - eps, dtype=torch.float64)))) / (
            2 * eps)
  np.testing.assert_allclose(float(theta.grad), fd, rtol=1e-2)


def test_adjoint_gradient_wrt_y0():
  n = 128
  dw = np.asarray(jsde.brownian_path(jax.random.PRNGKey(2), n,
                                     dtype=jnp.float64))
  f = lambda y, t, d: (-y, 0.2 * y * d)
  y0 = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
  sdeint(f, y0, (0.0, 1.0), _t(dw))[-1].backward()
  want = float(jax.grad(lambda y: jsde.sdeint(
      f, y, (0.0, 1.0), jnp.asarray(dw))[-1])(1.3))
  assert abs(float(y0.grad) - want) <= 1e-10 * abs(want)
  eps = 1e-5
  fd = (float(sdeint(f, torch.tensor(1.3 + eps, dtype=torch.float64),
                     (0.0, 1.0), _t(dw))[-1])
        - float(sdeint(f, torch.tensor(1.3 - eps, dtype=torch.float64),
                       (0.0, 1.0), _t(dw))[-1])) / (2 * eps)
  np.testing.assert_allclose(float(y0.grad), fd, rtol=1e-2)


def test_dict_state():
  dw = np.zeros(64)
  f = lambda y, t, d: ({'a': -y['a'], 'b': 2 * torch.ones_like(y['b'])},
                       {'a': 0.0 * y['a'] * d, 'b': 0.0 * y['b'] * d})
  y0 = {'a': torch.tensor(1.0, dtype=torch.float64),
        'b': torch.zeros(3, dtype=torch.float64)}
  ys = sdeint(f, y0, (0.0, 1.0), _t(dw))
  np.testing.assert_allclose(float(ys['a'][-1]), np.exp(-1.0), atol=1e-2)
  np.testing.assert_allclose(ys['b'][-1].numpy(), 2.0, atol=1e-9)


class _JDynamics(fnn.Module):
  @fnn.compact
  def __call__(self, y, t, dw):
    theta = self.param('theta', fnn.initializers.constant(-0.8), ())
    return theta * y, 0.1 * y * dw


class _Dynamics(nn.Module):

  def __init__(self):
    super().__init__()
    self.theta = nn.Parameter(torch.tensor(-0.8, dtype=torch.float64))

  def forward(self, y, t, dw):
    return self.theta * y, 0.1 * y * dw


def test_nn_sde_parameter_gradient_matches_jax():
  dw = np.asarray(jsde.brownian_path(jax.random.PRNGKey(3), 64,
                                     dtype=jnp.float64))
  jmodel = jflax_sde.nn_sdeint(_JDynamics)()
  params = jmodel.init(jax.random.PRNGKey(4), jnp.asarray(1.0), (0.0, 1.0),
                       jnp.asarray(dw))
  want_y = jmodel.apply(params, jnp.asarray(1.0), (0.0, 1.0),
                        jnp.asarray(dw))
  want = jax.grad(lambda p: jmodel.apply(
      p, jnp.asarray(1.0), (0.0, 1.0), jnp.asarray(dw))[-1])(params)
  model = NNSDE(_Dynamics())
  y = model(torch.tensor(1.0, dtype=torch.float64), (0.0, 1.0), _t(dw))
  assert y.shape == (1,)
  np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                             rtol=1e-12)
  y[-1].backward()
  got = float(model.dynamics.theta.grad)
  w = float(want['params']['theta'])
  assert abs(w) > 1e-3 and abs(got - w) <= 1e-10 * abs(w)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_batched_adjoint_equals_per_sample(dtype):
  """A batch integrated as one state gives each sample's own path and
  gradients (the model integrates its samples together)."""
  g = torch.Generator().manual_seed(1)
  dw = brownian_path(32, (3,), generator=g, dtype=dtype)
  theta = torch.tensor(0.4, dtype=dtype, requires_grad=True)
  f = lambda y, t, d: (-theta * y * y, 0.3 * torch.cos(y) * d)
  y0 = torch.tensor([0.5, 1.0, -0.7], dtype=dtype, requires_grad=True)
  out = sdeint(f, y0, (0.0, 1.0), dw, params=(theta,))[-1]
  gy, gt = torch.autograd.grad(out.sum(), (y0, theta))
  gts = []
  for i in range(3):
    yi = y0.detach()[i].clone().requires_grad_()
    oi = sdeint(f, yi, (0.0, 1.0), dw[:, i], params=(theta,))[-1]
    gyi, gti = torch.autograd.grad(oi, (yi, theta))
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert abs(float(oi) - float(out[i].detach())) <= tol
    assert abs(float(gyi) - float(gy[i])) <= tol * max(1, abs(float(gyi)))
    gts.append(float(gti))
  assert abs(sum(gts) - float(gt)) <= (1e-10 if dtype == torch.float64
                                       else 1e-4) * abs(float(gt))

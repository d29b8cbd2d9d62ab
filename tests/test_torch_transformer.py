"""The port's closure model against the JAX package's flax model.

Flax-initialised parameters (perturbed by seeded noise so that the
zero-initialised heads carry signal) go through
`interop.transformer_params_from_flax`; both models run on the same
inputs with the JAX package's draws passed in, in float32, at the tiny
configuration (4x4 elements, width 8, depth 4): outputs and every aux
within 2e-5 relative to their largest entry.  Covered: the latent-SDE
path, the ODE path (one sample), the MLP processor and no processor.  A
missing, extra or misshapen parameter is refused.

At the configuration's own 'bfloat16' (CPU autocast here), the port is
held to the flax bfloat16 model within 5e-2 relative, and its rounding
region to flax's: every module flax runs with ``dtype=bfloat16`` (the
encoder and decoder blocks and their dense layers) must come out more than
1e-4 relative from its float32 rerun on the same inputs, and every other
module (embedding, positional embeddings, the two stack norms, the SDE
processor, the output head) within 1e-6 of it.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.niles import train as jtrain
from swirlfem_tpu_torch import interop
from swirlfem_tpu_torch.models import transformer
from swirlfem_tpu_torch.niles import train

from torch_niles_configs import jax_draws
from torch_niles_configs import jax_tiny_config
from torch_niles_configs import perturbed
from torch_niles_configs import torch_tiny_config
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

TOL = 2e-5
BF16_TOL = 5e-2  # two bfloat16 models whose rounding points differ
ROUNDS, EXACT = 1e-4, 1e-6
F32 = {'model.dtype': 'float32'}
CASES = {
    'sde': {},
    'ode': {'model.processor_config.num_samples': 1},
    'mlp': {'model.processor_config.use_transformer': False},
    'none': {'model.processor_config.num_samples': 0,
             'model.mean_after_decoder': False},
}


@functools.lru_cache(maxsize=None)
def _models(case):
  fields = {**F32, **CASES[case]}
  jcfg = jax_tiny_config(**fields)
  jmodel = jtrain.create_model(jcfg.model_name, jcfg.model)
  x = jnp.ones((1, jcfg.num_elements, jcfg.num_channels), jnp.float32)
  with jax.enable_x64(False):  # the flax model runs in float32
    params = perturbed(jax.jit(jmodel.init)(
        {'params': jax.random.PRNGKey(0)}, x,
        jax.random.PRNGKey(1))['params'])
  model = train.create_model(torch_tiny_config(**fields))
  interop.transformer_params_from_flax(params, model)
  return jcfg, jmodel, params, model


def _rel(got, want):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize('case', list(CASES))
def test_model_matches_flax(case):
  jcfg, jmodel, params, model = _models(case)
  x = np.random.default_rng(1).standard_normal(
      (3, jcfg.num_elements, jcfg.num_channels)).astype(np.float32)
  rng = jax.random.PRNGKey(2)
  with jax.enable_x64(False):
    want, want_aux = jax.jit(jmodel.apply)({'params': params},
                                           jnp.asarray(x), rng)
    draws = jax_draws(jcfg, rng, 3, model.tok_shape[0]
                      if hasattr(model, 'tok_shape') else 0)
  with torch.no_grad():
    got, aux = model(torch.tensor(x), draws=draws)
  assert got.shape == x.shape
  assert _rel(got.numpy(), want) <= TOL, _rel(got.numpy(), want)
  assert np.abs(np.asarray(want)).max() > 1e-3  # the head carries signal
  for key in transformer.AUX_KEYS:
    assert aux[key].shape == (3,), key
    w = np.asarray(want_aux[key])
    if np.abs(w).max() == 0:
      assert float(aux[key].abs().max()) == 0, key
    else:
      assert _rel(aux[key].numpy(), w) <= TOL, (key, _rel(aux[key].numpy(),
                                                         w))


def test_gradients_flow_through_the_sde():
  """The adjoint carries gradients to the processor and the encoder."""
  _, _, _, model = _models('sde')
  x = torch.randn(2, 16, 18, generator=torch.Generator().manual_seed(0))
  out, aux = model(x, generator=torch.Generator().manual_seed(1))
  (out.square().sum() + aux['kl_path'].sum()).backward()
  grads = {name: p.grad for name, p in model.named_parameters()}
  for prefix in ('LatentSDE_0.sde.dynamics.post_block_0',
                 'multiscale_encoder.block_0', 'embedding'):
    g = [v for k, v in grads.items() if k.startswith(prefix)]
    assert g and all(v is not None for v in g), prefix
    assert max(float(v.abs().max()) for v in g) > 0, prefix
  model.zero_grad()


def test_flax_tree_must_match_the_model():
  _, _, params, model = _models('sde')
  state = {k: v.clone() for k, v in model.state_dict().items()}
  extra = dict(params, stray={'kernel': np.zeros((2, 2), np.float32)})
  with pytest.raises(ValueError, match='no counterpart'):
    interop.transformer_params_from_flax(extra, model)
  missing = {k: v for k, v in params.items() if k != 'decoded_patches'}
  with pytest.raises(ValueError, match='lacks'):
    interop.transformer_params_from_flax(missing, model)
  bad = dict(params, embedding={'kernel': np.zeros((3, 8), np.float32),
                                'bias': params['embedding']['bias']})
  with pytest.raises(ValueError, match='shape'):
    interop.transformer_params_from_flax(bad, model)
  for k, v in model.state_dict().items():
    assert torch.equal(v, state[k]), k


@pytest.mark.parametrize('n', [7, 16, 36, 144])
def test_pooling_matches_flax(n):
  """SAME padding puts the low pad at total // 2; the average counts it."""
  import flax.linen as fnn
  x = np.random.default_rng(n).standard_normal((2, n, 4))
  for mode, pool in (('avg', fnn.avg_pool), ('max', fnn.max_pool)):
    want = pool(jnp.asarray(x), (1, 5), (1, 4), padding='same')
    got = transformer.pooled_heads(torch.tensor(x), (1, 5), (1, 4), mode, 2)
    np.testing.assert_allclose(got.flatten(-2).numpy(), np.asarray(want),
                               rtol=1e-14, atol=1e-14, err_msg=mode)


def _flax_module_dtypes(jmodel, params, x, rng):
  """{path: the module's compute dtype} for every flax module call."""
  seen = {}

  def record(next_fun, args, kwargs, context):
    if context.method_name == '__call__':
      seen[context.module.scope.path] = getattr(context.module, 'dtype', None)
    return next_fun(*args, **kwargs)

  with jax.enable_x64(False), fnn.intercept_methods(record):
    jax.eval_shape(jmodel.apply, {'params': params}, x, rng)
  return seen


def test_bfloat16_model_matches_flax_and_rounds_where_flax_does():
  jcfg = jax_tiny_config()
  assert jcfg.model.dtype == 'bfloat16'
  jmodel = jtrain.create_model(jcfg.model_name, jcfg.model)
  _, _, params, _ = _models('sde')
  model = train.create_model(torch_tiny_config())
  interop.transformer_params_from_flax(params, model)
  x = np.random.default_rng(1).standard_normal(
      (3, jcfg.num_elements, jcfg.num_channels)).astype(np.float32)
  rng = jax.random.PRNGKey(2)
  with jax.enable_x64(False):
    want, want_aux = jax.jit(jmodel.apply)({'params': params},
                                           jnp.asarray(x), rng)
    draws = jax_draws(jcfg, rng, 3, model.tok_shape[0])
  dtypes = _flax_module_dtypes(jmodel, params, jnp.asarray(x), rng)

  # The port's modules at flax's paths: the top level, the blocks and
  # norms of both stacks, and the dense layers inside the blocks.  (Layer
  # norms inside a block stay float32 under autocast; the dense layer that
  # reads one rounds its input where flax rounds the norm's output.)
  names = {}
  for path, dt in dtypes.items():
    name = '.'.join(path)
    if len(path) == 1 and not name.startswith('multiscale'):
      names[name] = dt == jnp.bfloat16
    elif len(path) > 1 and name.startswith('multiscale') and (
        len(path) == 2 or isinstance(model.get_submodule(name),
                                     torch.nn.Linear)):
      names[name] = dt == jnp.bfloat16
  rounding = sorted(n for n, r in names.items() if r)
  assert {'embedding', 'encoder_posembed', 'LatentSDE_0',
          'multiscale_encoder.encoder_norm', 'multiscale_decoder.decoder_norm',
          'decoded_patches'} == set(names) - set(rounding)
  assert len([n for n in rounding if n.count('.') == 1]) == 8  # the blocks

  captured = {}
  hooks = [model.get_submodule(n).register_forward_hook(
      lambda m, args, out, n=n: captured.setdefault(n, []).append((args, out)))
           for n in names]
  with torch.no_grad():
    got, aux = model(torch.tensor(x), draws=draws)
  for h in hooks:
    h.remove()

  assert got.dtype == torch.float32
  assert _rel(got.numpy(), want) <= BF16_TOL, _rel(got.numpy(), want)
  for key in transformer.AUX_KEYS:
    assert aux[key].dtype == torch.float32, key
    w = np.asarray(want_aux[key])
    assert _rel(aux[key].numpy(), w) <= BF16_TOL, (key, _rel(
        aux[key].numpy(), w))

  def flat(out):
    if isinstance(out, torch.Tensor):
      return [out]
    if isinstance(out, dict):
      return [out[k] for k in sorted(out)]
    return [t for o in out for t in flat(o)]

  def as_f32(a):
    if isinstance(a, torch.Tensor) and a.is_floating_point():
      return a.float()
    return a

  for name, rounds in names.items():
    module = model.get_submodule(name)
    errs = []
    for args, out in captured[name]:
      with torch.no_grad():
        rerun = module(*(as_f32(a) for a in args))
      errs.append(max(_rel(a.float().numpy(), b.numpy()) for a, b in
                      zip(flat(out), flat(rerun)) if b.abs().max() > 0))
    err = max(errs)
    if rounds:
      assert err > ROUNDS, (name, err)
    else:
      assert err <= EXACT, (name, err)

"""The tiny NiLES configuration of ``tests/test_niles.py:tiny_config`` for
both packages: 4x4 elements, order 2, width 8, depth 4, two SDE samples.

`TINY` lists its fields once: the port's `config.tiny_fields`.
`jax_tiny_config` sets them on the JAX package's ml_collections config,
`torch_tiny_config` on the port's dataclass config.  `jax_draws` recomputes
the JAX model's SDE draws from its key, `perturbed` gives a flax tree
signal in its zero-initialised heads.
"""

import functools

import jax
import jax.numpy as jnp
import ml_collections
import numpy as np

from swirlfem_tpu.sde.sdeint import brownian_path as jbrownian_path

from swirlfem_tpu.niles import config as jax_config
from swirlfem_tpu_torch.niles import config as torch_config

TINY = torch_config.tiny_fields()


def apply(cfg, fields):
  """Sets dotted `fields` on a config (ConfigDict or dataclass)."""
  for key, value in fields.items():
    *parents, leaf = key.split('.')
    target = cfg
    for name in parents:
      target = getattr(target, name)
    setattr(target, leaf, value)
  return cfg


def jax_tiny_config(**fields):
  """``tests/test_niles.py:tiny_config``, then `fields`, frozen."""
  cfg = apply(jax_config.get_config(), TINY)
  return ml_collections.FrozenConfigDict(apply(cfg, fields))


def torch_tiny_config(**fields):
  return apply(apply(torch_config.get_config(), TINY), fields)


def perturbed(params, seed=0, scale=0.05):
  rng = np.random.default_rng(seed)
  return jax.tree.map(
      lambda x: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(
          np.float32), params)


def jax_draws(cfg, rng, batch_size, seq_len):
  """The draws `swirlfem_tpu.models.transformer.LatentSDE` makes from
  `rng` (its key arithmetic, :538-541 and :569-580), as numpy arrays."""
  pc = cfg.model.processor_config
  if pc.num_samples <= 0 or (pc.use_transformer and pc.num_samples <= 1):
    return None
  expanded = batch_size * pc.num_samples
  if not pc.use_transformer:
    keys = jax.random.split(rng, expanded * pc.latent_size)
    dw = jax.vmap(functools.partial(jbrownian_path, n=pc.num_gridpoints),
                  out_axes=-1)(keys).reshape(expanded, pc.num_gridpoints, -1)
    return {'dw': np.array(dw)}
  width = seq_len * pc.latent_size
  z0_rng, dw_rng = jax.random.split(rng)
  noise = jax.random.normal(z0_rng, (batch_size, pc.num_samples, width),
                            jnp.float32)
  keys = jax.random.split(dw_rng, expanded * width)
  dw = jax.vmap(functools.partial(jbrownian_path, n=pc.num_gridpoints),
                out_axes=-1)(keys).reshape(expanded, pc.num_gridpoints, width)
  return {'noise': np.array(noise), 'dw': np.array(dw)}

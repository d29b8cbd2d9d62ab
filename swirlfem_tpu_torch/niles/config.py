"""Hyperparameter configuration for the NiLES training pipeline.

Counterpart of ``swirlfem_tpu/niles/config.py`` (get_config :12-120,
metrics, sweep) with the same fields and defaults: the 12x12-element
order-4 Re 20,000 Kolmogorov closure task with 8-step differentiable
rollouts.  Plain mutable dataclasses take the place of
``ml_collections.ConfigDict`` (the port needs no ml_collections): fields
are set by attribute, derived fields are computed once in `get_config`, as
there, and `get` reads a field with a default.
"""

from __future__ import annotations

import dataclasses


class _Get:
  """``cfg.get(name, default)``, as on a ConfigDict."""

  def get(self, name: str, default=None):
    return getattr(self, name, default)


@dataclasses.dataclass
class ProcessorConfig(_Get):
  """The latent-SDE processor; ``num_samples = 0`` disables it."""
  num_samples: int = 4
  use_transformer: bool = True
  data_size: int = 48 * 4 * 9
  latent_size: int = 48 * 4
  num_gridpoints: int = 16
  num_sde_layers: int = 4
  num_layers: int = 2
  context_size: int = 32
  hidden_size: int = 32
  prior_scale: float = 0.1


@dataclasses.dataclass
class ModelConfig(_Get):
  width: int = 48
  # 'bfloat16' runs the encoder and decoder blocks under torch.autocast
  # (parameters, LayerNorm statistics and the solver stay float32).
  dtype: str = 'bfloat16'
  num_layers: int = 6
  num_heads: int = 4
  use_residuals: bool = True
  freeze_encoder: bool = False
  depth: int = 6
  num_initial_heads: int = 1
  pooling_layers: tuple = (2, 4)
  pooling_kernel: tuple = (1, 5)
  initial_kv_pooling_strides: tuple = (1, 4)
  pooling_strides_q: tuple = (1, 4)
  qkv_tile_reps: tuple = (4, 1)
  mean_after_decoder: bool = True
  processor_config: ProcessorConfig = dataclasses.field(
      default_factory=ProcessorConfig)


@dataclasses.dataclass
class Config(_Get):
  """The training configuration (field meanings as in the JAX package)."""
  batch_size: int = 128
  debug: bool = False  # True => synthetic dataset for fast iteration.
  num_steps: int = 8
  eval_num_steps: int = 125
  permute_elements: bool = True
  num_pushforward_steps: int = 7
  # Recompute each rollout step in the backward pass
  # (torch.utils.checkpoint): peak activation memory O(1) rollout steps.
  remat: bool = False
  model_name: str = 'multiscale_transformer'
  model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
  window_step: int = 1
  dataset: str = 'kolmogorov_flow'
  dataset_dir: str = ''
  ndim: int = 2
  element_grid_size: int = 12
  order: int = 4
  resolution: int = 48
  time_order: int = 3
  # The JAX package keeps 0.04 (its reference's training value) against
  # 0.05 in the datagen config; set it to the datagen's when training on
  # the port's own frames.
  drag_coeff: float = 0.04
  forcing_wavenumber: float = 4.0
  reynolds_number: float = 20000
  dt: float = 1e-3
  alpha: float = 0.0
  num_nodes: int = 49 ** 2
  num_elements: int = 144
  num_channels: int = 50
  train_window_size: int = 11
  train_window_stride: int = 1
  eval_window_size: int = 128
  eval_window_stride: int = 4
  seed: int = 0
  # Weight of the squared log-spectrum mismatch in the training loss.
  spectrum_loss_weight: float = 0.0
  num_epochs: float = 15.0
  learning_rate: float = 0.0075
  grad_clip_norm: float | None = 0.01
  weight_decay: float = 0.05
  warmup_epochs: float = 1.0
  kl_penalty: float = 0.01
  kl_transition_epochs: float = 10.0
  kl_zero_epochs: float = 0
  log_every_steps: int = 100
  checkpoint_epochs: float = 1
  eval_every_epochs: float = 0.1
  cache: bool = True
  profile_dir: str = ''  # set to capture profiler trace windows
  num_train_steps: int = -1
  steps_per_eval: int = 10
  # Also evaluate the zero-forcing (no-model) rollout on each eval batch.
  eval_baseline: bool = False


def get_config() -> Config:
  """Default hyperparameters, the derived fields computed as in the JAX
  package's `get_config`."""
  cfg = Config()
  cfg.num_pushforward_steps = cfg.num_steps - 1
  m = cfg.model
  m.pooling_layers = (m.depth - 4, m.depth - 2)
  pc = m.processor_config
  m.mean_after_decoder = pc.num_samples > 0
  pc.data_size = m.width * 4 * 9
  pc.latent_size = m.width * 4
  cfg.resolution = cfg.element_grid_size * cfg.order
  cfg.dt = 1e-3 * cfg.window_step
  cfg.num_nodes = (cfg.resolution + 1) ** 2
  cfg.num_elements = cfg.element_grid_size ** 2
  cfg.num_channels = (cfg.order + 1) ** 2 * cfg.ndim
  cfg.train_window_size = (cfg.num_steps + 3) * cfg.window_step
  cfg.eval_window_size = (cfg.eval_num_steps + 3) * cfg.window_step
  return cfg


def set_fields(cfg, fields: dict):
  """Sets `fields` (dotted names, ``{'model.width': 32}``) on `cfg`; an
  unknown name raises `KeyError`.  Returns `cfg`."""
  for key, value in fields.items():
    *parents, leaf = key.split('.')
    target = cfg
    for name in parents:
      target = getattr(target, name)
    if not hasattr(target, leaf):
      raise KeyError(f'unknown config field {key!r}')
    setattr(target, leaf, value)
  return cfg


def tiny_fields() -> dict:
  """The fields of the JAX package's ``tests/test_niles.py:tiny_config``
  (4x4 elements, order 2, width 8, depth 4, two SDE samples), for
  `set_fields` on `get_config()`: the smallest configuration that runs the
  whole training step, for tests and smoke runs."""
  return {
      'debug': True, 'batch_size': 2, 'num_steps': 2, 'eval_num_steps': 2,
      'num_pushforward_steps': 1, 'permute_elements': False,
      'element_grid_size': 4, 'order': 2, 'resolution': 8, 'time_order': 2,
      'num_nodes': 81, 'num_elements': 16, 'num_channels': 18,
      'train_window_size': 5, 'eval_window_size': 5,
      'model.width': 8, 'model.depth': 4, 'model.pooling_layers': (1, 3),
      'model.pooling_kernel': (1, 5),
      'model.initial_kv_pooling_strides': (1, 4),
      'model.pooling_strides_q': (1, 4), 'model.qkv_tile_reps': (4, 1),
      'model.processor_config.num_samples': 2,
      'model.processor_config.latent_size': 32,
      'model.processor_config.data_size': 32,
      'model.processor_config.num_gridpoints': 4,
      'model.processor_config.num_sde_layers': 1,
      'model.processor_config.hidden_size': 8,
      'model.mean_after_decoder': True,
  }


def metrics() -> list[str]:
  return [
      'steps_per_second',
      'train_learning_rate',
      'train_kl_penalty',
      'train_loss',
      'train_mse',
      'train_z0_means',
      'train_z1_means',
      'train_z1_stds',
      'eval_loss',
      'eval_mse',
      'eval_mse@1to8',
      'eval_mse@8',
      'eval_mse@16',
      'eval_mse@32',
      'eval_z0_means',
      'eval_z1_means',
      'eval_z1_stds',
      'eval_tke_err',
  ]


def sweep(add):
  """Hyperparameter search over encoder depth."""
  for depth in [36, 40, 48]:
    add(**{'model.depth': depth,
           'model.pooling_layers': (depth - 4, depth - 2)})

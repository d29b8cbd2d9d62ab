"""Datagen hyperparameter configs.

Counterpart of ``swirlfem_tpu/niles/datagen_config.py``: the Kolmogorov DNS
generation settings, with a seed sweep for ensemble generation.  Returns the
`DatagenConfig` dataclass directly (no ml_collections dependency).
"""

from swirlfem_tpu_torch.niles.datagen import DatagenConfig


def get_config() -> DatagenConfig:
  return DatagenConfig(resolution=64, order=8, time_order=3,
                       reynolds_number=20000.0, num_cycles=500,
                       num_steps_per_cycle=500, dt=1e-4, drag_coeff=0.05,
                       forcing_wavenumber=4.0, snapshot_every=10,
                       split='train', seed=0)


def sweep(add):
  """Ensemble sweep over initial seeds."""
  for seed in range(32):
    add(seed=seed)

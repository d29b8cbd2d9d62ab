"""An SDE whose drift and diffusion are an `nn.Module`.

Counterpart of ``swirlfem_tpu/sde/flax_sde.py`` (`nn_sdeint`, the flax
lifted transform): `NNSDE` owns a dynamics module
``dynamics(y, t, dw_step, *args) -> (drift, diffusion o dW)`` and integrates
it with `sde.sdeint.sdeint`, so that the module's parameters receive their
gradients through the adjoint SDE.  Torch modules create their parameters
eagerly, so the flax version's init-time dummy output has no counterpart.
"""

from __future__ import annotations

from torch import nn

from swirlfem_tpu_torch.sde.sdeint import sdeint


class NNSDE(nn.Module):
  """``NNSDE(dynamics)(y0, ts, dw, *args)``: the states at ``ts[1:]``."""

  def __init__(self, dynamics: nn.Module):
    super().__init__()
    self.dynamics = dynamics

  def forward(self, y0, ts, dw, *args):
    return sdeint(self.dynamics, y0, ts, dw, *args,
                  params=tuple(self.dynamics.parameters()))

"""Successive-rhs projection: initial guesses from prior solve history.

Counterpart of ``swirlfem_tpu/linalg/projection.py`` (Fischer, "Projection
techniques for iterative solution of Ax = b with successive right-hand
sides", CMAME 1998): keep an A-orthonormal basis of the last K solution
increments; for a new rhs ``b`` the A-optimal initial guess in that
subspace is ``x0 = sum_i <x_i, b> x_i``, and CG only solves for the
remainder.  The basis lives in a fixed-size `ProjectionState` (round-robin
replacement) whose flags and write slot are device tensors, so an update
reads nothing back to the host.  An initial guess changes the CG path, not
its limit, so the converged solution (and its gradient through
`linalg.linear_solve`) is unaffected.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from swirlfem_tpu_torch.linalg.cg import vdot


@dataclasses.dataclass(frozen=True)
class ProjectionState:
  """A-orthonormal solve history: ``xs[i]`` with ``axs[i] = A xs[i]``.

  ``valid[i]`` flags live entries (0/1 in the working dtype); `head` is the
  round-robin write slot, a 0-d int64 tensor.
  """

  xs: torch.Tensor      # (K, ...) basis vectors
  axs: torch.Tensor     # (K, ...) their operator images
  valid: torch.Tensor   # (K,)
  head: torch.Tensor    # ()

  @classmethod
  def create(cls, like: torch.Tensor, k: int) -> 'ProjectionState':
    """Empty history of `k` entries shaped like the solution vector."""
    zeros = torch.zeros((k,) + tuple(like.shape), dtype=like.dtype,
                        device=like.device)
    return cls(xs=zeros, axs=zeros.clone(),
               valid=torch.zeros(k, dtype=like.dtype, device=like.device),
               head=torch.zeros((), dtype=torch.int64, device=like.device))


def _coefficients(basis: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                  dot_fn: Callable) -> torch.Tensor:
  if dot_fn is vdot:  # all K products in one launch
    return (basis.reshape(basis.shape[0], -1) @ v.reshape(-1)) * valid
  return torch.stack([dot_fn(x, v) for x in basis]) * valid


def _combine(coeff: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
  return torch.tensordot(coeff, basis, dims=1)


def project_guess(state: ProjectionState, b: torch.Tensor,
                  dot_fn: Callable = vdot):
  """Returns ``(x0, ax0)``: the A-optimal guess in the history subspace."""
  coeff = _coefficients(state.xs, b, state.valid, dot_fn)
  return _combine(coeff, state.xs), _combine(coeff, state.axs)


def update_history(state: ProjectionState, x: torch.Tensor, x0: torch.Tensor,
                   matvec: Callable, dot_fn: Callable = vdot,
                   rel_floor: float = 1e-6,
                   ax0: torch.Tensor | None = None) -> ProjectionState:
  """A-orthonormalizes the increment ``x - x0`` into the history.

  One `matvec` evaluation.  Increments whose A-norm after orthogonalization
  is below ``rel_floor`` of the full solution's A-norm (numerically
  dependent directions, rounding-level increments from a repeated rhs) are
  skipped.  Pass ``ax0`` (from `project_guess`) so the solution scale
  ``<x, A x>`` costs no extra matvec.
  """
  w = x - x0
  aw = matvec(w)
  if ax0 is None:
    ax0 = torch.zeros_like(aw)
  ref2 = dot_fn(x, aw + ax0)
  # One modified-Gram-Schmidt pass (the basis is A-orthonormal to rounding).
  coeff = _coefficients(state.xs, aw, state.valid, dot_fn)
  w = w - _combine(coeff, state.xs)
  aw = aw - _combine(coeff, state.axs)
  nrm2 = dot_fn(w, aw)
  ok = (nrm2 > (rel_floor ** 2) * torch.clamp(ref2, min=0)) & (nrm2 > 0)
  inv = torch.where(ok, torch.rsqrt(torch.where(nrm2 > 0, nrm2,
                                                torch.ones_like(nrm2))),
                    torch.zeros_like(nrm2))
  k = state.xs.shape[0]
  slot = state.head % k
  # The written slot, as a mask: no host read of `ok` or `slot`.
  hit = (torch.arange(k, device=slot.device) == slot) & ok
  sel = hit.reshape((k,) + (1,) * w.ndim)
  return ProjectionState(
      xs=torch.where(sel, (w * inv).unsqueeze(0), state.xs),
      axs=torch.where(sel, (aw * inv).unsqueeze(0), state.axs),
      valid=torch.where(hit, torch.ones_like(state.valid), state.valid),
      head=torch.where(ok, state.head + 1, state.head))

"""A differentiable linear solve: ``lax.custom_linear_solve`` for torch.

Counterpart of ``lax.custom_linear_solve(matvec, b, solve, symmetric=True,
has_aux=True)`` as the JAX package's solver uses it
(``swirlfem_tpu/nse/solver.py``, ``swirlfem_tpu/nse/scalar.py``): the
forward pass runs ``solve(matvec, b)`` without a graph; the backward pass
applies the same `solve` (same preconditioner, same seed) to the cotangent,
``lambda = solve(matvec, x_bar)``, which is ``b``'s gradient, and gives the
tensors the matvec closes over their implicit-function gradient
``theta_bar = -lambda^T (dA/dtheta) x``.  The aux (iterations, residual)
passes through without a gradient.

With grad mode off, or when neither `b` nor `params` requires grad, this is
exactly ``solve(matvec, b)``: no wrapper, no copy, no extra host read.
`linear_solve.transpose_solves` counts the backward passes' solves and
`linear_solve.transpose_iterations` adds up their ``num_iterations``.
"""

from __future__ import annotations

import torch


def _leaves(b):
  return (b,) if isinstance(b, torch.Tensor) else tuple(b)


def _like(form, leaves):
  return leaves[0] if isinstance(form, torch.Tensor) else tuple(leaves)


class _LinearSolve(torch.autograd.Function):
  """Inputs: the spec ``(matvec, solve, form of b, b's leaf count, params,
  aux box)``, then b's tensors and the parameters (so that autograd links
  the solution to both)."""

  @staticmethod
  def forward(ctx, spec, *tensors):
    matvec, solve, form, num_b, _, box = spec
    x, aux = solve(matvec, _like(form, tensors[:num_b]))
    box.append(aux)
    x = tuple(t.detach() for t in _leaves(x))
    ctx.spec = spec
    ctx.save_for_backward(*x)
    return x

  @staticmethod
  def backward(ctx, *x_bar):
    matvec, solve, form, num_b, params, _ = ctx.spec
    with torch.no_grad():
      lam, aux = solve(matvec, _like(form, x_bar))
    linear_solve.transpose_solves += 1
    linear_solve.transpose_iterations += int(aux['num_iterations'])
    lam = _leaves(lam)
    needs = ctx.needs_input_grad[1:]
    b_bar = [l if need else None for l, need in zip(lam, needs[:num_b])]
    p_bar = [None] * len(params)
    wanted = [i for i, need in enumerate(needs[num_b:]) if need]
    if wanted:
      # theta_bar = -lambda^T (dA/dtheta) x: differentiate the matvec at the
      # solution, contracted with -lambda.
      # Detached: the saved solution is this function's own output.
      x = _like(form, [t.detach() for t in ctx.saved_tensors])
      with torch.enable_grad():
        ax = _leaves(matvec(x))
        grads = torch.autograd.grad(
            ax, [params[i] for i in wanted],
            grad_outputs=[-l for l in lam], allow_unused=True)
      for i, g in zip(wanted, grads):
        p_bar[i] = g
    return (None, *b_bar, *p_bar)


def linear_solve(matvec, b, solve, params=()):
  """``x, aux = solve(matvec, b)``, differentiable in `b` and `params`.

  Args:
    matvec: the symmetric operator, a function of a tensor or a tuple of
      tensors (the form of `b`).
    b: the right-hand side, a tensor or a tuple of tensors.
    solve: ``solve(matvec, rhs) -> (x, aux)``, with `x` in the form of
      `rhs`; used for the forward solve and for the transpose solve.
    params: the tensors the matvec closes over that may require grad (the
      scalar's diffusivity, for one); they receive ``-lambda^T dA/dtheta x``.
      A tensor the matvec reads but that is not listed gets no gradient.
  """
  leaves = _leaves(b)
  params = tuple(p for p in params if isinstance(p, torch.Tensor))
  if not torch.is_grad_enabled() or not any(
      t.requires_grad for t in leaves + params):
    return solve(matvec, b)
  box = []
  x = _LinearSolve.apply((matvec, solve, b, len(leaves), params, box),
                         *leaves, *params)
  return _like(b, x), box[0]


linear_solve.transpose_solves = 0
linear_solve.transpose_iterations = 0

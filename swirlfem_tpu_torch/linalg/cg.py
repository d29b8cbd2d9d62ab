"""Matrix-free preconditioned conjugate gradients over tensor tuples.

Counterpart of ``swirlfem_tpu/linalg/cg.py`` (`cg`, `near_exact_solve`)
with the same arithmetic: M-weighted stopping test ``<r, M r>``, breakdown
guard, the periodic true-residual floor guard, and the Richardson +
certificate pattern for near-exact inverses.  Operands are tensors or
(nested) tuples of tensors.  The loops run on the host: each stopping test
reads one scalar from the device.
"""

from __future__ import annotations

import operator

import torch


def tree_map(fn, *trees):
  """Applies `fn` leafwise over parallel (nested) tuples, lists and dicts
  of tensors."""
  if isinstance(trees[0], (tuple, list)):
    return type(trees[0])(tree_map(fn, *xs) for xs in zip(*trees))
  if isinstance(trees[0], dict):
    return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
  return fn(*trees)


def tree_leaves(tree):
  """The tensors of a (nested) tuple, list or dict, in `tree_map`'s order."""
  if isinstance(tree, (tuple, list)):
    return [leaf for t in tree for leaf in tree_leaves(t)]
  if isinstance(tree, dict):
    return [leaf for t in tree.values() for leaf in tree_leaves(t)]
  return [tree]


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Real inner product of two same-shaped tensors."""
  return torch.dot(a.reshape(-1), b.reshape(-1))


def _tree_vdot(a, b, dot_fn):
  return sum(tree_leaves(tree_map(dot_fn, a, b)))


def _axpy(alpha, x, y):
  """y + alpha * x, leafwise."""
  return tree_map(lambda xi, yi: yi + alpha * xi, x, y)


def cg(A, b, x0=None, *, tol=1e-5, atol=0.0, maxiter=None, M=None,
       dot_fn=vdot, euclidean_stop=False, checkpoint_every=64):
  """Solves ``A x = b`` with preconditioned conjugate gradients.

  Same contract as ``swirlfem_tpu.linalg.cg.cg``: convergence when
  ``s <= max(tol^2 <b, M b>, atol^2)`` with ``s = <r, M r>`` (or the
  euclidean forms with `euclidean_stop`); every `checkpoint_every`
  iterations the true residual is recomputed to keep the best iterate and
  to stop once the recurrence has drifted below the rounding floor.

  Returns:
    ``(x, info)`` with ``info = {'residual': s, 'num_iterations': k}``
    (`s` a 0-d tensor, `k` an int).
  """
  if x0 is None:
    x0 = tree_map(torch.zeros_like, b)
  if maxiter is None:
    maxiter = 10 * sum(leaf.numel() for leaf in tree_leaves(b))
  if M is None:
    M = lambda x: x

  bs = (_tree_vdot(b, b, dot_fn) if euclidean_stop
        else _tree_vdot(b, M(b), dot_fn))
  threshold = torch.clamp(tol**2 * bs, min=atol**2)

  r = tree_map(operator.sub, b, A(x0))
  z = M(r)
  gamma = _tree_vdot(r, z, dot_fn)
  s = _tree_vdot(r, r, dot_fn) if euclidean_stop else gamma

  def true_s(x):
    rt = tree_map(operator.sub, b, A(x))
    if euclidean_stop:
      return _tree_vdot(rt, rt, dot_fn)
    return _tree_vdot(rt, M(rt), dot_fn)

  x, p, k = x0, z, 0
  best_x, s_best = x0, s
  while k < maxiter and bool(s > threshold):
    ap = A(p)
    pap = _tree_vdot(p, ap, dot_fn)
    # Breakdown guard: skip the update and force termination when the
    # quadratic forms reach rounding level and flip sign.
    safe = bool((pap > 0) & (gamma > 0))
    alpha = gamma / pap if safe else torch.zeros_like(gamma)
    x = _axpy(alpha, p, x)
    r = _axpy(-alpha, ap, r)
    z = M(r)
    gamma_new = (_tree_vdot(r, z, dot_fn) if safe
                 else torch.zeros_like(gamma))
    if euclidean_stop:
      s = _tree_vdot(r, r, dot_fn) if safe else torch.zeros_like(gamma)
    else:
      s = gamma_new
    beta = gamma_new / torch.where(gamma == 0, torch.ones_like(gamma), gamma)
    p = _axpy(beta, p, z)
    gamma = gamma_new
    if (k + 1) % checkpoint_every == 0 and safe and bool(s > threshold):
      st = true_s(x)
      # A negative M-weighted true form is itself a floor signature.
      if bool((st >= 0) & (st < s_best)):
        best_x, s_best = x, st
      at_floor = bool((st > 1e6 * torch.clamp(s, min=0)) | (st < 0))
      if at_floor:
        s = torch.zeros_like(s)
    k += 1

  if k >= checkpoint_every:
    st = true_s(x)
    x = x if bool(st <= s_best) else best_x
    s = torch.clamp(torch.minimum(st, s_best), min=0)
  return x, {'residual': s, 'num_iterations': k}


def near_exact_solve(matvec, rhs, apply_inv, *, tol=1e-5, atol=0.0,
                     dot_fn=vdot, maxiter=None, max_sweeps=8):
  """Solve with a near-exact inverse: Richardson sweeps + CG certificate.

  Monotone-guarded Richardson defect correction with the true residual
  recomputed each sweep, then an unpreconditioned CG from the resulting
  iterate to certify the euclidean tolerance (see the JAX docstring).
  `info['num_iterations']` counts sweeps plus CG iterations.
  """
  bs = dot_fn(rhs, rhs)
  thr = torch.clamp(tol**2 * bs, min=atol**2)
  x, r, rr, sweeps = torch.zeros_like(rhs), rhs, bs, 0
  while sweeps < max_sweeps and bool(rr > thr):
    # Accept only residual-reducing updates (4x contraction required).
    x_new = x + apply_inv(r)
    r_new = rhs - matvec(x_new)
    rr_new = dot_fn(r_new, r_new)
    if bool(rr_new < 0.25 * rr):
      x, r, rr, sweeps = x_new, r_new, rr_new, sweeps + 1
    else:
      sweeps = max_sweeps
  x, info = cg(matvec, rhs, x0=x, tol=tol, atol=atol, dot_fn=dot_fn,
               maxiter=maxiter)
  return x, {'residual': info['residual'],
             'num_iterations': info['num_iterations'] + sweeps}

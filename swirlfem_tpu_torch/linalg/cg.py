"""Matrix-free preconditioned conjugate gradients over tensor tuples.

Counterpart of ``swirlfem_tpu/linalg/cg.py`` (`cg`, `near_exact_solve`)
with the same arithmetic: M-weighted stopping test ``<r, M r>``, breakdown
guard, the periodic true-residual floor guard, and the Richardson +
certificate pattern for near-exact inverses.  Operands are tensors or
(nested) tuples of tensors.  The loops run on the host: each stopping test
reads one scalar from the device.

``batched=True`` solves a batch of independent systems at once, with the
semantics of the JAX functions under ``jax.vmap`` (a batched
``lax.while_loop``): `dot_fn` returns one inner product per sample, shaped
to broadcast against the operands (``keepdim``); every per-sample scalar
(``alpha``, ``beta``, the breakdown guard, the checkpoint register, the
final select, the Richardson ``better`` mask) is a tensor of that shape;
the loop runs while any sample has not stopped, and a stopped sample keeps
its state by a select, not a branch.  One host read per iteration (is any
sample still running) serves the whole batch.  ``info`` then holds
per-sample ``(B,)`` tensors.
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


def _select(mask, new, old):
  """`new` where `mask`, else `old`, leafwise."""
  return tree_map(lambda n, o: torch.where(mask, n, o), new, old)


def cg(A, b, x0=None, *, tol=1e-5, atol=0.0, maxiter=None, M=None,
       dot_fn=vdot, euclidean_stop=False, checkpoint_every=64,
       batched=False):
  """Solves ``A x = b`` with preconditioned conjugate gradients.

  Same contract as ``swirlfem_tpu.linalg.cg.cg``: convergence when
  ``s <= max(tol^2 <b, M b>, atol^2)`` with ``s = <r, M r>`` (or the
  euclidean forms with `euclidean_stop`); every `checkpoint_every`
  iterations the true residual is recomputed to keep the best iterate and
  to stop once the recurrence has drifted below the rounding floor.

  Returns:
    ``(x, info)`` with ``info = {'residual': s, 'num_iterations': k}``
    (`s` a 0-d tensor, `k` an int; with `batched`, both ``(B,)`` tensors).
  """
  if batched:
    return _cg_batched(A, b, x0, tol=tol, atol=atol, maxiter=maxiter, M=M,
                       dot_fn=dot_fn, euclidean_stop=euclidean_stop,
                       checkpoint_every=checkpoint_every)
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


def _cg_batched(A, b, x0, *, tol, atol, maxiter, M, dot_fn, euclidean_stop,
                checkpoint_every):
  """`cg` on a batch of systems: the JAX `cg` under ``jax.vmap``."""
  if x0 is None:
    x0 = tree_map(torch.zeros_like, b)
  if M is None:
    M = lambda x: x

  bs = (_tree_vdot(b, b, dot_fn) if euclidean_stop
        else _tree_vdot(b, M(b), dot_fn))
  if maxiter is None:  # 10x one sample's size
    maxiter = 10 * sum(leaf.numel() for leaf in tree_leaves(b)) // bs.numel()
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

  zero = torch.zeros_like(gamma)
  x, p = x0, z
  k = torch.zeros(gamma.shape, dtype=torch.int64, device=gamma.device)
  best_x, s_best = x0, s
  active = (s > threshold) & (k < maxiter)
  # Every running sample has made `it` iterations: the checkpoint cadence
  # and the final select's test are known on the host.
  it = 0
  while it < maxiter and bool(active.any()):
    ap = A(p)
    pap = _tree_vdot(p, ap, dot_fn)
    safe = (pap > 0) & (gamma > 0)
    alpha = torch.where(safe, gamma / torch.where(pap == 0, 1, pap), zero)
    x_new = _axpy(alpha, p, x)
    r_new = _axpy(-alpha, ap, r)
    z = M(r_new)
    gamma_new = torch.where(safe, _tree_vdot(r_new, z, dot_fn), zero)
    if euclidean_stop:
      s_new = torch.where(safe, _tree_vdot(r_new, r_new, dot_fn), zero)
    else:
      s_new = gamma_new
    beta = gamma_new / torch.where(gamma == 0, torch.ones_like(gamma), gamma)
    p_new = _axpy(beta, p, z)
    if (it + 1) % checkpoint_every == 0:
      check = active & safe & (s_new > threshold)
      st = true_s(x_new)
      improved = check & (st >= 0) & (st < s_best)
      best_x = _select(improved, x_new, best_x)
      s_best = torch.where(improved, st, s_best)
      at_floor = check & ((st > 1e6 * torch.clamp(s_new, min=0)) | (st < 0))
      s_new = torch.where(at_floor, zero, s_new)
    x, r, p = (_select(active, new, old) for new, old in
               ((x_new, x), (r_new, r), (p_new, p)))
    gamma = torch.where(active, gamma_new, gamma)
    s = torch.where(active, s_new, s)
    k = torch.where(active, k + 1, k)
    active = (s > threshold) & (k < maxiter)
    it += 1

  if it >= checkpoint_every:
    st = true_s(x)
    late = k >= checkpoint_every
    x = _select(late & ~(st <= s_best), best_x, x)
    s = torch.where(late, torch.clamp(torch.minimum(st, s_best), min=0), s)
  return x, {'residual': s.reshape(-1), 'num_iterations': k.reshape(-1)}


def near_exact_solve(matvec, rhs, apply_inv, *, tol=1e-5, atol=0.0,
                     dot_fn=vdot, maxiter=None, max_sweeps=8, batched=False):
  """Solve with a near-exact inverse: Richardson sweeps + CG certificate.

  Monotone-guarded Richardson defect correction with the true residual
  recomputed each sweep, then an unpreconditioned CG from the resulting
  iterate to certify the euclidean tolerance (see the JAX docstring).
  `info['num_iterations']` counts sweeps plus CG iterations.  `batched`:
  as in `cg`, the sweeps' ``better`` masks per sample.
  """
  if batched:
    return _near_exact_batched(matvec, rhs, apply_inv, tol=tol, atol=atol,
                               dot_fn=dot_fn, maxiter=maxiter,
                               max_sweeps=max_sweeps)
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


def _near_exact_batched(matvec, rhs, apply_inv, *, tol, atol, dot_fn,
                        maxiter, max_sweeps):
  """`near_exact_solve` on a batch of systems (tensor operands)."""
  bs = dot_fn(rhs, rhs)
  thr = torch.clamp(tol**2 * bs, min=atol**2)
  x, r, rr = torch.zeros_like(rhs), rhs, bs
  sweeps = torch.zeros(bs.shape, dtype=torch.int64, device=bs.device)
  active = (rr > thr) & (sweeps < max_sweeps)
  while bool(active.any()):
    x_new = x + apply_inv(r)
    r_new = rhs - matvec(x_new)
    rr_new = dot_fn(r_new, r_new)
    better = rr_new < 0.25 * rr
    take = active & better
    x = torch.where(take, x_new, x)
    r = torch.where(take, r_new, r)
    rr = torch.where(take, rr_new, rr)
    sweeps = torch.where(active, torch.where(better, sweeps + 1, max_sweeps),
                         sweeps)
    active = (rr > thr) & (sweeps < max_sweeps)
  x, info = _cg_batched(matvec, rhs, x, tol=tol, atol=atol, maxiter=maxiter,
                        M=None, dot_fn=dot_fn, euclidean_stop=False,
                        checkpoint_every=64)
  return x, {'residual': info['residual'],
             'num_iterations': info['num_iterations'] + sweeps.reshape(-1)}

"""Euler-Heun Stratonovich SDE integrator with the adjoint backward pass.

Counterpart of ``swirlfem_tpu/sde/sdeint.py``.  Integrates

    dY_t = mu(Y_t, t) dt + sigma(Y_t, t) o dW_t

with the Euler-Heun scheme (``sdeint.py:88-111``: the in-interval guard,
time arithmetic in the state's dtype), and gives gradients by the adjoint
SDE of Li et al. (AISTATS 2020, ``sdeint.py:145-174``): the augmented
system (state, state cotangent, parameter cotangents) is integrated
backward in time with the same scheme, on the same Brownian increments in
reverse order, with ``torch.autograd.grad`` for the drift's and the
diffusion's VJPs.  This is not autograd through the forward loop: only the
adjoint scheme gives the JAX package's numbers.  Memory is O(state).

The loops run on the host; nothing is read back from the device.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import torch

State = Any


def brownian_path(n: int, shape=(), *, generator=None, dtype=torch.float32,
                  device=None) -> torch.Tensor:
  """Standard Brownian increments on `n` uniform points of [0, 1]:
  ``(n,) + shape`` draws of N(0, 1/n) from `generator`."""
  draw = torch.randn((n,) + tuple(shape), generator=generator,
                     dtype=torch.float32, device=device)
  return (math.sqrt(1.0 / n) * draw).to(dtype)


# -- states as flat tensors ---------------------------------------------------


def _flatten(tree):
  """Leaves (dict keys sorted, as JAX orders them) and a rebuild function."""
  if isinstance(tree, torch.Tensor):
    return [tree], lambda leaves: leaves[0]
  if isinstance(tree, dict):
    keys = sorted(tree)
    parts = [_flatten(tree[k]) for k in keys]
  else:
    keys = None
    parts = [_flatten(t) for t in tree]
  counts = [len(p[0]) for p in parts]

  def rebuild(leaves):
    out, i = [], 0
    for (_, build), c in zip(parts, counts):
      out.append(build(leaves[i:i + c]))
      i += c
    return dict(zip(keys, out)) if keys is not None else type(tree)(out)

  return [leaf for p in parts for leaf in p[0]], rebuild


def _ravel(tree):
  """``(flat, unravel)``: the state as one 1-D tensor, and its inverse."""
  leaves, rebuild = _flatten(tree)
  shapes = [l.shape for l in leaves]
  sizes = [l.numel() for l in leaves]
  flat = torch.cat([l.reshape(-1) for l in leaves])

  def unravel(v):
    return rebuild([p.reshape(s) for p, s in zip(torch.split(v, sizes),
                                                   shapes)])

  return flat, unravel


# -- the scheme ---------------------------------------------------------------


def _tmap(fn, *trees):
  if isinstance(trees[0], (tuple, list)):
    return type(trees[0])(_tmap(fn, *xs) for xs in zip(*trees))
  return fn(*trees)


def _euler_heun(f, y0, ts, dw, reverse: bool):
  """Euler-Heun over `dw` (a sequence of per-step increments) from
  ``ts[0]`` to ``ts[1]``; `y0` a tensor or a (nested) tuple of tensors of
  one dtype.  `reverse` walks the increments last to first."""
  leaf = y0 if isinstance(y0, torch.Tensor) else _flatten(y0)[0][0]
  t0 = torch.tensor(ts[0], dtype=leaf.dtype, device=leaf.device)
  t1 = torch.tensor(ts[1], dtype=leaf.dtype, device=leaf.device)
  dt = (t1 - t0) / len(dw)
  t, x = t0, y0
  order = range(len(dw) - 1, -1, -1) if reverse else range(len(dw))
  for i in order:
    drift, diff = f(x, t, dw[i])
    _, diff_heun = f(_tmap(torch.add, x, diff), t + dt, dw[i])
    x_new = _tmap(lambda a, b, c, d: a + b * dt + 0.5 * (c + d),
                  x, drift, diff, diff_heun)
    # Guard against accumulating outside [t0, t1) under float drift.
    inside = (t >= t0) & (t < t1)
    x = _tmap(lambda n, o: torch.where(inside, n, o), x_new, x)
    t = t + dt
  return x


class _Integrate(torch.autograd.Function):
  """One output interval; inputs: the spec ``(f, ts, dw, number of args,
  params)``, the flat state, then f's args and the closed-over params."""

  @staticmethod
  def forward(ctx, spec, y0, *tensors):
    f, ts, dw, num_args, _ = spec
    args = tensors[:num_args]
    y1 = _euler_heun(lambda y, t, d: f(y, t, d, *args), y0, ts, dw,
                     reverse=False)
    ctx.spec = spec
    ctx.save_for_backward(y1, *args)
    return y1

  @staticmethod
  def backward(ctx, y1_bar):
    f, ts, dw, num_args, params = ctx.spec
    y1, *args = [t.detach() for t in ctx.saved_tensors]
    args = [a.requires_grad_() if a.is_floating_point() else a for a in args]
    wrt = [a for a in args if a.requires_grad] + list(params)

    def vjps(out, yv, cot):
      g = torch.autograd.grad(out, [yv, *wrt], grad_outputs=cot,
                              retain_graph=True, allow_unused=True)
      return [torch.zeros_like(x) if gi is None else gi
              for gi, x in zip(g, [yv, *wrt])]

    def aug_f(aug, t, dw_step):
      y, y_bar, _ = aug
      with torch.enable_grad():
        yv = y.detach().requires_grad_()
        drift, diff = f(yv, -t, dw_step, *args)
        d_y, *d_w = vjps(drift, yv, y_bar)
        s_y, *s_w = vjps(diff, yv, y_bar)
      return ((-drift.detach(), d_y, d_w), (-diff.detach(), s_y, s_w))

    aug0 = (y1, y1_bar, [torch.zeros_like(w) for w in wrt])
    _, y0_bar, w_bar = _euler_heun(aug_f, aug0, (-ts[1], -ts[0]), dw,
                                   reverse=True)
    w_bar = iter(w_bar)
    args_bar = [next(w_bar) if a.requires_grad else None for a in args]
    return (None, y0_bar, *args_bar, *w_bar)


def sdeint(f: Callable[..., tuple[State, State]], y0: State,
           ts: Sequence[float], dw: torch.Tensor, *args,
           params: Sequence[torch.Tensor] = ()) -> State:
  """Integrates a Stratonovich SDE, returning the states at ``ts[1:]``.

  Args:
    f: ``f(y, t, dw_step, *args) -> (mu, sigma o dW)``; the diffusion
      output already includes the Brownian increment.  Both outputs have
      the form of `y0` (a tensor, or a tuple or dict of tensors).
    y0: initial state.
    ts: increasing times in [0, 1] (floats); states are emitted at each of
      ``ts[1:]``.  Should be multiples of ``1/len(dw)``.
    dw: Brownian increments over [0, 1], time first, evenly divided among
      the ``len(ts) - 1`` output intervals.
    *args: extra tensors passed through to `f` (differentiable).
    params: tensors `f` closes over (a module's parameters) that receive
      gradients through the adjoint.

  Returns:
    The states, stacked on a leading axis of length ``len(ts) - 1``.
  """
  touts = list(ts[1:])
  segments = dw.reshape((len(touts), -1) + tuple(dw.shape[1:]))
  flat, unravel = _ravel(y0)

  def f_flat(y, t, dw_step, *a):
    drift, diff = f(unravel(y), t, dw_step, *a)
    return _ravel(drift)[0], _ravel(diff)[0]

  params = tuple(p for p in params if p.requires_grad)
  need_grad = torch.is_grad_enabled() and any(
      isinstance(t, torch.Tensor) and t.requires_grad
      for t in (flat,) + tuple(args) + params)
  outs, t0 = [], float(ts[0])
  for seg, t1 in zip(segments, touts):
    if need_grad:
      flat = _Integrate.apply((f_flat, (t0, float(t1)), seg, len(args),
                               params), flat, *args, *params)
    else:
      flat = _euler_heun(lambda y, t, d: f_flat(y, t, d, *args), flat,
                         (t0, float(t1)), seg, reverse=False)
    outs.append(unravel(flat))
    t0 = float(t1)
  rebuild = _flatten(outs[0])[1]
  return rebuild([torch.stack(leaves)
                  for leaves in zip(*(_flatten(o)[0] for o in outs))])

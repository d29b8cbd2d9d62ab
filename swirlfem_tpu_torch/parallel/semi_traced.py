"""Scalars with this rank's value and every rank's value.

Counterpart of ``swirlfem_tpu/parallel/semi_traced.py``: a
`SemiTracedScalar` carries the value local to this rank (a tensor or a
number) and a numpy array of the value on every rank of the axis.  A
collective computes its schedule from the global view (every rank alike),
while its data stay local.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SemiTracedScalar:
  """``x.local`` is this rank's value; ``x.global_`` a numpy array of every
  rank's value along the axis.  Arithmetic and comparisons apply to both
  views pairwise."""

  local: Any
  global_: np.ndarray

  @staticmethod
  def axis_index(ax) -> 'SemiTracedScalar':
    return SemiTracedScalar(local=torch.tensor(ax.index),
                            global_=np.arange(ax.size))

  @staticmethod
  def axis_size(ax) -> 'SemiTracedScalar':
    return SemiTracedScalar(local=ax.size, global_=np.full((ax.size,),
                                                           ax.size))

  @staticmethod
  def constant(c, ax) -> 'SemiTracedScalar':
    return SemiTracedScalar(local=c, global_=np.full((ax.size,), c))

  @staticmethod
  def index_and_size(ax):
    return SemiTracedScalar.axis_index(ax), SemiTracedScalar.axis_size(ax)

  @staticmethod
  def where(c: 'SemiTracedScalar', x: 'SemiTracedScalar',
            y: 'SemiTracedScalar') -> 'SemiTracedScalar':
    return SemiTracedScalar(
        local=torch.where(torch.as_tensor(c.local), torch.as_tensor(x.local),
                          torch.as_tensor(y.local)),
        global_=np.where(c.global_, x.global_, y.global_))


def _lift(op, reflected=False):
  def method(self, other):
    if isinstance(other, SemiTracedScalar):
      lo, go = other.local, other.global_
    else:
      lo, go = other, other
    if reflected:
      return SemiTracedScalar(local=op(lo, self.local),
                              global_=op(go, self.global_))
    return SemiTracedScalar(local=op(self.local, lo),
                            global_=op(self.global_, go))
  return method


for _name, _op in [
    ('add', operator.add), ('sub', operator.sub), ('mul', operator.mul),
    ('floordiv', operator.floordiv), ('truediv', operator.truediv),
    ('mod', operator.mod), ('pow', operator.pow),
    ('and', operator.and_), ('or', operator.or_), ('xor', operator.xor),
    ('lshift', operator.lshift), ('rshift', operator.rshift),
]:
  setattr(SemiTracedScalar, f'__{_name}__', _lift(_op))
  setattr(SemiTracedScalar, f'__r{_name}__', _lift(_op, reflected=True))

for _name, _op in [
    ('lt', operator.lt), ('le', operator.le), ('gt', operator.gt),
    ('ge', operator.ge), ('eq', operator.eq), ('ne', operator.ne),
]:
  setattr(SemiTracedScalar, f'__{_name}__', _lift(_op))

SemiTracedScalar.__neg__ = lambda self: SemiTracedScalar(  # type: ignore[method-assign]
    local=-self.local, global_=-self.global_)
SemiTracedScalar.__invert__ = lambda self: SemiTracedScalar(  # type: ignore[method-assign]
    local=~self.local, global_=~self.global_)

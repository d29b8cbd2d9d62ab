"""Kernel-against-plain checks and timings, shared by chip_smoke.py and tests.

Each check runs a hand-written kernel and its plain PyTorch version on the
same inputs on one CUDA device and reports their difference; the timings
use CUDA events.  Launches made here count in the wrappers' launch
counters: callers reset the counters before a run they want to attribute.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from swirlfem_tpu_torch.ops import cuda_exchange
from swirlfem_tpu_torch.ops import cuda_split
from swirlfem_tpu_torch.ops import cuda_stiffness
from swirlfem_tpu_torch.ops import cuda_stiffness2d
from swirlfem_tpu_torch.ops import cuda_stiffness3d

# Gate of the stiffness kernel against the float64 operator, relative to
# the largest output entry (the JAX bench's gate, bench.py:602-611).
STIFFNESS_REL_TOL = 1e-5
# The dense 3D kernel ('highest', 3xTF32 in float32) against the float64
# operator: FP32 reads ~2e-7 and 3xTF32 ~3e-7, one TF32 pass ~5e-4, so
# this tighter check, beside the class's gate, fails a kernel that lost a
# pass.
DENSE_REL_TOL = 1e-6
# The split-bf16 classes against the float64 operator: 'bf16x3' at the JAX
# bench's gate (bench.py:639, 464), 'default' (one bf16 pass; JAX measured
# ~3e-3, swirlfem_tpu/ops/sem2d.py:179).  Each error must also exceed its
# floor, which shows that the class's rounding really happened.
SPLIT_REL_TOL = 1e-4
DEFAULT_REL_TOL = 1e-2
CLASS_BANDS = {'bf16x3': (1e-7, SPLIT_REL_TOL),
               'default': (1e-5, DEFAULT_REL_TOL)}
# A split kernel against its plain version, relative to the largest output
# entry: both sum the same exact bf16 products, in another order.
SPLIT_VS_PLAIN_TOL = 1e-5
# The bf16x3 pair kernels.  The congruent one splits only its input, as the
# static-operator split kernels do, and holds its plain version to 1e-6;
# the slab pipelines (general, pairz, affine) also split their intermediate
# fluxes, whose low bf16 part can round the other way where two sums
# differ by one unit in the last place, and hold `SPLIT_VS_PLAIN_TOL`.
# Against the float64 operator they read 4e-6 to 1.4e-5, the FP32 class
# ~2e-7: the floor of their band is 1e-6, so that a kernel of the wrong
# class fails it.
PAIR_VS_PLAIN_TOL = {'stiffness3d_pair': 1e-6}
PAIR_BAND = (1e-6, SPLIT_REL_TOL)

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# HBM3 bandwidth, FP32 (non-tensor-core) rate and dense bf16 and TF32
# tensor-core rates.  A kernel's bound is the larger of its bytes over the first and its
# operations over the rate of their type.
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOP_PER_S = 67e12
H100_BF16_TC_FLOP_PER_S = 989e12
H100_TF32_TC_FLOP_PER_S = 495e12


def bound(flops: float, nbytes: float,
          flop_per_s: float = H100_FP32_FLOP_PER_S) -> dict:
  """The least time the card could take: ``bound_ms`` and ``bound_by``.

  `flop_per_s` is the peak rate of the operations' type: FP32 by default,
  `H100_BF16_TC_FLOP_PER_S` for the split-bf16 tensor-core kernels,
  `H100_TF32_TC_FLOP_PER_S` for the 3xTF32 dense one.
  """
  t_bytes = nbytes / H100_BYTES_PER_S
  t_ops = flops / flop_per_s
  return {'bound_ms': max(t_bytes, t_ops) * 1e3,
          'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}


def _kron_derivatives(dmat: torch.Tensor, ndim: int) -> torch.Tensor:
  """``(ndim, k^d, k^d)``: the 1D derivative along each axis of the
  flattened element, ``I (x) .. (x) D (x) .. (x) I``."""
  eye = torch.eye(dmat.shape[0], dtype=dmat.dtype, device=dmat.device)
  mats = []
  for a in range(ndim):
    m = torch.ones((1, 1), dtype=dmat.dtype, device=dmat.device)
    for b in range(ndim):
      m = torch.kron(m, dmat if a == b else eye)
    mats.append(m)
  return torch.stack(mats)


def _symmetric(factors, ndim: int):
  """The ``(ndim, ndim, ...)`` stack of the symmetric factors, given in the
  order (11, 12, 22) or (11, 12, 13, 22, 23, 33)."""
  idx = [[0, 1], [1, 2]] if ndim == 2 else [[0, 1, 2], [1, 3, 4], [2, 4, 5]]
  return torch.stack([torch.stack([factors[j] for j in row]) for row in idx])


def library_general(us, gs, dmat: torch.Tensor):
  """One PyTorch call of the general 2D or 3D stiffness, ``sum_ab D_a^T
  (G_ab D_b u)``: a zero-argument callable of ONE `torch.einsum` of the
  axis derivatives (as ``(k^d, k^d)`` Kronecker matrices), the factor
  fields and the stacked components, returning ``(k^d, C, E)``.  The
  operands are stacked here, outside the call."""
  ndim = us[0].ndim - 1
  kd = dmat.shape[0] ** ndim
  ds = _kron_derivatives(dmat, ndim)
  g = _symmetric([f.reshape(kd, -1) for f in gs], ndim)
  u = torch.stack([x.reshape(kd, -1) for x in us], dim=1)
  return lambda: torch.einsum('bpj,jce,abpe,api->ice', ds, u, g, ds)


def library_pair_affine(us, c_affine: torch.Tensor, w1: torch.Tensor,
                        dmat: torch.Tensor):
  """One PyTorch call of the affine 3D stiffness, ``G_ab(q, e) = w(q)
  C_ab(e)``: ONE `torch.einsum` of the axis derivatives, the per-element
  coefficients, the quadrature weights and the stacked components."""
  kd = dmat.shape[0] ** 3
  ds = _kron_derivatives(dmat, 3)
  c = _symmetric(list(c_affine), 3)
  w3 = torch.einsum('i,j,k->ijk', w1, w1, w1).reshape(kd)
  u = torch.stack([x.reshape(kd, -1) for x in us], dim=1)
  return lambda: torch.einsum('bpj,jce,abe,p,api->ice', ds, u, c, w3, ds)


def random_field(shape, *, dtype, device, seed=0) -> torch.Tensor:
  rng = np.random.default_rng(seed)
  return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                         device=device)


def check_exchange2d(w) -> dict:
  """exchange2d kernel vs `exchange2d_plain` on `w` (one field, or a tuple
  of up to four in one launch): must be bitwise equal, field by field."""
  ws = (w,) if isinstance(w, torch.Tensor) else tuple(w)
  got = cuda_exchange.exchange2d(ws)
  want = tuple(cuda_exchange.exchange2d_plain(x) for x in ws)
  torch.cuda.synchronize(ws[0].device)
  return {'bitwise_equal': all(bool(torch.equal(g, x))
                               for g, x in zip(got, want)),
          'max_abs_err': max(float((g - x).abs().max())
                             for g, x in zip(got, want))}


def check_stiffness_uniform(ops, us) -> dict:
  """stiffness_uniform kernel vs its plain version and the float64 operator.

  `ops` is a congruent-element `Sem2DOps` on the device; `us` a tuple of
  ``(k, k, E)`` fields in its dtype.
  """
  amat = ops.mats['amat']
  got = cuda_stiffness.stiffness_uniform(us, amat, ops.mats['amat_t'])
  plain = cuda_stiffness.stiffness_uniform_plain(us, amat)
  a64 = torch.as_tensor(
      cuda_stiffness.uniform_amat_np(ops.c_uniform, ops.wq2d, ops.dmat),
      dtype=torch.float64, device=amat.device)
  ref = cuda_stiffness.stiffness_uniform_plain(
      tuple(u.double() for u in us), a64)
  torch.cuda.synchronize(amat.device)
  return _errors(got, plain, ref)


def check_stiffness2d_general(ops, us, gs=None) -> dict:
  """stiffness2d_general kernel vs its plain version and the float64
  operator on the same factor fields (`gs`, default the box's own)."""
  gs = (ops.g11, ops.g12, ops.g22) if gs is None else tuple(gs)
  dmat = ops.mats['dmat']
  got = cuda_stiffness2d.stiffness2d_general(us, gs, dmat)
  plain = cuda_stiffness2d.stiffness2d_general_plain(us, gs, dmat)
  ref = cuda_stiffness2d.stiffness2d_general_plain(
      tuple(u.double() for u in us), tuple(g.double() for g in gs),
      torch.as_tensor(ops.dmat, dtype=torch.float64, device=dmat.device))
  torch.cuda.synchronize(dmat.device)
  return _errors(got, plain, ref)


def check_stiffness2d_affine(ops, us) -> dict:
  """stiffness2d_affine kernel vs its plain version and the float64
  operator (the stacked operator built in float64 on the same scalars)."""
  mstack = ops.mats['mstack']
  got = cuda_stiffness2d.stiffness2d_affine(us, ops.g_affine, mstack,
                                            ops.mats['mstack_t'])
  plain = cuda_stiffness2d.stiffness2d_affine_plain(us, ops.g_affine, mstack)
  m64 = torch.as_tensor(cuda_stiffness.affine_mstack_np(ops.wq2d, ops.dmat),
                        dtype=torch.float64, device=mstack.device)
  ref = cuda_stiffness2d.stiffness2d_affine_plain(
      tuple(u.double() for u in us), ops.g_affine.double(), m64)
  torch.cuda.synchronize(mstack.device)
  return _errors(got, plain, ref)


def check_stiffness2d_kron(ops, u, gs=None) -> dict:
  """stiffness2d_kron (the general kernel at C = 1) vs its plain version (the
  Kronecker form), vs `stiffness2d_general` on the same field, and both vs
  the float64 operator; ``vs_general_max_abs`` is the largest difference
  from the general kernel."""
  gs = (ops.g11, ops.g12, ops.g22) if gs is None else tuple(gs)
  dmat = ops.mats['dmat']
  got = cuda_stiffness2d.stiffness2d_kron(u, *gs, dmat)
  plain = cuda_stiffness2d.stiffness2d_kron_plain(u, *gs, dmat)
  general = cuda_stiffness2d.stiffness2d_general((u,), gs, dmat)[0]
  ref = cuda_stiffness2d.stiffness2d_general_plain(
      (u.double(),), tuple(g.double() for g in gs),
      torch.as_tensor(ops.dmat, dtype=torch.float64, device=dmat.device))
  torch.cuda.synchronize(dmat.device)
  errs = _errors((got,), (plain,), ref)
  errs['vs_general_max_abs'] = float((got - general).abs().max())
  return errs


def _split_errors(got, plain, ref) -> dict:
  """`_errors` plus the kernel against its plain version relative to the
  plain output's largest entry, ``rel_err_plain``."""
  errs = _errors(got, plain, ref)
  errs['rel_err_plain'] = errs['max_abs_err'] / max(
      float(p.abs().max()) for p in plain)
  return errs


def check_stiffness_uniform_split(ops, us) -> dict:
  """The congruent 2D stiffness in `ops.kernel_precision` ('bf16x3' or
  'default'), through `Sem2DOps.stiffness_el_multi` (the split kernel on a
  CUDA device), vs its plain version and the float64 operator."""
  got = ops.stiffness_el_multi(us)
  passes = cuda_split.PASSES[ops.kernel_precision]
  plain = cuda_split.stiffness_uniform_split_plain(us, *ops.split_operator(),
                                                   passes)
  a64 = torch.as_tensor(
      cuda_stiffness.uniform_amat_np(ops.c_uniform, ops.wq2d, ops.dmat),
      dtype=torch.float64, device=us[0].device)
  ref = cuda_stiffness.stiffness_uniform_plain(
      tuple(u.double() for u in us), a64)
  torch.cuda.synchronize(us[0].device)
  return _split_errors(got, plain, ref)


def check_stiffness2d_affine_split(ops, us) -> dict:
  """The affine 2D stiffness in `ops.kernel_precision` through
  `Sem2DOps.stiffness_el_multi`, vs its plain version and the float64
  stacked operator on the same scalars."""
  got = ops.stiffness_el_multi(us)
  passes = cuda_split.PASSES[ops.kernel_precision]
  plain = cuda_split.stiffness2d_affine_split_plain(
      us, ops.g_affine, *ops.split_operator(), passes)
  m64 = torch.as_tensor(cuda_stiffness.affine_mstack_np(ops.wq2d, ops.dmat),
                        dtype=torch.float64, device=us[0].device)
  ref = cuda_stiffness2d.stiffness2d_affine_plain(
      tuple(u.double() for u in us), ops.g_affine.double(), m64)
  torch.cuda.synchronize(us[0].device)
  return _split_errors(got, plain, ref)


def check_stiffness3d_dense_split(ops, us) -> dict:
  """The dense 3D kernel in the 'bf16x3' class vs its plain version and the
  float64 dense operator of the congruent box."""
  hi, lo = ops.dense_split()
  got = cuda_split.stiffness3d_dense_split(us, hi, lo, ops.dense_bf16())
  plain = cuda_split.stiffness_uniform_split_plain(us, hi, lo, 3)
  ref = _uniform_ref64(ops, us)
  torch.cuda.synchronize(hi.device)
  return _split_errors(got, plain, ref)


def _errors(got, plain, ref) -> dict:
  """Kernel vs plain (max abs) and both vs a float64 reference, relative
  to the reference's largest entry."""
  scale = max(float(r.abs().max()) for r in ref)
  return {
      'max_abs_err': max(float((g - p).abs().max())
                         for g, p in zip(got, plain)),
      'rel_err_f64': max(float((g.double() - r).abs().max())
                         for g, r in zip(got, ref)) / scale,
      'plain_rel_err_f64': max(float((p.double() - r).abs().max())
                               for p, r in zip(plain, ref)) / scale,
  }


def _uniform_ref64(ops, us):
  """The float64 dense ``(k^3, k^3)`` operator of a congruent box on `us`."""
  a64 = torch.as_tensor(
      cuda_stiffness3d.uniform_amat3d_np(ops.c_uniform, ops.w1, ops.dmat),
      dtype=torch.float64, device=us[0].device)
  k3 = a64.shape[0]
  return tuple((a64 @ u.double().reshape(k3, -1)).reshape(u.shape) for u in us)


def _general_ref64(ops, us, gs):
  """The float64 sum-factorized operator on the factor fields `gs`."""
  return cuda_stiffness3d.stiffness3d_general_plain(
      tuple(u.double() for u in us), tuple(g.double() for g in gs),
      torch.as_tensor(ops.dmat, dtype=torch.float64, device=us[0].device))


def check_stiffness3d_uniform(ops, us) -> dict:
  """stiffness3d_uniform kernel vs its plain version and the float64
  operator (the dense ``(k^3, k^3)`` matrix from `ops.c_uniform`).

  `ops` is a congruent-element `Sem3DOps` on the device; `us` a tuple of
  ``(k, k, k, E)`` fields in its dtype.
  """
  table = ops.mats['table']
  got = cuda_stiffness3d.stiffness3d_uniform(us, table)
  plain = cuda_stiffness3d.stiffness3d_uniform_plain(us, table)
  ref = _uniform_ref64(ops, us)
  torch.cuda.synchronize(table.device)
  return _errors(got, plain, ref)


def check_stiffness3d_dense(ops, us) -> dict:
  """stiffness3d_dense kernel vs its plain version and the float64 dense
  operator of the congruent box."""
  amat_t = ops.dense_operator_t()
  got = cuda_stiffness3d.stiffness3d_dense(us, amat_t, ops.dense_tf32())
  plain = cuda_stiffness3d.stiffness3d_dense_plain(us, amat_t)
  ref = _uniform_ref64(ops, us)
  torch.cuda.synchronize(amat_t.device)
  return _errors(got, plain, ref)


def check_stiffness3d_pair(ops, us) -> dict:
  """stiffness3d_pair kernel (bf16x3) vs its plain version and the float64
  dense operator of the congruent box; ``rel_err_plain`` relative to the
  plain output's largest entry."""
  a2, table = ops.pair_operators()
  got = cuda_stiffness3d.stiffness3d_pair(us, a2, table)
  plain = cuda_stiffness3d.stiffness3d_pair_plain(us, a2, table)
  ref = _uniform_ref64(ops, us)
  torch.cuda.synchronize(table.device)
  return _split_errors(got, plain, ref)


def check_stiffness3d_pair_general(ops, us, gs=None, *, zeta=False) -> dict:
  """stiffness3d_pair_general kernel (or, with `zeta`, the pairz one), class
  bf16x3, vs its plain version and the float64 sum-factorized operator on
  the same factor fields (`gs`, default the box's own)."""
  gs = ops.gs() if gs is None else tuple(gs)
  dmat = ops.mats['dmat']
  dp = ops.pair_derivative_split()
  cs3 = cuda_stiffness3d
  kernel, plain_fn = ((cs3.stiffness3d_pairz_general,
                       cs3.stiffness3d_pairz_general_plain) if zeta else
                      (cs3.stiffness3d_pair_general,
                       cs3.stiffness3d_pair_general_plain))
  got = kernel(us, gs, dp, dmat)
  plain = plain_fn(us, gs, dp, dmat)
  ref = _general_ref64(ops, us, gs)
  torch.cuda.synchronize(dmat.device)
  return _split_errors(got, plain, ref)


def check_stiffness3d_pair_affine(ops, us, c_affine=None) -> dict:
  """stiffness3d_pair_affine kernel (bf16x3) vs its plain version and the
  float64 sum-factorized operator on ``G_ab = w(q) C_ab(e)`` (`c_affine`,
  default the box's own ``ops.g_affine``, weights in float64)."""
  c_affine = ops.g_affine if c_affine is None else c_affine
  dp, at_w, table = ops.pair_affine_operators()
  got = cuda_stiffness3d.stiffness3d_pair_affine(
      us, c_affine, dp, at_w, table, at_frags=ops.pair_affine_fragments())
  plain = cuda_stiffness3d.stiffness3d_pair_affine_plain(us, c_affine, dp,
                                                         at_w, table)
  w1 = torch.as_tensor(ops.w1, dtype=torch.float64, device=table.device)
  w3 = torch.einsum('i,j,k->ijk', w1, w1, w1)[..., None]
  ref = _general_ref64(ops, us, tuple(w3 * c.double() for c in c_affine))
  torch.cuda.synchronize(table.device)
  return _split_errors(got, plain, ref)


def check_stiffness3d_general(ops, us, gs=None) -> dict:
  """stiffness3d_general kernel vs its plain version and the float64
  operator on the same factor fields (`gs`, default the box's own)."""
  gs = ops.gs() if gs is None else tuple(gs)
  dmat = ops.mats['dmat']
  got = cuda_stiffness3d.stiffness3d_general(us, gs, dmat)
  plain = cuda_stiffness3d.stiffness3d_general_plain(us, gs, dmat)
  ref = _general_ref64(ops, us, gs)
  torch.cuda.synchronize(dmat.device)
  return _errors(got, plain, ref)


def time_ms(fn, *, device, calls: int = 20, runs: int = 7, warmup: int = 10,
            device_only: bool = True) -> float:
  """Median over `runs` of the time of one call of `fn`, in ms.

  Each run times `calls` back-to-back calls between two CUDA events.  With
  `device_only` the device is first kept busy (``torch.cuda._sleep``) until
  the host has enqueued the whole run, so the events measure device time
  alone — the kernels and the gaps between them, without the host's
  dispatch cost.  Without it the time includes that cost, as an eager
  caller pays it.
  """
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize(device)
  samples = []
  sleep_cycles = 20_000_000  # ~10 ms at the H100's clock
  while len(samples) < runs:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if device_only:
      torch.cuda._sleep(sleep_cycles)  # pylint: disable=protected-access
    start.record()
    for _ in range(calls):
      fn()
    end.record()
    if device_only and start.query():
      # The device reached `start` before the host finished: a gap entered.
      torch.cuda.synchronize(device)
      sleep_cycles *= 2
      if sleep_cycles > 2_000_000_000:
        raise RuntimeError('the host could not enqueue a timed run while '
                           'the device slept')
      continue
    torch.cuda.synchronize(device)
    samples.append(start.elapsed_time(end) / calls)
  return statistics.median(samples)


def kernel_us(fn, symbol: str, *, device, calls: int = 20):
  """The mean device duration of the kernels whose name holds `symbol` over
  `calls` calls of `fn`, in microseconds, from the `torch.profiler` trace
  (CUPTI); None where the trace records no such kernel."""
  for _ in range(3):
    fn()
  torch.cuda.synchronize(device)
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
      fn()
    torch.cuda.synchronize(device)
  times = [e.device_time for e in prof.events() if symbol in e.name]
  return sum(times) / len(times) if times else None

#!/usr/bin/env python3
"""Drives the PyTorch port's main paths once on one CUDA card, and checks them.

The main paths are the Kolmogorov DNS datagen of swirlfem_tpu_torch at the
reference configuration (64x64 elements, order 8, BDF3, Re 2e4, dt 1e-4),
the 3D Taylor-Green vortex (Re 1600, 16^3 elements, order 7, BDF2, filter
0.05), the wall-graded heated cavity (the campaign's Ra 1e6 rung: 12x12
elements, order 7, grading 0.5, Pr 0.71, tol 3e-6), the lid-driven cavity
(16x16, order 7, Re 100, dt 1e-3) and the CG-solved 3D el step (16^3
elements, order 7, BDF2, filter 0.05) on the Taylor-Green box and on a
graded and sheared periodic box, all in float32.  Phases:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels (csrc/*.cu, nvcc, sm_90a);
  3. compare each kernel with its plain PyTorch version at the slice's
     shapes: exchange2d bitwise (one field, the step's two-field launch,
     and odd shapes: scalar rows, long rows, k = 2 and 10, float64, four
     fields), stiffness_uniform within 1e-5 of the float64 operator;
  4. run one 500-step datagen cycle through `run_simulation` (launch
     counters reset just before; the exchange launches a step logged);
  5. run 20 certified-solve steps (FDM-seeded viscous CG, which runs the
     stiffness kernel) and hold them against the exact-solve steps;
  6. run 20 steps on the card and the same 20 through the plain path on the
     CPU, from one state, and compare;
  7. time each kernel against its plain version (CUDA events): device
     time alone ("ms") and per eager call, dispatch included ("call_ms");
     the exchange's two-field launch against two one-field launches, and
     its duration from the profiler ("kernel_us");
  8. the 3D kernels against their plain versions and the float64 operator
     at 16^3 elements, order 7, 3 components; the general one also at
     k = 10 (order 9) on a 3^3 box;
  9. one 250-step TGV chunk through `run_tgv` (stiffness3d_uniform on every
     step, for the resolved dissipation), checked against the flow's
     known start (KE 1/8, dissipation 0.75/Re) and monotone decay;
 10. 20 more steps twice from that state, the second with the general
     operator (stiffness3d_general on the path): the dissipation series
     must agree;
 11. 20 TGV steps at 8^3 on the card and through the plain path on the CPU;
 12. time the 3D kernels against their plain versions and one library call
     (a GEMM of the dense operator; for the general operator one einsum);
 13. the 2D general and affine kernels against their plain versions and the
     float64 operator: general at n = 8, E = 144, C = 1 and 2 on the Ra 1e6
     box's own and on random factor fields, affine at n = 8, E = 256, C = 2
     on the vertex-graded box, both at the datagen shape (64^2, n = 9); the
     Kronecker-form function (the general kernel at C = 1) on the box's own
     factor fields and at the datagen shape, against its plain version and
     bitwise against the general kernel;
 14. the heated cavity at the Ra 1e6 rung through `run_cavity` (launch
     counters reset just before): every viscous CG matvec launches
     stiffness2d_general, every solve certifies in <= 2 iterations; then the
     viscous form of its final velocity through `stiffness2d_kron`;
 15. the lid-driven cavity on the vertex-graded box (stiffness2d_affine on
     every step) and 20 steps on the uniform box (stiffness_uniform);
 16. 20 steps of a 4x4, order-5 heated and lid-driven cavity on the card
     (float32) and through the plain path on the CPU (float64);
 17. time the 2D general, affine and Kronecker-form kernels against their
     plain versions and one library call (for the affine function one
     einsum of the same function, beside the GEMM of its stacked operator
     alone), at the paths' shapes and the datagen shape (the general and
     Kronecker-form ones there also in the kernels line, "datagen_ms"),
     with the general kernel's duration from the profiler, and the
     congruent kernel at the uniform lid-driven shape;
 18. the opt-in 3D stiffness kernels (dense, 3xTF32 within 1e-6; the
     bf16x3 pair, pair-general, pairz and pair-affine) against their plain
     versions and the float64 operator at 16^3 elements, order 7, 3
     components: on the Taylor-Green
     box, on the graded and sheared (affine) periodic box, and on random
     factor fields and coefficients; the superslab keys (pairs2, pairs4)
     bitwise the pair-general kernel's output; the pair-general and pairz
     kernels also at k = 10 (order 9), the congruent pair and pair-affine
     kernels at k = 9 and 10 (orders 8 and 9), on 3^3 boxes;
 19. the Taylor-Green box: certified steps (`exact_solves=False`, the FDM
     inverses as CG seeds) under the dense and the congruent pair key and,
     with `use_uniform_kernel=False`, under each general key (pair, pairz,
     pairs2, pairs4), held against the same steps under the fused congruent
     key;
 20. the affine box, which is not separable: CG-solved steps (Jacobi-CG
     with the stiffness at every iteration, projected pressure CG) under
     the affine-pair key and each general key against the fused general
     key, with the iteration counts and the launches per step;
 21. 3 CG-solved steps of a 4^3, order-7 affine box on the card (float32)
     and through the plain path on the CPU (float64), under the affine-pair,
     the general-pair and the pairz key;
 22. time the 3D kernels against their plain versions and their bound (the
     dense and the pair one also against one library GEMM of the same
     operator; the dense one's bound is its three TF32 passes over the
     TF32 tensor-core rate, its FP32-rate figure kept beside it; the
     pair-general and pairz kernels' counted bytes beside the bound's);
 23. the split-bf16 classes ('bf16x3', 'default') of the static-operator
     stiffness on the tensor cores, against their plain versions and the
     float64 operator: the congruent 2D operator on the dense split kernel
     at the datagen shape and on the uniform lid-driven box (through
     `Sem2DOps.stiffness_el_multi`), the affine one on the vertex-graded
     lid-driven box and at the datagen shape, the dense 3D one at 16^3,
     order 7, C = 3 ('bf16x3' within 1e-4, 'default' within 1e-2);
 24. 20 certified datagen steps at 'bf16x3' from phase 4's state, in turns
     with the same steps at 'highest';
 25. the lid-driven cavity at 'bf16x3' (200 vertex-graded, 20 uniform and
     20 Jacobi-CG vertex-graded steps) and at 'default' (20 steps on each
     box), against the same steps at 'highest';
 26. 10 certified TGV-box steps under ('congruent', 'dense') at 'bf16x3'
     against the same steps under the fused key;
 27. time the split kernels against their plain versions, their
     tensor-core bound and one FP32 library GEMM of the same operator (the
     affine ones also at the datagen shape, the congruent 2D ones also at
     the uniform lid-driven shape);
 28. one 3D stiffness apply at order 10 (k = 11, past every 3D kernel) on
     the card through `use_kernels=False`, against the float64 operator,
     and the kernels' refusal of it.

Each kernel's count is set to 0 just before the path that launches it and
read just after.  Every kernel's bound is the larger of its bytes (each
input read once, each output written once) over 3.35 TB/s and its
operations over 67 TFLOP/s (H100 SXM, FP32), or over 989 TFLOP/s (dense
bf16 tensor cores) for the split-bf16 and the bf16x3 pair kernels, or over
495 TFLOP/s (dense TF32 tensor cores) for the dense 3D kernel's passes.

Prints a JSON line of the kernels, the nvidia-smi line, and as its last
line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, on any failure or when no CUDA device is present.

Usage: python3 chip_smoke.py   (from the repository root, one GPU)
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time


_START = time.perf_counter()


def log(msg: str) -> None:
  """Prints `msg` after the seconds since the script started."""
  print(f'{time.perf_counter() - _START:7.1f}s {msg}', flush=True)


def require(cond, what) -> None:
  """Fails the run (raises) unless `cond` holds."""
  if not cond:
    raise RuntimeError(f'chip_smoke check failed: {what}')


def rel_err(a, b) -> float:
  """max |a - b| / max |b| over tensors or tuples of tensors."""
  if isinstance(a, (tuple, list)):
    return max(rel_err(x, y) for x, y in zip(a, b))
  a, b = a.double().cpu(), b.double().cpu()
  return float((a - b).abs().max() / b.abs().max())


def us_or_none(us) -> str:
  """A profiler duration in microseconds, or why there is none."""
  return 'not in the trace' if us is None else f'{us:.2f} us'


def all_finite(tree) -> bool:
  if isinstance(tree, (tuple, list)):
    return all(all_finite(t) for t in tree)
  return bool(tree.isfinite().all())


def steps(one_step, state, count):
  """Advances the el history `count` steps; returns (state, per-step aux)."""
  us, ps, cus = state
  auxes = []
  for _ in range(count):
    u, p, cu, aux = one_step(us, ps, cus)
    us, ps, cus = us[1:] + (u,), ps[1:] + (p,), cus[1:] + (cu,)
    auxes.append(aux)
  return (us, ps, cus), auxes


def to_device(state, device):
  if isinstance(state, (tuple, list)):
    return type(state)(to_device(s, device) for s in state)
  return state.to(device)


# Back-to-back calls of a plain version in one timed run: few, because a
# plain version of many launches would overflow the launch queue while the
# device is held back.
PLAIN_CALLS = 4


def time_kernels(timed, times, kernel_checks, device, tag) -> None:
  """Times each (kernel, plain, library) triple into `times[name]`."""
  for name, (kernel, plain, library) in timed.items():
    times[name] = {
        key: kernel_checks.time_ms(fn, device=device, device_only=dev_only,
                                   calls=calls)
        for key, fn, dev_only, calls in (
            ('ms', kernel, True, 20), ('plain_ms', plain, True, PLAIN_CALLS),
            ('call_ms', kernel, False, 20),
            ('plain_call_ms', plain, False, PLAIN_CALLS))}
    times[name]['library_ms'] = (
        None if library is None
        else kernel_checks.time_ms(library, device=device))
    lib = ('' if library is None else
           f'; library call {times[name]["library_ms"] * 1e3:.2f} us')
    log(f'{tag} {name}: device {times[name]["ms"] * 1e3:.2f} us (plain '
        f'{times[name]["plain_ms"] * 1e3:.2f} us{lib}); per eager call '
        f'{times[name]["call_ms"] * 1e3:.2f} us (plain '
        f'{times[name]["plain_call_ms"] * 1e3:.2f} us)')


def run_tgv_phases(torch, device, dtype, tgv, cuda_stiffness3d,
                   kernel_checks, times, launches) -> None:
  """Phases 8-12: the 3D Taylor-Green path and its two kernels.

  Fills `times` and `launches` for stiffness3d_uniform / _general; returns
  the solver, the random fields of the kernel checks and the run's result
  for the later 3D phases.
  """
  import dataclasses
  import numpy as np
  re, n_el, order, n_small = 1600.0, 16, 7, 8
  k = order + 1

  # -- 8. 3D kernels vs plain and the float64 operator ----------------------
  t0 = time.perf_counter()
  sem3 = tgv.create_tgv(n_el, order, dtype=dtype, device=device)
  ops3 = sem3.fast_ops
  log(f'[8] TGV solver setup {time.perf_counter() - t0:.2f} s: {n_el}^3 '
      f'elements, order {order}, c_uniform={ops3.c_uniform}, stiffness key '
      f'{ops3.stiffness_key}')
  require(ops3.c_uniform is not None, 'the TGV box must be congruent')
  num_e = n_el ** 3
  us3 = tuple(kernel_checks.random_field((k,) * 3 + (num_e,), dtype=dtype,
                                         device=device, seed=s)
              for s in (1, 2, 3))
  # Random factor fields make every cross term of the general operator
  # count (on the box's own fields they vanish).
  gs_rand = tuple(kernel_checks.random_field((k,) * 3 + (num_e,),
                                             dtype=dtype, device=device,
                                             seed=10 + s) for s in range(6))
  su = kernel_checks.check_stiffness3d_uniform(ops3, us3)
  sg = kernel_checks.check_stiffness3d_general(ops3, us3)
  sr = kernel_checks.check_stiffness3d_general(ops3, us3, gs_rand)
  log(f'[8] stiffness3d_general layout at k = {k}: '
      f'{cuda_stiffness3d.general3d_layout(k, us3[0].element_size())}')
  log(f'[8] stiffness3d_uniform 3 x {tuple(us3[0].shape)} f32: {su}')
  log(f'[8] stiffness3d_general, the box\'s factor fields: {sg}')
  log(f'[8] stiffness3d_general, random factor fields: {sr}')
  # k = 10 (order 9), the largest order, on a 3^3 box (E = 27, ragged
  # against the 8-element tiles): the box's own and random factor fields.
  ops10 = tgv.create_tgv(3, 9, dtype=dtype, device=device).fast_ops
  us10 = tuple(kernel_checks.random_field((10,) * 3 + (27,), dtype=dtype,
                                          device=device, seed=30 + s)
               for s in range(3))
  gs10 = tuple(kernel_checks.random_field((10,) * 3 + (27,), dtype=dtype,
                                          device=device, seed=40 + s)
               for s in range(6))
  checks10 = [kernel_checks.check_stiffness3d_general(ops10, us10, gs_)
              for gs_ in (None, gs10)]
  for which, check in zip(("the box's", 'random'), checks10):
    log(f'[8] stiffness3d_general k = 10, 3 x {tuple(us10[0].shape)} f32, '
        f'{which} factor fields: {check}')
  for check in (su, sg, sr, *checks10):
    require(check['rel_err_f64'] <= kernel_checks.STIFFNESS_REL_TOL, check)

  # -- 9. one TGV chunk (the 3D main path) ----------------------------------
  cuda_stiffness3d.stiffness3d_uniform.launches = 0
  cuda_stiffness3d.stiffness3d_general.launches = 0
  torch.cuda.synchronize(device)
  t0 = time.perf_counter()
  r = tgv.run_tgv(re=re, n_el=n_el, order=order, alpha=0.05, time_order=2,
                  steps_per_chunk=250, num_chunks=1, dtype=dtype,
                  device=device)
  torch.cuda.synchronize(device)
  wall = time.perf_counter() - t0
  uni = cuda_stiffness3d.stiffness3d_uniform.launches
  launches['stiffness3d_uniform'] = uni
  ke, diss = r['ke'], r['dissipation']
  log(f'[9] TGV chunk of {r["steps"]} steps, dt {r["dt"]:.6f}: '
      f'{r["wall_s"] / r["steps"] * 1e3:.4f} ms/step (host clock over the '
      f'chunk, first chunk, synchronized; {wall:.2f} s with setup); '
      f'KE {ke[0]:.6f} -> {ke[-1]:.6f}, eps(0) {diss[0]:.7e} '
      f'(0.75/Re = {0.75 / re:.7e}), cg max iters {r["cg_max_iters"]}, '
      f'stiffness3d_uniform launches {uni}')
  require(all_finite((r['us'], r['ps'], r['cus'])), 'non-finite TGV state')
  require(bool(np.all(np.diff(ke) < 0)), 'TGV kinetic energy must decay')
  require(abs(ke[0] - 0.125) < 2e-3, ke[0])
  require(abs(diss[0] - 0.75 / re) < 0.02 * 0.75 / re, diss[0])
  require(r['cg_max_iters'] < 100, r['cg_max_iters'])
  require(uni >= r['steps'], f'stiffness3d_uniform launched {uni} times '
          f'in {r["steps"]} steps')

  # -- 10. the general kernel on the path -----------------------------------
  full = r['sem']
  general = dataclasses.replace(full, fast_ops=dataclasses.replace(
      full.fast_ops, use_uniform_kernel=False))
  state = (r['us'], r['ps'], r['cus'])
  series = {}
  for name, sem_v in (('uniform', full), ('general', general)):
    advance, _ = tgv.make_advance(sem_v, mu=1.0 / re, dt=r['dt'],
                                  time_order=2, alpha=0.05,
                                  steps_per_chunk=20)
    cuda_stiffness3d.stiffness3d_general.launches = 0
    series[name] = advance(*state)
    if name == 'general':
      launches['stiffness3d_general'] = (
          cuda_stiffness3d.stiffness3d_general.launches)
  d_u = series['uniform'][1][1].double().cpu()
  d_g = series['general'][1][1].double().cpu()
  d_rel = float((d_g - d_u).abs().max() / d_u.abs().max())
  u_rel = rel_err(series['general'][0][0][-1], series['uniform'][0][0][-1])
  log(f'[10] 20 steps, general vs congruent stiffness: dissipation rel '
      f'{d_rel:.3e}, velocity rel {u_rel:.3e}; stiffness3d_general '
      f'launches {launches["stiffness3d_general"]}')
  require(launches['stiffness3d_general'] >= 20,
          'the general-operator steps never launched stiffness3d_general')
  require(d_rel <= 1e-5, d_rel)

  # -- 11. card vs the CPU plain path, 8^3 ----------------------------------
  outs = []
  for dev in (device, torch.device('cpu')):
    sem_s = tgv.create_tgv(n_small, order, dtype=dtype, device=dev)
    advance, conv = tgv.make_advance(sem_s, mu=1.0 / re, dt=r['dt'],
                                     time_order=2, alpha=0.05,
                                     steps_per_chunk=20)
    outs.append(advance(*tgv.initial_state(sem_s, conv, 2)))
  (card_state, card_diag), (cpu_state, cpu_diag) = outs
  du = rel_err(card_state[0][-1], cpu_state[0][-1])
  dp = rel_err(card_state[1][-1], cpu_state[1][-1])
  dd = rel_err(card_diag[1], cpu_diag[1])
  log(f'[11] 20 TGV steps at {n_small}^3, card vs CPU plain path (f32): '
      f'u rel {du:.3e}, p rel {dp:.3e}, dissipation rel {dd:.3e}')
  # Both sides round in float32 in different summation orders.  The
  # pressure is solved to a 1e-5 relative residual and its second defect
  # sweep may fire on one side only, which moves p further than u.
  require(du <= 1e-4, du)
  require(dp <= 1e-2, dp)

  # -- 12. 3D kernel times ---------------------------------------------------
  table, dmat = ops3.mats['table'], ops3.mats['dmat']
  gs = ops3.gs()
  a_dense = torch.as_tensor(
      cuda_stiffness3d.uniform_amat3d_np(ops3.c_uniform, ops3.w1, ops3.dmat),
      dtype=dtype, device=device)
  ustack = torch.cat([u.reshape(k ** 3, -1) for u in us3], dim=1)
  timed = {
      'stiffness3d_uniform': (
          lambda: cuda_stiffness3d.stiffness3d_uniform(us3, table),
          lambda: cuda_stiffness3d.stiffness3d_uniform_plain(us3, table),
          # One GEMM of the dense (k^3, k^3) operator on the (k^3, C E)
          # stack: the same function, by the library.
          lambda: torch.matmul(a_dense, ustack)),
      # One einsum of the axis derivatives, the factor fields and the
      # components: the same function, by the library.
      'stiffness3d_general': (
          lambda: cuda_stiffness3d.stiffness3d_general(us3, gs, dmat),
          lambda: cuda_stiffness3d.stiffness3d_general_plain(us3, gs, dmat),
          kernel_checks.library_general(us3, gs, dmat)),
  }
  time_kernels(timed, times, kernel_checks, device, '[12]')
  dofs = len(us3) * k ** 3 * num_e  # bench.py:394 counts 3 k^3 E
  itemsize = us3[0].element_size()
  for name, uniform, extra in (('stiffness3d_uniform', True, table.numel()),
                               ('stiffness3d_general', False, dmat.numel())):
    flops, nbytes = cuda_stiffness3d.stiffness3d_counts(
        order, num_e, len(us3), variant='uniform' if uniform else 'general',
        dtype_bytes=itemsize)
    times[name].update(kernel_checks.bound(flops, nbytes + extra * itemsize))
    times[name]['max_abs_err'] = (su if uniform else
                                  max(sg, sr, key=lambda c: c['max_abs_err'])
                                  )['max_abs_err']
    t = times[name]['ms'] * 1e-3
    log(f'[12] {name}: {dofs / t / 1e9:.3f} GDOF/s ({dofs} dofs), '
        f'{flops / t / 1e12:.3f} TFLOP/s, {nbytes / t / 1e12:.3f} TB/s; '
        f'bound {times[name]["bound_ms"] * 1e3:.2f} us '
        f'({times[name]["bound_by"]})')
  return sem3, us3, r


def affine_box(premesh):
  """The periodic unit cube graded per axis and sheared (the box of
  tests/test_pallas.py:384-392 and experiments/bench_dense3d.py:133-139):
  every element stays a parallelepiped, the box is not separable."""
  import numpy as np
  c = np.asarray(premesh.node_coords, dtype=np.float64).copy()
  c[:, 0] = c[:, 0] + 0.15 * c[:, 0] ** 2
  c[:, 1] = c[:, 1] + 0.10 * c[:, 1] ** 2
  c[:, 0] += 0.3 * c[:, 1] + 0.1 * c[:, 2]
  c[:, 1] += 0.2 * c[:, 2]
  return premesh.replace(node_coords=c)


def cg_solved_steps(torch, tgv, sem, state, count, *, mu, dt, tol, atol,
                    maxiter, seeded, alpha=0.05):
  """`count` BDF2 steps of `stokes_one_step_el(exact_solves=False)` from the
  el history `state` = (us, ps, cus).

  `seeded` takes the FDM el inverses as CG seeds (separable boxes); without
  them the viscous solve is Jacobi-CG and the pressure solve projected CG.
  Returns the history, the time per step (host clock over the loop, solver
  setup excluded, synchronized), the per-step (viscous, pressure) CG
  iterations and the kinetic-energy and dissipation series (read once, at
  the end).
  """
  from swirlfem_tpu_torch.nse.solver import extk_coeffs
  vp, pp = sem.fdm_el_preconditioners(mu, dt, 2) if seeded else (None, None)
  vol = float(sem.fast_ops.wmass.double().sum())
  sem = sem.slim_for_el_step()
  ke_fn, diss_fn = tgv.make_diagnostics(sem, mu, vol=vol)
  ext = [float(c) for c in extk_coeffs(k=1)]
  us, ps, cus = state
  iters, kes, disses = [], [], []
  sync = torch.cuda.synchronize if us[-1][0].is_cuda else lambda: None
  sync()
  t0 = time.perf_counter()
  for _ in range(count):
    f_el = tuple(-(ext[0] * a + ext[1] * b) for a, b in zip(*cus))
    u, p, aux = sem.stokes_one_step_el(
        list(us), list(ps), f_el, mu=mu, dt=dt, time_order=2, alpha=alpha,
        tol=tol, atol=atol, maxiter=maxiter, pressure_preconditioner_el=pp,
        viscous_preconditioner_el=vp, exact_solves=False)
    us, ps = us[1:] + (u,), ps[1:] + (p,)
    cus = cus[1:] + (convection_el(sem, u),)
    iters.append((aux['u_star_info']['num_iterations'],
                  aux['dp_info']['num_iterations']))
    kes.append(ke_fn(u))
    disses.append(diss_fn(u))
  sync()
  return {'state': (us, ps, cus),
          'ms_per_step': (time.perf_counter() - t0) / count * 1e3,
          'iters': [(int(v), int(p)) for v, p in iters],
          'ke': torch.stack(kes).double().cpu().numpy(),
          'dissipation': torch.stack(disses).double().cpu().numpy()}


def convection_el(sem, u_el):
  """The dealiased convection covector of an el-form velocity tuple."""
  shape = u_el[0].shape
  info = sem.fast_ops.vinfo
  flat = (info.order + 1,) * 3 + (info.num_elements_per_dim ** 3,)
  outs = sem.fast_ops.convection_el(*[c.reshape(flat) for c in u_el])
  return tuple(o.reshape(shape) for o in outs)


def with_knobs(sem, **knobs):
  """`sem` with the stiffness kernel knobs of its `fast_ops` replaced."""
  import dataclasses
  return dataclasses.replace(sem, fast_ops=dataclasses.replace(
      sem.fast_ops, **knobs))


def run_variant_phases(torch, device, dtype, tgv, cuda_stiffness3d,
                       kernel_checks, times, launches, sem3, us3,
                       tgv_run) -> None:
  """Phases 18-22: the opt-in 3D stiffness kernels (dense; the bf16x3 pair,
  pair-general, pairz and pair-affine) and the CG-solved 3D el step that
  runs them.

  `sem3`, `us3` and `tgv_run` are the Taylor-Green solver, the random fields
  and the run of phases 8-9.  Fills `times` and `launches` for the five
  kernels.
  """
  import dataclasses
  import numpy as np
  from swirlfem_tpu_torch.nse.solver import StokesSEM
  from swirlfem_tpu_torch.ops.fdm_pressure import is_separable_box
  from swirlfem_tpu_torch.utils.box import unit_cube_mesh
  re, n_el, order = 1600.0, 16, 7
  mu = 1.0 / re
  k = order + 1
  num_e = n_el ** 3
  wrappers = {name: getattr(cuda_stiffness3d, name) for name in (
      'stiffness3d_dense', 'stiffness3d_pair', 'stiffness3d_pair_general',
      'stiffness3d_pairz_general', 'stiffness3d_pair_affine')}
  # The general pair-layout keys and the kernel each launches (the
  # superslab keys run pair's kernel).
  general_keys = (('pair', 'stiffness3d_pair_general'),
                  ('pairz', 'stiffness3d_pairz_general'),
                  ('pairs2', 'stiffness3d_pair_general'),
                  ('pairs4', 'stiffness3d_pair_general'))

  def reset():
    for wrapper in wrappers.values():
      wrapper.launches = 0

  def periodic_affine(n, dev, dt_, order_=order):
    return StokesSEM.create(
        affine_box(unit_cube_mesh(n, ndim=3, periodic_dims=(0, 1, 2))), {},
        order=order_, device=dev, dtype=dt_)

  # -- 18. the kernels vs plain and the float64 operator --------------------
  t0 = time.perf_counter()
  sem_a = periodic_affine(n_el, device, dtype)
  ops3, ops_a = sem3.fast_ops, sem_a.fast_ops
  log(f'[18] affine box setup {time.perf_counter() - t0:.2f} s: {n_el}^3 '
      f'elements, order {order}, c_uniform={ops_a.c_uniform}, g_affine '
      f'{None if ops_a.g_affine is None else tuple(ops_a.g_affine.shape)}, '
      f'separable {is_separable_box(sem_a)}')
  require(ops_a.c_uniform is None and ops_a.g_affine is not None,
          'the graded and sheared box must be detected affine')
  require(not is_separable_box(sem_a), 'the affine box must not be separable')
  require(sem_a.fdm_el_preconditioners(mu, 1e-3, 2) == (None, None),
          'a box that is not separable has no FDM inverse')
  field = lambda seed, shape: kernel_checks.random_field(
      shape, dtype=dtype, device=device, seed=seed)
  gs_rand = tuple(field(10 + s, (k,) * 3 + (num_e,)) for s in range(6))
  c_rand = field(20, (6, num_e))
  general_checks = lambda zeta: [
      kernel_checks.check_stiffness3d_pair_general(ops3, us3, zeta=zeta),
      kernel_checks.check_stiffness3d_pair_general(ops_a, us3, zeta=zeta),
      kernel_checks.check_stiffness3d_pair_general(ops3, us3, gs_rand,
                                                   zeta=zeta)]
  checks = {
      'stiffness3d_dense': [
          kernel_checks.check_stiffness3d_dense(ops3, us3)],
      'stiffness3d_pair': [kernel_checks.check_stiffness3d_pair(ops3, us3)],
      # The Taylor-Green box's, the affine box's and random factor fields
      # (the random ones catch a wrong fragment-to-point map).
      'stiffness3d_pair_general': general_checks(False),
      'stiffness3d_pairz_general': general_checks(True),
      # The affine box's and random coefficients.
      'stiffness3d_pair_affine': [
          kernel_checks.check_stiffness3d_pair_affine(ops_a, us3),
          kernel_checks.check_stiffness3d_pair_affine(ops_a, us3, c_rand)],
  }
  low, high = kernel_checks.PAIR_BAND
  for name, results in checks.items():
    for result in results:
      log(f'[18] {name} 3 x {tuple(us3[0].shape)} f32: {result}')
      if name == 'stiffness3d_dense':
        # 'highest' as 3xTF32: the class's gate, and the FP32 class's
        # reading (~3e-7), which a kernel that lost a TF32 pass (~5e-4)
        # misses.
        require(result['rel_err_f64'] <= kernel_checks.STIFFNESS_REL_TOL,
                (name, result))
        require(result['rel_err_f64'] <= kernel_checks.DENSE_REL_TOL,
                (name, result))
        continue
      # The bf16x3 pair kernels: their plain version within 1e-6 (the
      # congruent pair) or the split tolerance (the slab pipelines), the
      # float64 operator inside the pair kernels' band, above the FP32
      # class's reading (the JAX package's gate is ~1e-5).
      require(result['rel_err_plain'] <= kernel_checks.PAIR_VS_PLAIN_TOL.get(
          name, kernel_checks.SPLIT_VS_PLAIN_TOL), (name, result))
      require(low < result['rel_err_f64'] <= high, (name, result))
  # The superslab keys through the dispatch: pair_general's kernel, bitwise.
  for gops, gs_ in ((ops3, None), (ops3, gs_rand)):
    base = dataclasses.replace(gops, use_uniform_kernel=False,
                               general_kernel_impl='pair')
    if gs_ is not None:
      base = dataclasses.replace(base, g11=gs_[0], g12=gs_[1], g13=gs_[2],
                                 g22=gs_[3], g23=gs_[4], g33=gs_[5])
    want = base.stiffness_el_multi(us3)
    for impl in ('pairs2', 'pairs4'):
      got = dataclasses.replace(base, general_kernel_impl=impl
                               ).stiffness_el_multi(us3)
      same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
      log(f'[18] {impl} on {"random" if gs_ is not None else "the box"}\'s '
          f'factor fields: bitwise pair_general\'s output: {same}')
      require(same, f'{impl} differs from pair_general')
  # k = 10 (order 9), the largest order the general pair kernels take, on a
  # 3^3 box (E = 27, ragged against their 8-element tiles), under the same
  # gates: the box's own and random factor fields.
  ops10 = tgv.create_tgv(3, 9, dtype=dtype, device=device).fast_ops
  us10 = tuple(field(30 + s, (10,) * 3 + (27,)) for s in range(3))
  gs10 = tuple(field(40 + s, (10,) * 3 + (27,)) for s in range(6))
  for name, zeta in (('stiffness3d_pair_general', False),
                     ('stiffness3d_pairz_general', True)):
    for gs_ in (None, gs10):
      result = kernel_checks.check_stiffness3d_pair_general(ops10, us10, gs_,
                                                            zeta=zeta)
      which = 'random' if gs_ is not None else "the box's"
      log(f'[18] {name} k = 10, 3 x {tuple(us10[0].shape)} f32, {which} '
          f'factor fields: {result}')
      require(result['rel_err_plain'] <= kernel_checks.SPLIT_VS_PLAIN_TOL,
              (name, 'k = 10', result))
      require(low < result['rel_err_f64'] <= high, (name, 'k = 10', result))
  # The congruent pair and the pair-affine kernel at k = 9 and 10 (orders 8
  # and 9), on 3^3 boxes: the Taylor-Green box, and the affine box's own and
  # random coefficients.
  for order_k in (8, 9):
    kk = order_k + 1
    ops_k = tgv.create_tgv(3, order_k, dtype=dtype, device=device).fast_ops
    ops_ak = periodic_affine(3, device, dtype, order_k).fast_ops
    us_k = tuple(field(50 + s, (kk,) * 3 + (27,)) for s in range(3))
    for name, result in (
        ('stiffness3d_pair', kernel_checks.check_stiffness3d_pair(ops_k,
                                                                  us_k)),
        *(('stiffness3d_pair_affine',
           kernel_checks.check_stiffness3d_pair_affine(ops_ak, us_k, c_))
          for c_ in (None, field(60, (6, 27))))):
      log(f'[18] {name} k = {kk}, 3 x {tuple(us_k[0].shape)} f32: {result}')
      require(result['rel_err_plain'] <= kernel_checks.PAIR_VS_PLAIN_TOL.get(
          name, kernel_checks.SPLIT_VS_PLAIN_TOL), (name, kk, result))
      require(low < result['rel_err_f64'] <= high, (name, kk, result))

  # -- 19. the Taylor-Green box: certified steps under each key -------------
  count = 10
  dt = tgv_run['dt']
  full = tgv_run['sem']
  state = (tgv_run['us'], tgv_run['ps'], tgv_run['cus'])
  solve = dict(mu=mu, dt=dt, tol=1e-5, atol=1e-6, maxiter=100)
  runs = {}
  certified = {'state': state, 'solve': solve, 'count': count}
  for label, knobs, name in (
      ('fused', {}, None),
      ('dense', dict(uniform_kernel_impl='dense'), 'stiffness3d_dense'),
      ('pair', dict(uniform_kernel_impl='pair'), 'stiffness3d_pair'),
      *((f'general {impl}', dict(use_uniform_kernel=False,
                                 general_kernel_impl=impl), wname)
        for impl, wname in general_keys)):
    sem_v = with_knobs(full, **knobs)
    reset()
    runs[label] = cg_solved_steps(torch, tgv, sem_v, state, count,
                                  seeded=True, **solve)
    n_launch = wrappers[name].launches if name else 0
    if name in ('stiffness3d_dense', 'stiffness3d_pair'):
      launches[name] = n_launch
    r, base = runs[label], runs['fused']
    u_rel = rel_err(r['state'][0][-1], base['state'][0][-1])
    d_rel = float(np.abs(r['dissipation'] - base['dissipation']).max()
                  / np.abs(base['dissipation']).max())
    log(f'[19] TGV box, {count} certified steps under '
        f'{sem_v.fast_ops.stiffness_key}: {r["ms_per_step"]:.4f} ms/step, CG '
        f'iterations (viscous, pressure) {r["iters"]}, vs fused: velocity rel '
        f'{u_rel:.3e}, dissipation rel {d_rel:.3e}'
        + (f', {name} launches {n_launch}' if name else ''))
    require(all_finite(r['state']), f'non-finite state under {label}')
    require(max(v for v, _ in r['iters']) <= 2, r['iters'])
    # The dissipation, a quadratic form of the stiffness on the smooth
    # Taylor-Green field, magnifies the class's rounding where the operator
    # is congruent: the congruent pair key reads ~2e-3 (as the dense key at
    # bf16x3 in phase 26); every other key ~5e-6.
    d_tol = 1e-2 if label == 'pair' else 1e-4
    require(u_rel <= 1e-4 and d_rel <= d_tol, (label, u_rel, d_rel))
    if name:
      require(n_launch >= count, f'{name} launched {n_launch} times in '
              f'{count} steps')

  # -- 20. the affine box: CG-solved steps ----------------------------------
  # The Taylor-Green field at the UNWARPED coordinates is single-valued
  # under the periodic identification; both boxes share the el layout.
  count = 3
  dt_a = tgv.default_dt(sem_a)
  u0 = tgv.tgv_initial(sem3)
  m = ops_a.pinfo.order + 1
  p0 = torch.zeros((m,) * 3 + (n_el,) * 3, dtype=dtype, device=device)
  cu0 = convection_el(sem_a.slim_for_el_step(), u0)
  state_a = ((u0, u0), (p0, p0), (cu0, cu0))
  ke_fn, _ = tgv.make_diagnostics(sem_a, mu)
  ke0 = float(ke_fn(u0))
  solve = dict(mu=mu, dt=dt_a, tol=1e-5, atol=1e-6, maxiter=300)
  runs = {}
  for label, knobs, name in (
      ('general fused', {}, None),
      ('affine pair', dict(use_affine_kernel=True),
       'stiffness3d_pair_affine'),
      *((f'general {impl}', dict(general_kernel_impl=impl), wname)
        for impl, wname in general_keys)):
    sem_v = with_knobs(sem_a, **knobs)
    reset()
    cuda_stiffness3d.stiffness3d_general.launches = 0
    runs[label] = cg_solved_steps(torch, tgv, sem_v, state_a, count,
                                  seeded=False, **solve)
    wrapper = (wrappers[name] if name
               else cuda_stiffness3d.stiffness3d_general)
    n_launch = wrapper.launches
    if name and label in ('affine pair', 'general pair', 'general pairz'):
      launches[name] = n_launch
    r, base = runs[label], runs['general fused']
    u_rel = rel_err(r['state'][0][-1], base['state'][0][-1])
    p_rel = rel_err(r['state'][1][-1], base['state'][1][-1])
    log(f'[20] affine box, dt {dt_a:.6f}, {count} CG-solved steps under '
        f'{sem_v.fast_ops.stiffness_key}: {r["ms_per_step"]:.2f} ms/step, CG '
        f'iterations (viscous, pressure) {r["iters"]} (maxiter '
        f'{solve["maxiter"]}), '
        f'{wrapper.__name__} launches {n_launch} '
        f'({n_launch / count:.1f}/step), KE {ke0:.6f} -> '
        f'{[round(float(v), 6) for v in r["ke"]]}; vs general fused: '
        f'velocity rel {u_rel:.3e}, pressure rel {p_rel:.3e}')
    require(all_finite(r['state']), f'non-finite state under {label}')
    require(bool(np.all(np.diff(np.concatenate([[ke0], r['ke']])) < 0)),
            'the kinetic energy must decay')
    # One launch for CG's initial residual, one per iteration, one for the
    # dissipation.
    require(n_launch >= sum(v for v, _ in r['iters']) + 2 * count,
            f'{wrapper.__name__} launched {n_launch} times')
    require(min(v for v, _ in r['iters']) >= 1,
            'Jacobi-CG must iterate on a box without an FDM inverse')
    # The bf16x3 keys' iteration counts are logged, not held to the fused
    # key's: the class's field split makes the operator slightly nonlinear
    # in CG's directions (tests/test_torch_cg_step3d.py and
    # test_torch_pair_split.py hold them within one of the JAX package's
    # under the same key).
    # The unpreconditioned pressure CG is cut at its cap long before it
    # converges, and a truncated float32 Krylov iterate is sensitive to
    # rounding: kernels whose operators agree to 2e-7 (phase 18) give
    # states that differ at the 1e-3 to 1e-2 level after three steps, as
    # any two rounding orders do.  Phases 19 and 21 hold the converged
    # step tightly.
    require(u_rel <= 5e-2, (label, u_rel))

  # One more step under the affine-pair key, under the profiler: where the
  # CG-solved step's time goes.
  from swirlfem_tpu_torch.niles.profile_datagen import profile_steps
  sem_p = with_knobs(sem_a, use_affine_kernel=True)
  prof = profile_steps(
      lambda: cg_solved_steps(torch, tgv, sem_p, runs['affine pair']['state'],
                              1, seeded=False, **solve), 1, device, rows=12)
  require(prof is not None, 'the profiler saw no device kernel')
  log(f'[20] profiled CG-solved step: {prof["launches_per_step"]:.0f} kernel '
      f'launches, device busy {prof["busy_ms_per_step"]:.3f} ms of '
      f'{prof["wall_ms_per_step"]:.3f} ms ({100 * prof["busy_share"]:.1f} %)')

  # -- 21. card (float32) vs the CPU plain path (float64), 4^3 --------------
  n_small = 4
  for knobs in (dict(use_affine_kernel=True),
                dict(general_kernel_impl='pair'),
                dict(general_kernel_impl='pairz')):
    outs = []
    for dev, dt_, tol_ in ((device, dtype, 1e-6),
                           (torch.device('cpu'), torch.float64, 1e-9)):
      sem_s = with_knobs(periodic_affine(n_small, dev, dt_), **knobs)
      u_s = tgv.tgv_initial(tgv.create_tgv(n_small, order, dtype=dt_,
                                           device=dev))
      p_s = torch.zeros((m,) * 3 + (n_small,) * 3, dtype=dt_, device=dev)
      cu_s = convection_el(sem_s.slim_for_el_step(), u_s)
      outs.append(cg_solved_steps(
          torch, tgv, sem_s, ((u_s, u_s), (p_s, p_s), (cu_s, cu_s)), 3,
          mu=mu, dt=dt_a * n_el / n_small, tol=tol_, atol=0.0, maxiter=1000,
          seeded=False))
    card, cpu = outs
    du = rel_err(card['state'][0][-1], cpu['state'][0][-1])
    dp = rel_err(card['state'][1][-1], cpu['state'][1][-1])
    log(f'[21] 3 CG-solved steps at {n_small}^3 under '
        f'{sem_s.fast_ops.stiffness_key}, card (f32, tol 1e-6) vs CPU plain '
        f'path (f64, tol 1e-9): u rel {du:.3e}, p rel {dp:.3e}; CG '
        f'iterations card {card["iters"]}, CPU {cpu["iters"]}')
    # The card's solves stop at a 1e-6 relative residual in float32, the
    # pressure one unpreconditioned after ~200 iterations.
    require(du <= 5e-4, du)
    require(dp <= 1e-2, dp)

  # -- 22. times of the kernels --------------------------------------------
  amat_t = ops3.dense_operator_t()
  a2, ptab = ops3.pair_operators()
  dp_a, at_w, atab = ops_a.pair_affine_operators()
  dp = ops_a.pair_derivative_split()
  dmat = ops_a.mats['dmat']
  gs_a = ops_a.gs()
  a_dense = amat_t.T.contiguous()
  ustack = torch.cat([u.reshape(k ** 3, -1) for u in us3], dim=1)
  cs3 = cuda_stiffness3d
  # The congruent operator by the library: one FP32 GEMM of the dense
  # (k^3, k^3) matrix on the (k^3, C E) stack of the components.  The dense
  # and the pair kernel both compute this function.
  library_gemm = lambda: torch.matmul(a_dense, ustack)
  # The general and affine functions by the library: one einsum of the
  # axis derivatives, the factor fields (or the per-element coefficients
  # and the weights) and the components.
  library_general = kernel_checks.library_general(us3, gs_a, dmat)
  library_affine = kernel_checks.library_pair_affine(
      us3, ops_a.g_affine, torch.as_tensor(ops_a.w1, dtype=dtype,
                                           device=device), dmat)
  tf32 = ops3.dense_tf32()
  timed = {
      'stiffness3d_dense': (
          lambda: cs3.stiffness3d_dense(us3, amat_t, tf32),
          lambda: cs3.stiffness3d_dense_plain(us3, amat_t), library_gemm),
      'stiffness3d_pair': (
          lambda: cs3.stiffness3d_pair(us3, a2, ptab),
          lambda: cs3.stiffness3d_pair_plain(us3, a2, ptab), library_gemm),
      'stiffness3d_pair_general': (
          lambda: cs3.stiffness3d_pair_general(us3, gs_a, dp, dmat),
          lambda: cs3.stiffness3d_pair_general_plain(us3, gs_a, dp, dmat),
          library_general),
      'stiffness3d_pairz_general': (
          lambda: cs3.stiffness3d_pairz_general(us3, gs_a, dp, dmat),
          lambda: cs3.stiffness3d_pairz_general_plain(us3, gs_a, dp,
                                                      dmat), library_general),
      'stiffness3d_pair_affine': (
          lambda: cs3.stiffness3d_pair_affine(
              us3, ops_a.g_affine, dp_a, at_w, atab,
              at_frags=ops_a.pair_affine_fragments()),
          lambda: cs3.stiffness3d_pair_affine_plain(us3, ops_a.g_affine, dp_a,
                                                    at_w, atab),
          library_affine),
  }
  time_kernels(timed, times, kernel_checks, device, '[22]')
  itemsize = us3[0].element_size()
  for name in timed:
    variant = name[len('stiffness3d_'):]
    # The function's least work (FP32 operations) and bytes: the fields,
    # the factor fields or coefficients, and the (k, k) D of the
    # sum-factorized variants (the dense one reads its operator).
    flops, nbytes = cs3.stiffness3d_counts(
        order, num_e, len(us3), variant=variant, dtype_bytes=itemsize)
    if variant != 'dense':
      nbytes += dmat.numel() * itemsize
    times[name].update(kernel_checks.bound(flops, nbytes))
    if variant == 'dense':
      # 3xTF32 on the tensor cores: every pass over the TF32 rate; the FP32
      # FFMA yardstick of its first version kept beside it.
      fp32_ms = times[name]['bound_ms']
      times[name].update(kernel_checks.bound(
          3 * flops, nbytes, kernel_checks.H100_TF32_TC_FLOP_PER_S))
      times[name]['fp32_bound_ms'] = fp32_ms
      log(f'[22] {name}: 3xTF32 bound {times[name]["bound_ms"] * 1e3:.2f} us '
          f'({times[name]["bound_by"]}: 3 x {flops / 1e9:.3f} GFLOP over '
          f'495 TFLOP/s; {nbytes / 1e6:.1f} MB over 3.35 TB/s); at the FP32 '
          f'FFMA rate {fp32_ms * 1e3:.2f} us; vs float64 '
          f'{max(c["rel_err_f64"] for c in checks[name]):.3e}')
      require(all(c['rel_err_f64'] <= kernel_checks.DENSE_REL_TOL
                  for c in checks[name]), checks[name])
    times[name]['max_abs_err'] = max(c['max_abs_err'] for c in checks[name])
    t = times[name]['ms'] * 1e-3
    issued = ''
    if variant != 'dense':
      tc_flops = cs3.stiffness3d_tensor_core_flops(order, num_e, len(us3),
                                                   variant=variant)
      issued = (f' (tensor cores issue {tc_flops / t / 1e12:.3f} TFLOP/s, '
                'three passes and the Kronecker zeros)')
    log(f'[22] {name}: {flops / t / 1e12:.3f} TFLOP/s of the function\'s '
        f'work{issued}, {nbytes / t / 1e12:.3f} TB/s; bound '
        f'{times[name]["bound_ms"] * 1e3:.2f} us ({times[name]["bound_by"]})')
    if variant in ('pair_general', 'pairz_general'):
      # The bytes the kernel's design moves, beside the bound's.
      grid = cs3.pair_columns_grid(
          num_e, k, torch.cuda.get_device_properties(device
                                                     ).multi_processor_count,
          cs3._pair_columns_blocks_per_sm(  # pylint: disable=protected-access
              k, 'zeta' if variant == 'pairz_general' else 'xi', device))
      traffic = cs3.pair_columns_traffic(order, num_e, len(us3), grid,
                                         dtype_bytes=itemsize)
      log(f'[22] {name}: counted bytes: {traffic["device"] / 1e6:.1f} MB '
          f'from and to device memory (the bound\'s {nbytes / 1e6:.1f} MB, '
          f'{traffic["device"] / kernel_checks.H100_BYTES_PER_S * 1e6:.2f} '
          f'us), {traffic["factor_rereads"] / 1e6:.1f} MB of factor-field '
          f're-reads and {traffic["operators"] / 1e6:.2f} MB of operator '
          f'staging from the L1/L2 ({grid} persistent blocks)')
  return certified


def run_walled_phases(torch, device, dtype, kernel_checks, times,
                      launches) -> None:
  """Phases 13-17: the walled 2D path (heated and lid-driven cavities) and
  its two kernels.  Fills `times` and `launches` for stiffness2d_general /
  _affine."""
  import numpy as np
  from swirlfem_tpu_torch.core.bc import BCType
  from swirlfem_tpu_torch.examples import cavity as cav
  from swirlfem_tpu_torch.examples import natural_convection as nc
  from swirlfem_tpu_torch.nse.solver import StokesSEM
  from swirlfem_tpu_torch.ops import cuda_stiffness
  from swirlfem_tpu_torch.ops import cuda_stiffness2d
  from swirlfem_tpu_torch.utils.box import unit_cube_mesh
  ra, rung = 1e6, nc.RUNGS[1e6]
  tol = 3e-6  # the campaign's float32 setting

  def fields(ops, count, seed):
    k = ops.vinfo.order + 1
    num_e = ops.vinfo.num_elements_per_dim ** 2
    return tuple(kernel_checks.random_field((k, k, num_e), dtype=dtype,
                                            device=device, seed=seed + s)
                 for s in range(count))

  def sine_graded_box(n_el, order):
    pm = unit_cube_mesh(n_el, ndim=2)
    return StokesSEM.create(
        pm, {'boundary': (BCType.DIRICHLET, 0.0)}, order=order,
        coord_transform=lambda rp: nc.sine_grading(
            np.asarray(rp.node_coords), 0.5), device=device, dtype=dtype)

  # -- 13. 2D general / affine kernels vs plain and the float64 operator ----
  t0 = time.perf_counter()
  general = sine_graded_box(rung['n_el'], rung['order']).fast_ops
  affine = cav.make_cavity(16, 7, grading=0.5, device=device,
                           dtype=dtype).fast_ops
  general64 = sine_graded_box(64, 8).fast_ops
  affine64 = cav.make_cavity(64, 8, grading=0.5, device=device,
                             dtype=dtype).fast_ops
  log(f'[13] setup {time.perf_counter() - t0:.2f} s: stiffness keys '
      f'{general.stiffness_key}, {affine.stiffness_key} (64^2: '
      f'{general64.stiffness_key}, {affine64.stiffness_key})')
  require(general.stiffness_key[0] == 'general' == general64.stiffness_key[0],
          'the sine-graded boxes must take the general class')
  require(affine.stiffness_key[0] == 'affine' == affine64.stiffness_key[0],
          'the vertex-graded boxes must take the affine class')
  checks = {}
  for c in (1, 2):
    us = fields(general, c, 1)
    checks[f'general C={c}'] = kernel_checks.check_stiffness2d_general(
        general, us)
    checks[f'general C={c} random'] = kernel_checks.check_stiffness2d_general(
        general, us, fields(general, 3, 10))
  checks['affine C=2'] = kernel_checks.check_stiffness2d_affine(
      affine, fields(affine, 2, 1))
  checks['general 64^2 C=2'] = kernel_checks.check_stiffness2d_general(
      general64, fields(general64, 2, 1))
  checks['affine 64^2 C=2'] = kernel_checks.check_stiffness2d_affine(
      affine64, fields(affine64, 2, 1))
  # The Kronecker-form function (the general kernel at C = 1) on the box's
  # own factor fields and at the datagen shape: the general kernel's bits.
  checks['kron'] = kernel_checks.check_stiffness2d_kron(
      general, fields(general, 1, 1)[0])
  checks['kron 64^2'] = kernel_checks.check_stiffness2d_kron(
      general64, fields(general64, 1, 1)[0])
  for name, check in checks.items():
    log(f'[13] stiffness2d {name}: {check}')
    require(check['rel_err_f64'] <= kernel_checks.STIFFNESS_REL_TOL,
            (name, check))
    if name.startswith('kron'):
      require(check['vs_general_max_abs'] == 0.0, (name, check))

  # -- 14. the heated cavity, Ra 1e6 rung (the walled main path) ------------
  steps = 200
  cuda_stiffness2d.stiffness2d_general.launches = 0
  torch.cuda.synchronize(device)
  t0 = time.perf_counter()
  r = nc.run_cavity(ra, dtype=dtype, tol=tol, max_steps=steps,
                    steps_per_dispatch=steps // 2, device=device, **rung)
  torch.cuda.synchronize(device)
  wall = time.perf_counter() - t0
  gen = cuda_stiffness2d.stiffness2d_general.launches
  launches['stiffness2d_general'] = gen
  log(f'[14] heated cavity Ra {ra:.0e} {rung}, float32, dt {r["dt"]:.4e}: '
      f'{r["steps"]} steps, {r["ms_per_step_steady"]:.4f} ms/step (host '
      f'clock, second chunk; {wall:.2f} s with setup); Nu volume '
      f'{r["nu_volume"]:.6f}, hot {r["nu_hot"]:.6f}, cold {r["nu_cold"]:.6f}'
      f', u_max {r["u_max"]:.4f}; cg max iterations {r["cg_max_iters"]}; '
      f'stiffness2d_general launches {gen} ({gen / r["steps"]:.2f}/step)')
  require(all_finite((r['u'], r['p'], r['theta'])),
          'non-finite heated-cavity state')
  require(all(math.isfinite(r[k]) for k in ('nu_volume', 'nu_hot',
                                            'nu_cold')), r)
  require(gen >= r['steps'], f'stiffness2d_general launched {gen} times in '
          f'{r["steps"]} steps')
  require(max(r['cg_max_iters'].values()) <= 2, r['cg_max_iters'])
  # The cavity's viscous form on its final velocity through the
  # Kronecker-form function, as a caller of `stiffness2d_kron` applies it,
  # against the solver's own stiffness apply (the general kernel).
  sem_c = r['sem']
  ops_c = sem_c.fast_ops
  u_el = tuple(sem_c._v_el(r['u'][..., i])  # pylint: disable=protected-access
               for i in range(r['u'].shape[-1]))
  cuda_stiffness2d.stiffness2d_kron.launches = 0
  kron_out = tuple(cuda_stiffness2d.stiffness2d_kron(
      u, ops_c.g11, ops_c.g12, ops_c.g22, ops_c.mats['dmat']) for u in u_el)
  launches['stiffness2d_kron'] = cuda_stiffness2d.stiffness2d_kron.launches
  solver_out = ops_c.stiffness_el_multi(u_el)
  form = sum(float((a.double() * u.double()).sum())
             for a, u in zip(kron_out, u_el))
  log(f'[14] viscous form of the final velocity through stiffness2d_kron: '
      f'{form:.9e}, {launches["stiffness2d_kron"]} launches; vs the '
      f'solver\'s stiffness apply: max abs '
      f'{max(float((a - b).abs().max()) for a, b in zip(kron_out, solver_out))}')
  require(rel_err(kron_out, solver_out) <= 1e-6,
          'stiffness2d_kron differs from the solver\'s general kernel')
  require(launches['stiffness2d_kron'] == len(u_el) and form > 0,
          (launches['stiffness2d_kron'], form))

  # -- 15. the lid-driven cavity: vertex-graded (affine), then uniform ------
  for grading, name, count, kernel in (
      (0.5, 'stiffness2d_affine', 200, cuda_stiffness2d.stiffness2d_affine),
      (0.0, 'stiffness_uniform', 20, cuda_stiffness.stiffness_uniform)):
    sem = cav.make_cavity(16, 7, grading=grading, device=device, dtype=dtype)
    step = cav.make_step(sem, reynolds=100.0, dt=1e-3)
    state = cav.initial_state(sem, step.u_boundary)
    kernel.launches = 0
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(count):
      state, aux = step(*state)
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) / count * 1e3
    n_launch = kernel.launches
    if grading:
      launches[name] = n_launch
    u = state[0][-1] + step.u_boundary
    log(f'[15] lid-driven cavity 16x16 order 7 Re 100, grading {grading} '
        f'({sem.fast_ops.stiffness_key[0]}): {count} steps, {ms:.4f} '
        f'ms/step, u_max {float(u.abs().max()):.6f}, last step iterations '
        f'{aux["u_star_info"]["num_iterations"]}/'
        f'{aux["dp_info"]["num_iterations"]}, {name} launches {n_launch}')
    require(all_finite(state), 'non-finite lid-driven state')
    require(abs(float(u.abs().max()) - 1.0) < 1e-3, 'the lid moves at 1')
    require(n_launch >= count, f'{name} launched {n_launch} times in '
            f'{count} steps')

  # -- 16. card (float32) vs the CPU plain path (float64), small boxes ------
  cpu = torch.device('cpu')
  outs = []
  for dev, dt_, tol_ in ((device, dtype, tol), (cpu, torch.float64, 1e-9)):
    rr = nc.run_cavity(1e5, n_el=4, order=5, grading=0.5, dtype=dt_,
                       tol=tol_, max_steps=20, steps_per_dispatch=20,
                       device=dev)
    sem = cav.make_cavity(4, 5, grading=0.5, device=dev, dtype=dt_)
    u, p, _ = cav.run_cavity(sem, reynolds=100.0, dt=1e-3, num_steps=20)
    outs.append({'nc u': rr['u'], 'nc p': rr['p'], 'nc theta': rr['theta'],
                 'lid u': u, 'lid p': p})
  errs = {key: rel_err(outs[0][key], outs[1][key]) for key in outs[0]}
  log('[16] 20 steps, 4x4 order 5, card (f32) vs CPU plain path (f64): '
      + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()))
  for key, err in errs.items():
    require(err <= 1e-4, (key, err))

  # -- 17. 2D kernel times ---------------------------------------------------
  us_g = fields(general, 2, 1)
  us_a = fields(affine, 2, 1)
  gs = (general.g11, general.g12, general.g22)
  dmat = general.mats['dmat']
  mstack = affine.mats['mstack']
  k2 = mstack.shape[1]

  def same_function(ops, us):
    """One PyTorch call of the affine function (the three operators, the
    components and the per-element scalars in one einsum), and the GEMM of
    the stacked operator alone, without the combination: the floor any
    library route pays."""
    m3 = ops.mats['mstack'].view(3, k2, k2)
    u_kce = torch.stack([u.reshape(k2, -1) for u in us], dim=1)
    u_gemm = u_kce.reshape(k2, -1)
    return (lambda: torch.einsum('sij,jce,se->ice', m3, u_kce, ops.g_affine),
            lambda: torch.matmul(ops.mats['mstack'], u_gemm))

  affine_library, affine_gemm = same_function(affine, us_a)
  timed = {
      # One einsum of the axis derivatives, the factor fields and the
      # components (for the Kronecker form, of its one component).
      'stiffness2d_general': (
          lambda: cuda_stiffness2d.stiffness2d_general(us_g, gs, dmat),
          lambda: cuda_stiffness2d.stiffness2d_general_plain(us_g, gs, dmat),
          kernel_checks.library_general(us_g, gs, dmat)),
      'stiffness2d_affine': (
          lambda: affine.stiffness_el_multi(us_a),
          lambda: cuda_stiffness2d.stiffness2d_affine_plain(
              us_a, affine.g_affine, mstack),
          affine_library),
      # One component through the Kronecker-form function; its plain
      # version is the Kronecker form itself.
      'stiffness2d_kron': (
          lambda: cuda_stiffness2d.stiffness2d_kron(us_g[0], *gs, dmat),
          lambda: cuda_stiffness2d.stiffness2d_kron_plain(us_g[0], *gs, dmat),
          kernel_checks.library_general(us_g[:1], gs, dmat)),
  }
  time_kernels(timed, times, kernel_checks, device, '[17]')
  times['stiffness2d_affine']['gemm_only_ms'] = kernel_checks.time_ms(
      affine_gemm, device=device)
  log(f'[17] stiffness2d_affine library floor: the GEMM of the stacked '
      f'operator alone {times["stiffness2d_affine"]["gemm_only_ms"] * 1e3:.2f}'
      f' us (the same function in one einsum '
      f'{times["stiffness2d_affine"]["library_ms"] * 1e3:.2f} us)')
  for name, symbol in (('stiffness2d_general', 'stiffness2d_general_kernel'),
                       ('stiffness2d_kron', 'stiffness2d_general_kernel')):
    times[name]['kernel_us'] = kernel_checks.kernel_us(
        timed[name][0], symbol, device=device)
    log(f'[17] {name}: kernel {us_or_none(times[name]["kernel_us"])} '
        f'(profiler)')
  itemsize = us_g[0].element_size()
  for name, ops, us, is_affine, check in (
      ('stiffness2d_general', general, us_g, False, checks['general C=2']),
      ('stiffness2d_affine', affine, us_a, True, checks['affine C=2']),
      ('stiffness2d_kron', general, us_g[:1], False, checks['kron'])):
    flops, nbytes = cuda_stiffness2d.stiffness2d_counts(
        ops.vinfo.order, us[0].shape[-1], len(us), affine=is_affine,
        dtype_bytes=itemsize)
    times[name].update(kernel_checks.bound(flops, nbytes))
    times[name]['max_abs_err'] = check['max_abs_err']
    rate = flops / (times[name]['ms'] * 1e-3) / 1e12
    log(f'[17] {name} at the path shape {tuple(us[0].shape)} x {len(us)}: '
        f'bound {times[name]["bound_ms"] * 1e3:.3f} us '
        f'({times[name]["bound_by"]}), {rate:.4f} TFLOP/s')
  # The congruent kernel at the uniform lid-driven shape (16^2, order 7,
  # C = 2), beside its library GEMM and bound.
  uniform = cav.make_cavity(16, 7, device=device, dtype=dtype).fast_ops
  us_u = fields(uniform, 2, 1)
  lid = kernel_checks.check_stiffness_uniform(uniform, us_u)
  require(lid['rel_err_f64'] <= kernel_checks.STIFFNESS_REL_TOL, lid)
  amat = uniform.mats['amat']
  u_gemm = torch.cat([u.reshape(k2, -1) for u in us_u], dim=1)
  lid_ms = kernel_checks.time_ms(lambda: uniform.stiffness_el_multi(us_u),
                                 device=device)
  lid_lib = kernel_checks.time_ms(lambda: torch.matmul(amat, u_gemm),
                                  device=device)
  b = kernel_checks.bound(2 * k2 * k2 * 256 * 2,
                          (k2 * k2 + 2 * 2 * k2 * 256) * itemsize)
  times['stiffness_uniform'].update(lid_ms=lid_ms, lid_library_ms=lid_lib,
                                    lid_bound_ms=b['bound_ms'])
  log(f'[17] stiffness_uniform at the uniform lid-driven shape (8, 8, 256) '
      f'x 2: {lid_ms * 1e3:.2f} us (library GEMM {lid_lib * 1e3:.2f} us), '
      f'bound {b["bound_ms"] * 1e3:.3f} us ({b["bound_by"]}); vs float64 '
      f'{lid["rel_err_f64"]:.3e}')
  # The datagen shape (64^2, n = 9, C = 2), beside the congruent kernel.
  us64 = fields(general64, 2, 1)
  gs64 = (general64.g11, general64.g12, general64.g22)
  k2 = 81
  library64, gemm64 = same_function(affine64, us64)
  at_datagen = {
      'general': lambda: cuda_stiffness2d.stiffness2d_general(
          us64, gs64, general64.mats['dmat']),
      'affine': lambda: affine64.stiffness_el_multi(us64),
      'kron': lambda: cuda_stiffness2d.stiffness2d_kron(
          us64[0], *gs64, general64.mats['dmat'])}
  for name, fn in at_datagen.items():
    num_c = 1 if name == 'kron' else 2
    flops, nbytes = cuda_stiffness2d.stiffness2d_counts(
        8, 4096, num_c, affine=name == 'affine', dtype_bytes=itemsize)
    b = kernel_checks.bound(flops, nbytes)
    lib = ''
    if name == 'affine':
      lib = (f'; the same function in one einsum '
             f'{kernel_checks.time_ms(library64, device=device) * 1e3:.2f} '
             f'us, the GEMM alone '
             f'{kernel_checks.time_ms(gemm64, device=device) * 1e3:.2f} us')
    t_64 = kernel_checks.time_ms(fn, device=device)
    own = ''
    if name in ('general', 'kron'):
      # Rows 3 and 5 at the datagen shape, in the kernels line.
      own_us = kernel_checks.kernel_us(fn, 'stiffness2d_general_kernel',
                                       device=device)
      times[f'stiffness2d_{name}'].update(
          datagen_ms=t_64, datagen_kernel_us=own_us,
          datagen_bound_ms=b['bound_ms'])
      own = f' (kernel {us_or_none(own_us)}, profiler)'
    log(f'[17] stiffness2d_{name} at the datagen shape (9, 9, 4096) x '
        f'{num_c}: {t_64 * 1e3:.2f} us{own}, '
        f'bound {b["bound_ms"] * 1e3:.3f} us ({b["bound_by"]}){lib}')
  return {'affine': affine, 'affine64': affine64, 'uniform': uniform}


def run_split_phases(torch, device, dtype, tgv, kernel_checks, times,
                     launches, dg, walled, tgv_box) -> None:
  """Phases 23-27: the split-bf16 classes ('bf16x3', 'default') of the
  static-operator stiffness on the tensor cores.

  `dg` holds the datagen solver, config, phase 4's end state and phase 3's
  fields; `walled` the lid-driven boxes' operators; `tgv_box` the
  Taylor-Green solver, phase 19's start state and solve settings and the
  random fields of phase 8.  Each split-class run is timed in the same
  phase as the same steps at 'highest' (the fused key on the TGV box).
  Fills `times` and `launches` for the five split entries.
  """
  import dataclasses
  import numpy as np
  from swirlfem_tpu_torch.examples import cavity as cav
  from swirlfem_tpu_torch.niles import datagen
  from swirlfem_tpu_torch.ops import cuda_split
  from swirlfem_tpu_torch.ops import cuda_stiffness
  from swirlfem_tpu_torch.ops import cuda_stiffness3d
  uniform_split = cuda_split.stiffness_uniform_split
  affine_split = cuda_split.stiffness2d_affine_split
  dense_split = cuda_split.stiffness3d_dense_split
  classes = ('bf16x3', 'default')

  def at(ops, precision):
    return dataclasses.replace(ops, kernel_precision=precision)

  # -- 23. the split kernels vs plain and the float64 operator --------------
  sem3 = tgv_box['full']
  ops3 = sem3.fast_ops
  us3 = tgv_box['us3']
  affine, affine64 = walled['affine'], walled['affine64']
  k16 = affine.vinfo.order + 1
  us_lid = tuple(kernel_checks.random_field(
      (k16, k16, affine.g_affine.shape[1]), dtype=dtype, device=device,
      seed=s) for s in (1, 2))
  checks = {}
  for precision in classes:
    checks[f'stiffness_uniform_{precision}'] = (
        kernel_checks.check_stiffness_uniform_split(
            at(dg['sem'].fast_ops, precision), dg['us']), '64^2 order 8',
        '~1e-5')
    checks[f'stiffness_uniform_{precision} 16^2'] = (
        kernel_checks.check_stiffness_uniform_split(
            at(walled['uniform'], precision), us_lid),
        'uniform lid-driven 16^2 order 7', '~1e-5')
    checks[f'stiffness2d_affine_{precision}'] = (
        kernel_checks.check_stiffness2d_affine_split(
            at(affine, precision), us_lid), 'lid-driven 16^2 order 7',
        '~1e-5')
    checks[f'stiffness2d_affine_{precision} 64^2'] = (
        kernel_checks.check_stiffness2d_affine_split(
            at(affine64, precision), dg['us']), '64^2 order 8', '~1e-5')
  checks['stiffness3d_dense_bf16x3'] = (
      kernel_checks.check_stiffness3d_dense_split(ops3, us3),
      '16^3 order 7 C=3', '2-3e-5')
  for name, (check, shape, jax_err) in checks.items():
    precision = 'default' if 'default' in name else 'bf16x3'
    low, high = kernel_checks.CLASS_BANDS[precision]
    log(f'[23] {name} at {shape}: kernel vs plain '
        f'{check["rel_err_plain"]:.3e} of the largest output; vs float64 '
        f'{check["rel_err_f64"]:.3e} (plain {check["plain_rel_err_f64"]:.3e};'
        f' the JAX package measured {jax_err} for bf16x3, ~3e-3 for '
        f'default); band ({low:g}, {high:g}]')
    require(check['rel_err_plain'] <= kernel_checks.SPLIT_VS_PLAIN_TOL,
            (name, check))
    require(low < check['rel_err_f64'] <= high, (name, check))

  # -- 24. certified datagen steps at 'bf16x3' ------------------------------
  # 'highest' and 'bf16x3' in turns from phase 4's state, so that the two
  # step times share the process's state and the host's load.
  count = 20
  runs = {'highest': [], 'bf16x3': []}
  for precision in ('highest', 'bf16x3', 'bf16x3', 'highest'):
    sem_p = with_knobs(dg['sem'], kernel_precision=precision)
    one_step = datagen.make_one_step(sem_p, dg['cfg'], exact_solves=False)
    uniform_split.launches = 0
    cuda_stiffness.stiffness_uniform.launches = 0
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    state_p, auxes = steps(one_step, dg['state'], count)
    torch.cuda.synchronize(device)
    runs[precision].append({
        'ms': (time.perf_counter() - t0) / count * 1e3, 'state': state_p,
        'iters': [int(aux['u_star_info']['num_iterations'])
                  for aux in auxes],
        'split': uniform_split.launches,
        'fp32': cuda_stiffness.stiffness_uniform.launches})
  split_run, base = runs['bf16x3'][-1], runs['highest'][-1]
  launches['stiffness_uniform_bf16x3'] = split_run['split']
  iters = split_run['iters']
  du = rel_err(split_run['state'][0][-1], base['state'][0][-1])
  dp = rel_err(split_run['state'][1][-1], base['state'][1][-1])
  log(f'[24] {count} certified datagen steps, in turns: highest '
      f'{[round(r["ms"], 4) for r in runs["highest"]]} ms/step, bf16x3 '
      f'{[round(r["ms"], 4) for r in runs["bf16x3"]]}; bf16x3 viscous CG '
      f'iterations {iters} ({sum(i > 0 for i in iters)} solves iterated; '
      f'highest {sum(i > 0 for i in base["iters"])}), split launches '
      f'{split_run["split"]}, FP32 stiffness_uniform launches '
      f'{split_run["fp32"]}; vs highest: u rel {du:.3e}, p rel {dp:.3e}')
  require(split_run['split'] > 0,
          'the bf16x3 steps never launched the split kernel')
  require(split_run['fp32'] == 0, 'the bf16x3 steps launched the FP32 kernel')
  require(max(iters) <= 2, iters)
  require(all_finite(split_run['state']), 'non-finite bf16x3 datagen state')
  require(du <= 1e-5, du)

  # -- 25. the lid-driven cavity at the split classes -----------------------
  def lid_run(sem, precision, count, fdm_viscous=True):
    sem_p = with_knobs(sem, kernel_precision=precision)
    step = cav.make_step(sem_p, reynolds=100.0, dt=1e-3,
                         fdm_viscous=fdm_viscous)
    state = cav.initial_state(sem_p, step.u_boundary)
    uniform_split.launches = affine_split.launches = 0
    iters = []
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(count):
      state, aux = step(*state)
      iters.append(aux['u_star_info']['num_iterations'])
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) / count * 1e3
    u = state[0][-1] + step.u_boundary
    require(all_finite(state), f'non-finite lid-driven state ({precision})')
    require(abs(float(u.abs().max()) - 1.0) < 1e-3, 'the lid moves at 1')
    return {'u': u, 'ms': ms, 'iters': [int(i) for i in iters],
            'launches': uniform_split.launches + affine_split.launches}

  boxes = {grading: cav.make_cavity(16, 7, grading=grading, device=device,
                                    dtype=dtype) for grading in (0.5, 0.0)}
  # Each class right after the same steps at 'highest', in one phase.
  for grading, count, fdm, precision in (
      (0.5, 200, True, 'bf16x3'), (0.0, 20, True, 'bf16x3'),
      (0.5, 20, False, 'bf16x3'), (0.5, 20, True, 'default'),
      (0.0, 20, True, 'default')):
    sem = boxes[grading]
    base = lid_run(sem, 'highest', count, fdm)
    r = lid_run(sem, precision, count, fdm)
    err = rel_err(r['u'], base['u'])
    label = (f'{"vertex-graded" if grading else "uniform"} box, '
             f'{"FDM-seeded" if fdm else "Jacobi"} viscous CG, {count} steps '
             f'at {precision}')
    log(f'[25] {label}: {r["ms"]:.4f} ms/step (highest {base["ms"]:.4f}), '
        f'viscous CG iterations {r["iters"][:5]}..{r["iters"][-3:]} (max '
        f'{max(r["iters"])}, highest max {max(base["iters"])}), split '
        f'launches {r["launches"]} ({r["launches"] / count:.2f}/step); vs '
        f'highest: u rel {err:.3e}')
    require(r['launches'] >= count, f'{label}: {r["launches"]} launches')
    # 'default' rounds operator and field to bf16 in every matvec (~4e-3),
    # and the viscous solve converges to that operator's answer: a
    # preconditioner-grade class, held to 5e-2 after 20 steps.
    require(err <= (1e-3 if precision == 'bf16x3' else 5e-2), (label, err))
    key = (f'{"stiffness2d_affine" if grading else "stiffness_uniform"}_'
           f'{precision}')
    if fdm and key not in launches:
      launches[key] = r['launches']

  # -- 26. certified TGV-box steps under ('congruent', 'dense') at bf16x3 ---
  count = tgv_box['count']
  sem_v = with_knobs(sem3, uniform_kernel_impl='dense',
                     kernel_precision='bf16x3')
  base = cg_solved_steps(torch, tgv, sem3, tgv_box['state'], count,
                         seeded=True, **tgv_box['solve'])
  dense_split.launches = 0
  cuda_stiffness3d.stiffness3d_dense.launches = 0
  r = cg_solved_steps(torch, tgv, sem_v, tgv_box['state'], count,
                      seeded=True, **tgv_box['solve'])
  n_split = dense_split.launches
  n_dense = cuda_stiffness3d.stiffness3d_dense.launches
  launches['stiffness3d_dense_bf16x3'] = n_split
  u_rel = rel_err(r['state'][0][-1], base['state'][0][-1])
  d_rel = float(np.abs(r['dissipation'] - base['dissipation']).max()
                / np.abs(base['dissipation']).max())
  # The dissipation is the stiffness's quadratic form on a smooth field,
  # where the operator's terms cancel to a small remainder: the class's
  # own rounding, ~1e-5 of the largest term, shows there as ~1e-3 at 16^3
  # (its float64 emulation, which equals the JAX kernel in interpret mode,
  # misses by as much).  So the kernel is held to the class's plain version
  # on the same velocity, and the series to the fused key at the class's
  # resolution.
  info = ops3.vinfo
  flat_shape = (info.order + 1,) * 3 + (info.num_elements_per_dim ** 3,)
  flat = tuple(c.reshape(flat_shape) for c in r['state'][0][-1])
  hi3, lo3 = ops3.dense_split()
  a64 = ops3.dense_operator_t().double().T
  form = lambda aus: sum(float((a.double() * u.double()).sum())
                         for a, u in zip(aus, flat))
  d_kernel = form(dense_split(flat, hi3, lo3, ops3.dense_bf16()))
  d_plain = form(cuda_split.stiffness_uniform_split_plain(flat, hi3, lo3, 3))
  d_64 = form(tuple((a64 @ u.double().reshape(a64.shape[0], -1))
                    .reshape(u.shape) for u in flat))
  log(f'[26] TGV box, {count} certified steps under '
      f'{sem_v.fast_ops.stiffness_key} at bf16x3: {r["ms_per_step"]:.4f} '
      f'ms/step (fused {base["ms_per_step"]:.4f}), CG iterations (viscous, '
      f'pressure) {r["iters"]}, split launches {n_split}, FP32 dense '
      f'launches {n_dense}; vs fused: velocity rel {u_rel:.3e}, '
      f'dissipation rel {d_rel:.3e}; last velocity\'s quadratic form vs the '
      f'float64 operator: kernel {abs(d_kernel - d_64) / abs(d_64):.3e}, '
      f'plain {abs(d_plain - d_64) / abs(d_64):.3e}, kernel vs plain '
      f'{abs(d_kernel - d_plain) / abs(d_64):.3e}')
  require(all_finite(r['state']), 'non-finite TGV-box state at bf16x3')
  require(max(v for v, _ in r['iters']) <= 2, r['iters'])
  require(u_rel <= 1e-4 and d_rel <= 1e-2, (u_rel, d_rel))
  require(abs(d_kernel - d_plain) <= 1e-3 * abs(d_64), (d_kernel, d_plain))
  require(n_split >= count and n_dense == 0, (n_split, n_dense))

  # -- 27. times of the split kernels ---------------------------------------
  tc = kernel_checks.H100_BF16_TC_FLOP_PER_S
  amat = dg['sem'].fast_ops.mats['amat']
  hi2, lo2 = at(dg['sem'].fast_ops, 'bf16x3').split_operator()
  hia, loa = at(affine, 'bf16x3').split_operator()
  fra = at(affine, 'bf16x3').split_fragments()
  hi3, lo3 = ops3.dense_split()
  lay3 = ops3.dense_bf16()
  mstack = affine.mats['mstack']
  a_dense = ops3.dense_operator_t().T.contiguous()
  stack = lambda us, rows: torch.cat([u.reshape(rows, -1) for u in us], 1)
  us2 = dg['us']
  k2, k3 = amat.shape[0], a_dense.shape[0]
  # The library yardsticks' operands, stacked once outside the timed call.
  u2_cat, lid_cat, u3_cat = (stack(us2, k2), stack(us_lid, k16 ** 2),
                             stack(us3, k3))
  cases = {}
  for precision, passes in cuda_split.PASSES.items():
    lay2 = at(dg['sem'].fast_ops, precision).dense_bf16()
    cases[f'stiffness_uniform_{precision}'] = (
        lambda p=passes, lay=lay2: uniform_split(us2, hi2, lo2, p, lay),
        lambda p=passes: cuda_split.stiffness_uniform_split_plain(
            us2, hi2, lo2, p),
        # The library yardstick: one FP32 GEMM of the operator on the
        # stacked components (the finest class of the same function).
        lambda: torch.matmul(amat, u2_cat),
        cuda_split.split_counts(k2, k2, us2[0].shape[-1], len(us2),
                                passes=passes))
    cases[f'stiffness2d_affine_{precision}'] = (
        lambda p=passes: affine_split(us_lid, affine.g_affine, hia, loa, p,
                                      fra),
        lambda p=passes: cuda_split.stiffness2d_affine_split_plain(
            us_lid, affine.g_affine, hia, loa, p),
        lambda: torch.matmul(mstack, lid_cat),
        cuda_split.split_counts(k16 ** 2, k16 ** 2, us_lid[0].shape[-1],
                                len(us_lid), passes=passes, num_blocks=3))
  cases['stiffness3d_dense_bf16x3'] = (
      lambda: dense_split(us3, hi3, lo3, lay3),
      lambda: cuda_split.stiffness_uniform_split_plain(us3, hi3, lo3, 3),
      lambda: torch.matmul(a_dense, u3_cat),
      cuda_split.split_counts(k3, k3, us3[0].shape[-1], len(us3), passes=3))
  time_kernels({name: c[:3] for name, c in cases.items()}, times,
               kernel_checks, device, '[27]')
  for name, (_, _, _, (flops, nbytes)) in cases.items():
    times[name].update(kernel_checks.bound(flops, nbytes, tc))
    times[name]['max_abs_err'] = checks[name][0]['max_abs_err']
    t = times[name]['ms'] * 1e-3
    log(f'[27] {name}: {flops / t / 1e12:.3f} TFLOP/s, '
        f'{nbytes / t / 1e12:.3f} TB/s; bound '
        f'{times[name]["bound_ms"] * 1e3:.3f} us ({times[name]["bound_by"]},'
        f' tensor cores)')
  # The congruent 2D kernels at the uniform lid-driven shape (16^2, order
  # 7, C = 2), where 'default' launches on its path, beside one FP32
  # library GEMM of the operator there.
  amat_lid = walled['uniform'].mats['amat']
  library_lid = kernel_checks.time_ms(
      lambda: torch.matmul(amat_lid, lid_cat), device=device)
  for precision, passes in cuda_split.PASSES.items():
    ops_lid = at(walled['uniform'], precision)
    hil, lol = ops_lid.split_operator()
    layl = ops_lid.dense_bf16()
    b = kernel_checks.bound(*cuda_split.split_counts(
        k16 ** 2, k16 ** 2, us_lid[0].shape[-1], len(us_lid),
        passes=passes), tc)
    ms = kernel_checks.time_ms(
        lambda p=passes: uniform_split(us_lid, hil, lol, p, layl),
        device=device)
    times[f'stiffness_uniform_{precision}']['lid_shape'] = {
        'ms': ms, 'library_ms': library_lid, **b}
    log(f'[27] stiffness_uniform_{precision} at the uniform lid-driven '
        f'shape (8, 8, 256) x 2: {ms * 1e3:.2f} us (library GEMM '
        f'{library_lid * 1e3:.2f} us), bound {b["bound_ms"] * 1e3:.3f} us '
        f'({b["bound_by"]})')
  # The affine kernels at the datagen shape, beside the congruent ones,
  # and the library GEMM of the stacked operator there.
  hi64, lo64 = at(affine64, 'bf16x3').split_operator()
  fr64 = at(affine64, 'bf16x3').split_fragments()
  mstack64 = affine64.mats['mstack']
  library64 = kernel_checks.time_ms(
      lambda: torch.matmul(mstack64, u2_cat), device=device)
  for precision, passes in cuda_split.PASSES.items():
    fn = lambda p=passes: affine_split(us2, affine64.g_affine, hi64, lo64, p,
                                       fr64)
    b = kernel_checks.bound(*cuda_split.split_counts(
        k2, k2, us2[0].shape[-1], len(us2), passes=passes, num_blocks=3), tc)
    ms = kernel_checks.time_ms(fn, device=device)
    times[f'stiffness2d_affine_{precision}']['datagen_shape'] = {
        'ms': ms, 'library_ms': library64, **b}
    log(f'[27] stiffness2d_affine_{precision} at the datagen shape (9, 9, '
        f'4096) x 2: {ms * 1e3:.2f} us (library GEMM of the stacked '
        f'operator {library64 * 1e3:.2f} us), bound '
        f'{b["bound_ms"] * 1e3:.3f} us ({b["bound_by"]})')


def run_knob_phase(torch, device, dtype) -> None:
  """Phase 28: one 3D stiffness apply at order 10 (k = 11, past every 3D
  kernel) on the card through `use_kernels=False`, against the float64
  operator; with the kernels on, the launch refuses it and names the knob."""
  import dataclasses
  import numpy as np
  from swirlfem_tpu_torch.nse.solver import StokesSEM
  from swirlfem_tpu_torch.ops import cuda_stiffness3d
  from swirlfem_tpu_torch.utils.box import unit_cube_mesh
  order, n_el = 10, 3
  sem = StokesSEM.create(unit_cube_mesh(n_el, ndim=3, periodic_dims=(0, 1, 2)),
                         {}, order=order, device=device, dtype=dtype,
                         use_kernels=False)
  ops = sem.fast_ops
  k = order + 1
  rng = np.random.default_rng(28)
  us64 = tuple(torch.as_tensor(rng.standard_normal((k,) * 3 + (n_el ** 3,)),
                               device=device) for _ in range(3))
  us = tuple(u.to(dtype) for u in us64)
  before = cuda_stiffness3d.stiffness3d_uniform.launches
  got = ops.stiffness_el_multi(us)
  torch.cuda.synchronize(device)
  launched = cuda_stiffness3d.stiffness3d_uniform.launches - before
  a64 = torch.as_tensor(cuda_stiffness3d.uniform_amat3d_np(
      ops.c_uniform, ops.w1, ops.dmat), device=device)
  ref = tuple((a64 @ u.reshape(k ** 3, -1)).reshape(u.shape) for u in us64)
  err = rel_err(got, ref)
  try:
    dataclasses.replace(ops, use_kernels=True).stiffness_el_multi(us)
    refusal = None
  except ValueError as exc:
    refusal = str(exc)
  log(f'[28] order {order} on a {n_el}^3 box, C = 3, use_kernels=False: '
      f'key {ops.stiffness_key}, kernel launches {launched}, vs float64 '
      f'{err:.3e}; with the kernels on: {refusal!r}')
  require(launched == 0, launched)
  require(all_finite(got) and err <= 1e-5, err)
  require(refusal is not None and 'use_kernels=False' in refusal, refusal)


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device', file=sys.stderr)
    return 1
  from swirlfem_tpu_torch.examples import taylor_green_3d as tgv
  from swirlfem_tpu_torch.niles import datagen
  from swirlfem_tpu_torch.ops import cuda_build
  from swirlfem_tpu_torch.ops import cuda_exchange
  from swirlfem_tpu_torch.ops import cuda_stiffness
  from swirlfem_tpu_torch.ops import cuda_stiffness3d
  from swirlfem_tpu_torch.ops import kernel_checks

  device = torch.device('cuda', 0)
  dtype = torch.float32

  # -- 1. the card -----------------------------------------------------------
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip()
  smi = smi.splitlines()[0]
  log(f'[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}')

  # -- 2. build --------------------------------------------------------------
  cuda_build.library()
  log(f'[2] kernels built/loaded in {cuda_build.build_seconds:.2f} s '
      f'({cuda_build.library_path()})')

  cfg = datagen.DatagenConfig(num_cycles=1)
  t0 = time.perf_counter()
  sem = datagen.build_solver(cfg, device=device, dtype=dtype)
  ops = sem.fast_ops
  log(f'[2] solver setup {time.perf_counter() - t0:.2f} s: '
      f'{cfg.resolution}x{cfg.resolution} elements, order {cfg.order}, '
      f'c_uniform={ops.c_uniform}')
  require(ops.c_uniform is not None, 'uniform box must be detected congruent')

  # -- 3. kernels vs plain at the slice's shapes ----------------------------
  k = cfg.order + 1
  n = cfg.resolution
  w = kernel_checks.random_field((k, k, n, n), dtype=dtype, device=device)
  ex = kernel_checks.check_exchange2d(w)
  log(f'[3] exchange2d {tuple(w.shape)} f32: {ex}')
  require(ex['bitwise_equal'], 'exchange2d differs from its plain version')
  # The step's two-field launch (the velocity's components) and odd shapes:
  # scalar rows (n1 not a multiple of the 16-byte chunk), rows of several
  # warps, k = 2 and 10, float64, four fields.
  w2 = (w, kernel_checks.random_field((k, k, n, n), dtype=dtype,
                                      device=device, seed=1))
  odd = {'2 fields': w2}
  for shape, dt_, count in (((5, 5, 3, 7), dtype, 3), ((2, 2, 1, 1), dtype, 1),
                            ((10, 10, 12, 20), torch.float64, 4),
                            ((3, 3, 37, 600), dtype, 2),
                            ((9, 9, 64, 64), torch.float64, 2)):
    odd[f'{count} x {shape} {dt_}'] = tuple(
        kernel_checks.random_field(shape, dtype=dt_, device=device, seed=s)
        for s in range(count))
  for name, fields in odd.items():
    check = kernel_checks.check_exchange2d(fields)
    log(f'[3] exchange2d {name}: {check}')
    require(check['bitwise_equal'], (name, check))
  del odd
  us = tuple(kernel_checks.random_field((k, k, n * n), dtype=dtype,
                                        device=device, seed=s)
             for s in (1, 2))
  st = kernel_checks.check_stiffness_uniform(ops, us)
  log(f'[3] stiffness_uniform 2 x {tuple(us[0].shape)} f32: {st}')
  require(st['rel_err_f64'] <= kernel_checks.STIFFNESS_REL_TOL, st)

  # -- 4. one datagen cycle (the main path) ---------------------------------
  have_h5py = importlib.util.find_spec('h5py') is not None
  if not have_h5py:
    log('[4] h5py not installed: frames are kept, no shard is written')
  cuda_exchange.exchange2d.launches = 0
  cuda_stiffness.stiffness_uniform.launches = 0
  with tempfile.TemporaryDirectory() as tmp:
    walls, sem, state = datagen.run_simulation(
        tmp if have_h5py else None, cfg, device=device, dtype=dtype)
    if have_h5py:
      log(f'[4] shards written: {os.listdir(tmp)}')
  exch_cycle = cuda_exchange.exchange2d.launches
  dx = datagen.min_node_spacing(sem.velocity.mesh)
  u_nodal = sem.velocity_from_el(state[0][-1])
  cfl = max(float(c.abs().max()) for c in u_nodal) * cfg.dt / dx
  ms_step = walls[0] / cfg.num_steps_per_cycle * 1e3
  log(f'[4] cycle of {cfg.num_steps_per_cycle} steps: {walls[0]:.3f} s, '
      f'{ms_step:.4f} ms/step, CFL {cfl:.5f}, exchange2d launches '
      f'{exch_cycle} ({exch_cycle / cfg.num_steps_per_cycle:.1f}/step: '
      f'one a distinct exchange, the components in one launch)')
  require(all_finite(state), 'non-finite datagen state')
  require(exch_cycle > 0, 'the datagen cycle never launched exchange2d')
  require(0 < cfl < 1, cfl)

  # -- 5. certified-solve steps ---------------------------------------------
  certified = datagen.make_one_step(sem, cfg, exact_solves=False)
  exact = datagen.make_one_step(sem, cfg, exact_solves=True)
  torch.cuda.synchronize(device)
  cuda_stiffness.stiffness_uniform.launches = 0
  t0 = time.perf_counter()
  cert_state, auxes = steps(certified, state, 20)
  torch.cuda.synchronize(device)
  ms_cert = (time.perf_counter() - t0) / 20 * 1e3
  stiff_launches = cuda_stiffness.stiffness_uniform.launches
  launches = {'exchange2d': exch_cycle, 'stiffness_uniform': stiff_launches}
  iters = [aux['u_star_info']['num_iterations'] for aux in auxes]
  exact_state, _ = steps(exact, state, 20)
  du = rel_err(cert_state[0][-1], exact_state[0][-1])
  dp = rel_err(cert_state[1][-1], exact_state[1][-1])
  log(f'[5] 20 certified steps: {ms_cert:.4f} ms/step, viscous CG '
      f'iterations {iters}, stiffness_uniform launches {stiff_launches}; '
      f'vs exact solves: u rel {du:.3e}, p rel {dp:.3e}')
  require(stiff_launches > 0, 'certified steps never launched the stiffness')
  require(max(iters) <= 2, iters)
  require(all_finite(cert_state), 'non-finite certified state')
  # The certified pressure solve drops increments whose residual is below
  # atol = 1e-4 (as the JAX step does), so p may differ by several percent;
  # the velocity must agree to float32 level over 20 steps.
  require(du <= 1e-4, du)

  # -- 6. card vs the CPU plain path ----------------------------------------
  cpu_sem = datagen.build_solver(cfg, device='cpu', dtype=dtype)
  cpu_out, _ = steps(datagen.make_one_step(cpu_sem, cfg),
                     to_device(state, 'cpu'), 20)
  du = rel_err(exact_state[0][-1], cpu_out[0][-1])
  dp = rel_err(exact_state[1][-1], cpu_out[1][-1])
  log(f'[6] 20 steps card vs CPU plain path (f32): u rel {du:.3e}, '
      f'p rel {dp:.3e}')
  # Both sides round in float32 in different summation orders.  The
  # velocity stays within ~2e-5 over 20 steps.  The pressure is solved to a
  # 1e-5 relative residual and its second defect sweep may fire on one side
  # only, which moves p by up to ~2e-3 (measured on an H100).
  require(du <= 1e-4, du)
  require(dp <= 1e-2, dp)

  # -- 7. kernel times vs plain ---------------------------------------------
  amat = sem.fast_ops.mats['amat']
  k2 = amat.shape[0]
  ustack = torch.cat([u.reshape(k2, -1) for u in us], dim=1)
  timed = {
      'exchange2d': (lambda: cuda_exchange.exchange2d(w),
                     lambda: cuda_exchange.exchange2d_plain(w), None),
      # The kernel through the solver's dispatch, as the path calls it.
      # The library yardstick: one GEMM of the dense operator on the
      # (k^2, C E) stack of the components.
      'stiffness_uniform': (
          lambda: sem.fast_ops.stiffness_el_multi(us),
          lambda: cuda_stiffness.stiffness_uniform_plain(us, amat),
          lambda: torch.matmul(amat, ustack)),
  }
  times = {}
  time_kernels(timed, times, kernel_checks, device, '[7]')
  # The exchange's two-field launch, as the step makes it, against two
  # one-field launches; beside each time between events, the kernel's own
  # duration from the profiler.
  ex_times = times['exchange2d']
  ex_times['two_field_ms'] = kernel_checks.time_ms(
      lambda: cuda_exchange.exchange2d(w2), device=device)
  ex_times['two_launches_ms'] = kernel_checks.time_ms(
      lambda: (cuda_exchange.exchange2d(w2[0]),
               cuda_exchange.exchange2d(w2[1])), device=device)
  ex_times['kernel_us'] = kernel_checks.kernel_us(
      lambda: cuda_exchange.exchange2d(w), 'exchange2d_kernel', device=device)
  ex_times['two_field_kernel_us'] = kernel_checks.kernel_us(
      lambda: cuda_exchange.exchange2d(w2), 'exchange2d_kernel',
      device=device)
  log(f'[7] exchange2d: two fields in one launch '
      f'{ex_times["two_field_ms"] * 1e3:.2f} us (kernel '
      f'{us_or_none(ex_times["two_field_kernel_us"])}), two one-field '
      f'launches {ex_times["two_launches_ms"] * 1e3:.2f} us; one field: '
      f'kernel {us_or_none(ex_times["kernel_us"])} (profiler)')
  # Bounds: the exchange moves the field in and out and adds 2k values per
  # element; the stiffness reads A and the components, writes the outputs,
  # and does 2 k^4 flops per element and component.
  num_e = us[0].shape[-1]
  flops = 2 * k2 ** 2 * num_e * len(us)
  times['exchange2d'].update(kernel_checks.bound(
      2 * k * n * n, 2 * w.numel() * w.element_size()))
  times['exchange2d']['two_field_bound_ms'] = kernel_checks.bound(
      4 * k * n * n, 4 * w.numel() * w.element_size())['bound_ms']
  times['stiffness_uniform'].update(kernel_checks.bound(
      flops, (k2 * k2 + 2 * len(us) * k2 * num_e) * amat.element_size()))
  # GDOF/s as the JAX bench counts them: nodal velocity dofs per apply
  # (bench.py:550); FLOP/s from the dense element operator's 2 k^4 E C.
  dofs = sem.velocity.mesh.num_nodes * sem.velocity.mesh.ndim
  t_st = times['stiffness_uniform']['ms']
  log(f'[7] stiffness_uniform apply, {n}x{n} order {cfg.order}, 2 '
      f'components: {dofs / t_st / 1e6:.3f} GDOF/s ({dofs} nodal dofs), '
      f'{flops / t_st / 1e9:.2f} TFLOP/s')

  sem3, us3, tgv_run = run_tgv_phases(torch, device, dtype, tgv,
                                      cuda_stiffness3d, kernel_checks, times,
                                      launches)
  walled = run_walled_phases(torch, device, dtype, kernel_checks, times,
                             launches)
  tgv_box = run_variant_phases(torch, device, dtype, tgv, cuda_stiffness3d,
                               kernel_checks, times, launches, sem3, us3,
                               tgv_run)
  tgv_box.update(full=tgv_run['sem'], us3=us3)
  dg = {'sem': sem, 'cfg': cfg, 'state': state, 'us': us}
  run_split_phases(torch, device, dtype, tgv, kernel_checks, times,
                   launches, dg, walled, tgv_box)
  run_knob_phase(torch, device, dtype)

  kernels = [
      {'name': 'exchange2d', 'route': 'cuda',
       'source': 'swirlfem_tpu_torch/csrc/exchange2d.cu',
       'replaces': 'swirlfem_tpu/ops/pallas_exchange.py:43',
       'launches': launches['exchange2d'],
       'max_abs_err': ex['max_abs_err'], **times['exchange2d']},
      {'name': 'stiffness_uniform', 'route': 'cuda',
       'source': 'swirlfem_tpu_torch/csrc/stiffness_uniform.cu',
       'replaces': 'swirlfem_tpu/ops/pallas_stiffness.py:323',
       'launches': launches['stiffness_uniform'],
       'max_abs_err': st['max_abs_err'], **times['stiffness_uniform']},
      {'name': 'stiffness2d_general', 'route': 'cuda',
       'source': 'swirlfem_tpu_torch/csrc/stiffness2d_general.cu',
       'replaces': 'swirlfem_tpu/ops/pallas_stiffness.py:165',
       'launches': launches['stiffness2d_general'],
       **times['stiffness2d_general']},
      {'name': 'stiffness2d_affine', 'route': 'cuda',
       'source': 'swirlfem_tpu_torch/csrc/stiffness2d_affine.cu',
       'replaces': 'swirlfem_tpu/ops/pallas_stiffness.py:409',
       'launches': launches['stiffness2d_affine'],
       **times['stiffness2d_affine']},
      # The Kronecker-form function: the general kernel at C = 1.  No
      # solver key reaches it (as in the JAX package): its launches are
      # those of phase 14's direct call on the cavity's final velocity.
      {'name': 'stiffness2d_kron', 'route': 'cuda',
       'source': 'swirlfem_tpu_torch/csrc/stiffness2d_general.cu',
       'replaces': 'swirlfem_tpu/ops/pallas_stiffness.py:87',
       'launches': launches['stiffness2d_kron'],
       'launched_by': 'direct call after the Ra 1e6 cavity run',
       **times['stiffness2d_kron']},
      {'name': 'stiffness3d_uniform', 'route': 'cuda',
       'source': 'swirlfem_tpu_torch/csrc/stiffness3d_uniform.cu',
       'replaces': 'swirlfem_tpu/ops/pallas_stiffness3d.py:238',
       'launches': launches['stiffness3d_uniform'],
       **times['stiffness3d_uniform']},
      {'name': 'stiffness3d_general', 'route': 'cuda',
       'source': 'swirlfem_tpu_torch/csrc/stiffness3d_general.cu',
       'replaces': 'swirlfem_tpu/ops/pallas_stiffness3d.py:926',
       'launches': launches['stiffness3d_general'],
       **times['stiffness3d_general']},
      {'name': 'stiffness3d_pair_affine', 'route': 'cuda',
       'source': 'swirlfem_tpu_torch/csrc/stiffness3d_pair_affine.cu',
       'replaces': 'swirlfem_tpu/ops/pallas_stiffness3d.py:707',
       'launches': launches['stiffness3d_pair_affine'],
       **times['stiffness3d_pair_affine']},
      {'name': 'stiffness3d_dense', 'route': 'cuda',
       'source': 'swirlfem_tpu_torch/csrc/stiffness3d_dense.cu',
       'replaces': 'swirlfem_tpu/ops/pallas_stiffness3d.py:65',
       'launches': launches['stiffness3d_dense'],
       **times['stiffness3d_dense']},
      {'name': 'stiffness3d_pair', 'route': 'cuda',
       'source': 'swirlfem_tpu_torch/csrc/stiffness3d_pair.cu',
       'replaces': 'swirlfem_tpu/ops/pallas_stiffness3d.py:328',
       'launches': launches['stiffness3d_pair'],
       **times['stiffness3d_pair']},
      # Also the superslab keys' kernel (pallas_stiffness3d.py:587).
      {'name': 'stiffness3d_pair_general', 'route': 'cuda',
       'source': 'swirlfem_tpu_torch/csrc/stiffness3d_pair_general.cu',
       'replaces': 'swirlfem_tpu/ops/pallas_stiffness3d.py:449',
       'launches': launches['stiffness3d_pair_general'],
       **times['stiffness3d_pair_general']},
      {'name': 'stiffness3d_pairz_general', 'route': 'cuda',
       'source': 'swirlfem_tpu_torch/csrc/stiffness3d_pair_general.cu',
       'replaces': 'swirlfem_tpu/ops/pallas_stiffness3d.py:865',
       'launches': launches['stiffness3d_pairz_general'],
       **times['stiffness3d_pairz_general']},
  ]
  # The split-bf16 classes on the tensor cores (the congruent 2D and 3D
  # operators on one dense split kernel).
  for name, source, replaces in (
      ('stiffness_uniform_bf16x3', 'stiffness3d_dense_split.cu',
       'pallas_stiffness.py:298'),
      ('stiffness_uniform_default', 'stiffness3d_dense_split.cu',
       'pallas_stiffness.py:277'),
      ('stiffness2d_affine_bf16x3', 'stiffness2d_affine_split.cu',
       'pallas_stiffness.py:247'),
      ('stiffness2d_affine_default', 'stiffness2d_affine_split.cu',
       'pallas_stiffness.py:214'),
      ('stiffness3d_dense_bf16x3', 'stiffness3d_dense_split.cu',
       'pallas_stiffness3d.py:65')):
    kernels.append({'name': name, 'route': 'cuda',
                    'source': f'swirlfem_tpu_torch/csrc/{source}',
                    'replaces': f'swirlfem_tpu/ops/{replaces}',
                    'launches': launches[name], **times[name]})
  for kern in kernels:
    kern.setdefault('launched_by', 'main path')
    require(kern['launches'] > 0, kern)
    require(all(math.isfinite(kern[key]) for key in
                ('max_abs_err', 'ms', 'plain_ms', 'call_ms', 'plain_call_ms',
                 'bound_ms')), kern)
    require(kern['library_ms'] is None or math.isfinite(kern['library_ms']),
            kern)
  print(json.dumps({'kernels': kernels}))
  print(smi)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())

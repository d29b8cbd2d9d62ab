#!/usr/bin/env python3
"""Drives the PyTorch port's main paths once on one CUDA card, and checks them.

The main paths are the Kolmogorov DNS datagen of swirlfem_tpu_torch at the
reference configuration (64x64 elements, order 8, BDF3, Re 2e4, dt 1e-4),
the 3D Taylor-Green vortex (Re 1600, 16^3 elements, order 7, BDF2, filter
0.05), the wall-graded heated cavity (the campaign's Ra 1e6 rung: 12x12
elements, order 7, grading 0.5, Pr 0.71, tol 3e-6), the lid-driven cavity
(16x16, order 7, Re 100, dt 1e-3) and the CG-solved 3D el step (16^3
elements, order 7, BDF2, filter 0.05) on the Taylor-Green box and on a
graded and sheared periodic box, all in float32, and the NiLES training
step (12x12 elements, order 4, 8-step rollouts through the multiscale
transformer with its latent SDE, gradients through both solves) on the
datagen cycle's frames.  Phases:

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
     and the kernels' refusal of it;
 29. the training path's kernels at its shape (12x12 elements, order 4:
     k = 5, E = 144, C = 2): exchange2d bitwise, stiffness_uniform within
     1e-5 of the float64 operator, and their autograd (each backward pass
     launches the same kernel: QQ^T g bitwise, A g within 1e-5); phase 4's
     frames restricted to the training mesh; one training step whose
     forcing requires grad, with the kernels against `use_kernels=False` on
     the card (loss within 1e-5; gradient within 1e-4 in float64 and 3e-4
     in the training's float32; a missing or zero gradient fails); the
     batched layout at the config's batch of 128: exchange2d on 128
     samples x 2 components of (5, 5, 12, 12) in one launch, bitwise in
     float32 and float64, timed against its plain version and the loop's
     128 two-field launches; stiffness_uniform on the batch folded into E
     (E = 128 x 144) within 1e-5 of the float64 operator, timed;
 30. NiLES training at the full default configuration (the model under
     bf16 autocast, the solver float32, one batched solver step a rollout
     step): two more datagen cycles from phase 4's state (141 windows);
     2 train steps at the config's batch of 128 (`TRAIN_BATCH`), each
     step's loss, CG telemetry, host-clock time and row 1 and 2 launches,
     one more step under `torch.profiler` (the device's busy share), one
     step at batch 16 (its launches beside the per-sample loop's), then
     one eval at batch 4 with its rollout shortened to 16 steps (the model
     and the no-model baseline);
 31. one train step at the tests' tiny configuration on the card (float32)
     against the CPU plain path (float64 solver), from the same
     parameters, batch and draws: loss and global gradient norm within
     1e-4; then the card at the configuration's own bfloat16 against the
     same reference (loss within 1e-2, norm within 5e-2), its model output
     float32 and more than 1e-4 from the float32 model's;
 32. the general 2D stiffness kernel (row 3) on the cylinder channel's own
     factor fields at its ragged element counts (k = 6, E = 228 and k = 4,
     E = 122, C = 2): within 1e-5 of its plain version and of the float64
     operator; timed at E = 228 against its plain version, one library
     `einsum` and its bound ("cylinder_ms" in the kernels line);
 33. the Schaefer-Turek cylinder (228 elements, order 5, Re 100, BDF2, dt
     2.5e-4, float32) on the generic path: build and dense Schur assembly
     seconds, 410 steps of `run_cylinder_scan` with the forces and the
     Fischer history (finite states, pressure CG <= 3 iterations every
     step from the fifth on, positive drag); ms/step over steps 11-400,
     CG iterations, and launches a step from the profiler over steps
     401-410 of the live loop;
 34. the same 410 steps with `unstructured_el_ops=True` (row 3 launched on
     every viscous matvec, counted; the same dense Schur inverse), and the
     generic path with the same solves (no history): the two paths'
     velocities within 1e-4 relative, pressures within 7e-3 (the
     generic path against itself reads up to 2.0e-3);
 35. 20 steps of the small cylinder (122 elements, order 3) on the card in
     float32 against the CPU plain path in float64, on both paths
     (velocities within 2e-4, pressures 1e-3: every run reads up to 6.4e-5
     and 3.1e-4; the JAX package's own float32 run reads 1.7e-4 and
     4.5e-4 there);
     `solve_poisson` on the card against the exact solution;
 36. the scatters add in a fixed order: phase 35's card steps run again
     and give bitwise the same u and p on both paths; on the JAX package's
     large cylinder (912 elements, order 6) the velocity scatters, the
     E-last sum and the Schwarz apply each repeat 20 times bitwise;
 37. the two-level Schwarz pressure preconditioner on that cylinder
     (22,800 pressure dofs, past the dense inverse; dt at CFL 0.65, Re
     100, BDF2, tol 1e-5, float32): its set-up (colours, probe applies,
     seconds, block memory), 210 steps on the E-last path (row 3 on every
     viscous matvec, counted), on the generic path with the Fischer
     history and without it (host clock over steps 11-200, profiler over
     201-210; pressure CG iterations gated from the fifth step on), the
     E-last against the generic path with the same solves, and three steps
     from the E-last run's state with Schwarz against plain CG;
 38. the distributed layer on 4 ranks that share the card
     (`parallel.spmd.launch`: spawned processes, payloads through host
     memory: shared slots for small payloads, gloo for large ones; every
     phase below runs on these ranks): the datagen box and the TGV
     box cut into 4 slabs on the host (`nse.distributed.split_box`); on
     every rank the congruent 2D and 3D stiffness kernels (rows 2 and 6) at
     the slab shapes, (2, 9, 9, 1024) and (3, 8, 8, 8, 1024), against their
     plain versions and the float64 operator (1e-5), timed on rank 0
     against their plain versions, one library GEMM and their bound
     ("sharded_*" in the kernels line);
 39. `run_simulation_distributed` at the reference configuration, 200
     steps, against the single-device `make_step_fn` from the same start
     (1e-4 relative); ms/step, collectives and host-staged bytes a step;
 40. 20 certified sharded datagen steps from phase 4's state against
     phase 5's, and 10 CG-solved sharded TGV-box steps from phase 19's
     start against its fused-key steps (u within 1e-4 relative; p within
     1e-2 and 3e-4: the pressure solves stop at their tolerances), rows 2
     and 6 launched on every rank in every step (counted per rank);
 41. the lid-driven cavity (16^2, order 7, Re 100, dt 1e-3) partitioned 4
     ways by `utils.partition.partition`, each mode's tables built once on
     the host and each rank shipped its row: 10 steps from rest in the
     psum mode, 3 in the neighbor and owner modes (`CAVITY_STEPS`), against
     the same steps unpartitioned on the card (`CAVITY_GATES`, relative)
     and bitwise against the psum mode's state after as many steps, every
     shared velocity dof's copies bitwise equal across the ranks;
 42. the communication layer on the 4 ranks, on the card: `pscan` and
     `preduce` in both methods against a host oracle, the crystal
     router's dense, ppermute and ragged forms placing every row bitwise
     alike, the 128^2 mesh's element fields repartitioned from
     `utils.partition.partition` to slabs and back, bitwise, and each
     collective's backward against its adjoint computed on the host;
 43. the distributed two-level Schwarz at full width: the JAX package's
     `experiments/schwarz_scale.py` configuration (a warped 128^2 cavity,
     order 4, overlap 0, the 'vertex-cheb' coarse, the neighbor exchange,
     the element-FDM viscous preconditioner) on 4 ranks from one host
     set-up (`SCHWARZ_SCALE`): in float32 at tol 1e-5, the apply against
     the single-device float64 Schwarz on the same twin, 20 repeats of it
     bitwise, CG iterations, ms/step and collectives a step over 5 steps;
     in float64 at tol 1e-8, the apply and 5 steps against the same
     unpartitioned on the card;
 44. gradients and the scalar: one certified sharded datagen step (64^2,
     order 8, 4 slabs) differentiated by a forcing scale against the
     single-device step on the card, row 2's launches counted forward and
     backward on every rank; one partitioned step of phase 41's cavity
     (psum mode) differentiated against the unpartitioned step; 3
     partitioned passive-scalar steps against the unpartitioned ones
     (`LATE_GATES`);
 45. data-parallel training: 4 ranks sharing the card (`train.train_step`
     on a `parallel.spmd.Axis`), a global batch of 16 windows of phase
     30's frames (4 a rank, each rank with its rows of the global draws),
     2 steps against the single-process trainer on the same batch, draws
     and initial parameters: the parameters bitwise equal on every rank
     after every step, the loss and the parameters within `DP_GATES` of
     the single process; ms/step on rank 0, collectives and host-staged
     bytes a step.

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
import statistics
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
# Phase 37's gates: the pressure CG iterations a step from the fifth step
# on, the E-last against the generic path (u, p) and Schwarz against plain
# CG after three steps (u, p), each about 3x the largest reading.
SCHWARZ_PRESSURE_ITERATIONS = 70
SCHWARZ_EL_GENERIC = (3e-4, 2e-2)
SCHWARZ_VS_PLAIN = (1e-5, 2.5e-2)


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
  certified['fused_state'] = runs['fused']['state']

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



def grad_norm(grads) -> float:
  return math.sqrt(sum(float(g.double().square().sum()) for g in grads))


# Phase 30's batch: the training config's own (niles/config.py).
TRAIN_BATCH = 128
# Windows in phase 29's batched step with grad, kernels against plain.
GRAD_BATCH = 8


def run_training_phases(torch, device, kernel_checks, frames, dgen) -> dict:
  """Phases 29-30: the NiLES training slice at the default configuration.
  `dgen` holds the datagen solver, config and phase 4's end state (two more
  cycles from it give phase 30's windows).  Returns the train and eval
  step's times, the launches of rows 1 and 2 per train step, the device's
  busy share, rows 1 and 2 on the batched layout, and the restricted
  frames."""
  import numpy as np
  from swirlfem_tpu_torch.linalg.linear_solve import linear_solve
  from swirlfem_tpu_torch.niles import coarsen
  from swirlfem_tpu_torch.niles import datagen
  from swirlfem_tpu_torch.niles import config as niles_config
  from swirlfem_tpu_torch.niles import input_pipeline
  from swirlfem_tpu_torch.niles import profile_datagen
  from swirlfem_tpu_torch.niles import train
  from swirlfem_tpu_torch.ops import cuda_exchange
  from swirlfem_tpu_torch.ops import cuda_stiffness

  counters = (cuda_exchange.exchange2d, cuda_stiffness.stiffness_uniform)

  def reset():
    for c in counters:
      c.launches = 0

  def read():
    return tuple(c.launches for c in counters)

  # -- 29. rows 1 and 2 at the training shape, and their autograd --------
  cfg = niles_config.get_config()
  cfg.drag_coeff = 0.05  # the datagen's, whose frames train here
  sem = train.build_solver(cfg, device=device)
  ops = sem.fast_ops
  k, n = cfg.order + 1, cfg.element_grid_size
  require(ops.c_uniform is not None and ops.stiffness_key == (
      'congruent', 'highest'), ops.stiffness_key)
  w = tuple(kernel_checks.random_field((k, k, n, n), dtype=torch.float32,
                                       device=device, seed=s) for s in (1, 2))
  for fields in (w[0], w):
    ex = kernel_checks.check_exchange2d(fields)
    log(f'[29] exchange2d {1 if fields is w[0] else 2} x {(k, k, n, n)} '
        f'f32: {ex}')
    require(ex['bitwise_equal'], ex)
  us = tuple(x.reshape(k, k, n * n).contiguous() for x in w)
  st = kernel_checks.check_stiffness_uniform(ops, us)
  log(f'[29] stiffness_uniform 2 x {tuple(us[0].shape)} f32: {st}')
  require(st['rel_err_f64'] <= kernel_checks.STIFFNESS_REL_TOL, st)
  # Autograd: each function's backward is the same kernel on the gradient.
  g_out = tuple(kernel_checks.random_field((k, k, n, n), dtype=torch.float32,
                                           device=device, seed=s)
                for s in (3, 4))
  wg = tuple(x.clone().requires_grad_() for x in w)
  reset()
  out = cuda_exchange.exchange2d(wg)
  got = torch.autograd.grad(out, wg, g_out)
  ex_launches = read()[0]
  want = tuple(cuda_exchange.exchange2d_plain(g) for g in g_out)
  require(ex_launches == 2, ex_launches)
  require(all(torch.equal(a, b) for a, b in zip(got, want)),
          'exchange2d backward differs from QQ^T of the gradient')
  ug = tuple(u.clone().requires_grad_() for u in us)
  gu = tuple(g.reshape(k, k, n * n) for g in g_out)
  reset()
  out = ops.stiffness_el_multi(ug)
  got = torch.autograd.grad(out, ug, gu)
  st_launches = read()[1]
  a64 = torch.as_tensor(cuda_stiffness.uniform_amat_np(
      ops.c_uniform, ops.wq2d, ops.dmat), device=device)
  want = tuple((a64 @ g.double().reshape(k * k, -1)).reshape(g.shape)
               for g in gu)
  err_st = rel_err(got, want)
  log(f'[29] autograd: exchange2d backward bitwise QQ^T g ({ex_launches} '
      f'launches, forward + backward); stiffness backward vs float64 A g '
      f'{err_st:.3e} ({st_launches} launches)')
  require(st_launches == 2 and err_st <= kernel_checks.STIFFNESS_REL_TOL,
          (st_launches, err_st))

  # Row 1 on the batched layout at the config's batch (128 samples, both
  # components in one launch, float32 and float64): bitwise its plain
  # version, timed against the plain version and against the loop's form
  # (a two-field launch a sample); row 2 on the batch folded into E.
  nb = niles_config.get_config().batch_size
  batched = {}
  for dt_ in (torch.float32, torch.float64):
    wb = tuple(kernel_checks.random_field((k, k, nb, n, n), dtype=dt_,
                                          device=device, seed=s)
               for s in (5, 6))
    reset()
    exb = kernel_checks.check_exchange2d(wb)
    one = read()[0]
    log(f'[29] exchange2d batched 2 x {tuple(wb[0].shape)} {dt_}: {exb}, '
        f'{one} launch')
    require(exb['bitwise_equal'] and one == 1, (exb, one))
    per_sample = [tuple(x[:, :, b].contiguous() for x in wb)
                  for b in range(nb)]
    nbytes = 2 * sum(x.numel() * x.element_size() for x in wb)
    entry = {
        'max_abs_err': exb['max_abs_err'],
        'ms': kernel_checks.time_ms(lambda: cuda_exchange.exchange2d(wb),
                                    device=device),
        'plain_ms': kernel_checks.time_ms(
            lambda: tuple(cuda_exchange.exchange2d_plain(x) for x in wb),
            device=device, calls=PLAIN_CALLS),
        'loop_ms': kernel_checks.time_ms(
            lambda: [cuda_exchange.exchange2d(f) for f in per_sample],
            device=device, calls=2),
        'kernel_us': kernel_checks.kernel_us(
            lambda: cuda_exchange.exchange2d(wb), 'exchange2d_kernel',
            device=device),
        **kernel_checks.bound(2 * 2 * k * n * n * nb, nbytes)}
    batched[str(dt_).replace('torch.', '')] = entry
    log(f'[29] exchange2d batched {dt_}: {entry["ms"] * 1e3:.2f} us '
        f'(kernel {us_or_none(entry["kernel_us"])}), plain '
        f'{entry["plain_ms"] * 1e3:.2f} us, the loop\'s {nb} two-field '
        f'launches {entry["loop_ms"] * 1e3:.2f} us, bound '
        f'{entry["bound_ms"] * 1e3:.3f} us ({entry["bound_by"]})')
  folded = ops.fold_batch(nb)
  uf = tuple(kernel_checks.random_field((k, k, nb * n * n),
                                        dtype=torch.float32, device=device,
                                        seed=s) for s in (7, 8))
  stf = kernel_checks.check_stiffness_uniform(folded, uf)
  log(f'[29] stiffness_uniform on the folded batch 2 x '
      f'{tuple(uf[0].shape)} f32: {stf}')
  require(stf['rel_err_f64'] <= kernel_checks.STIFFNESS_REL_TOL, stf)
  amat = ops.mats['amat']
  k2 = amat.shape[0]
  ustack = torch.cat([u.reshape(k2, -1) for u in uf], dim=1)
  batched['stiffness_folded'] = {
      'max_abs_err': stf['max_abs_err'],
      'ms': kernel_checks.time_ms(lambda: folded.stiffness_el_multi(uf),
                                  device=device),
      'plain_ms': kernel_checks.time_ms(
          lambda: cuda_stiffness.stiffness_uniform_plain(uf, amat),
          device=device, calls=PLAIN_CALLS),
      'library_ms': kernel_checks.time_ms(lambda: torch.matmul(amat, ustack),
                                          device=device),
      **kernel_checks.bound(2 * k2 ** 2 * uf[0].shape[-1] * len(uf),
                            (k2 * k2 + 2 * len(uf) * uf[0].numel())
                            * amat.element_size())}
  log(f'[29] stiffness_uniform folded (E = {nb} x {n * n}): '
      f'{batched["stiffness_folded"]}')

  # The training's batched solver step (`train.solve_batch_step`) on a
  # batch of restricted windows whose forcing requires grad: the kernels
  # against the plain versions (use_kernels=False) on the card.
  restrict = coarsen.make_restriction(64, 8, cfg)
  dns = {key: np.concatenate([f[key] for f in frames]) for key in ('u', 'p')}
  les = restrict(dns)
  nf = les['u'].shape[0]
  log(f'[29] {nf} datagen frames restricted 64^2 order 8 -> '
      f'{n}^2 order {cfg.order}: u {les["u"].shape}, p {les["p"].shape}')
  require(np.isfinite(les['u']).all() and np.isfinite(les['p']).all(),
          'non-finite restricted frames')
  # Sample b steps from frames b .. b + T - 1 (T the time order).  The loss
  # is half the squared distance to each sample's next frame, summed over
  # the batch, over its value at the start.  In float64 both paths solve
  # to rounding.  In float32 (the training's dtype) the transpose solves
  # stop at the absolute atol = 1e-7 of the training step or run to their
  # cap on the rounding floor; one sample's gradients read 5.5e-5 to
  # 9.1e-5 apart on the two paths (PERF.md): gated at 3e-4, three times
  # the largest reading.
  order = cfg.time_order
  require(nf >= GRAD_BATCH + order, (nf, GRAD_BATCH))
  window = lambda key, i: les[key][i:i + GRAD_BATCH]
  rng = np.random.default_rng(29)
  misfit = float(np.square(window('u', order).astype(np.float64)
                           - window('u', order - 1)).sum())
  f0 = 1e-2 * rng.standard_normal((GRAD_BATCH,) + les['u'].shape[1:])
  for dtype, tol_l, tol_g in ((torch.float64, 1e-5, 1e-4),
                              (torch.float32, 1e-5, 3e-4)):
    results = []
    for use_kernels in (True, False):
      solver = train.build_solver(cfg, device=device, dtype=dtype,
                                  use_kernels=use_kernels)
      frame = lambda key, i: torch.as_tensor(window(key, i), dtype=dtype,
                                             device=device)
      hist = [frame('u', i) for i in range(order)]
      ps = [frame('p', i) for i in range(order)]
      target = frame('u', order)
      f = torch.as_tensor(f0, dtype=dtype, device=device).requires_grad_()
      cus = [solver.C(u) for u in hist]
      reset()
      solves = linear_solve.transpose_solves
      u, _, _, cg = train.solve_batch_step(
          hist, ps, cus, f, solver, cfg,
          train.make_solver_preconds(solver, cfg))
      fwd = read()
      loss = 0.5 * (u - target).square().sum() / misfit
      (g,) = torch.autograd.grad(loss, f)
      torch.cuda.synchronize(device)
      cg = {key: [int(x) for x in cg[key].tolist()]
            for key in ('cg_u_iters', 'cg_p_iters')}
      results.append((float(loss), g, fwd, tuple(
          b - a for a, b in zip(fwd, read())),
          linear_solve.transpose_solves - solves, cg))
    (l_k, g_k, fwd_k, bwd_k, ns_k, cg_k), (l_p, g_p, fwd_p, bwd_p, _, cg_p) = (
        results)
    dl = abs(l_k - l_p) / abs(l_p)
    dg = rel_err(g_k, g_p)
    gmax = float(g_k.abs().max())
    log(f'[29] {dtype} batched el step ({GRAD_BATCH} windows) with grad, '
        f'kernels vs use_kernels=False on the card: loss {l_k:.10e} vs '
        f'{l_p:.10e} (rel {dl:.3e}), d loss / d f rel {dg:.3e} (max |g| '
        f'{gmax:.3e}; tolerances {tol_l:g}, {tol_g:g}); launches '
        f'(exchange2d, stiffness_uniform) forward {fwd_k}, backward {bwd_k} '
        f'({ns_k} transpose solves); plain path {fwd_p}, {bwd_p}; CG per '
        f'sample {cg_k}, plain path {cg_p}')
    require(math.isfinite(l_k) and gmax > 0 and all_finite(g_k),
            'missing or zero gradient through the step')
    require(dl <= tol_l and dg <= tol_g, (dtype, dl, dg))
    require(min(fwd_k + bwd_k) > 0 and ns_k == 2, (fwd_k, bwd_k, ns_k))
    require(bwd_p[1] == 0, bwd_p)

  # -- 30. training at the full default configuration ----------------------
  # Two more datagen cycles from phase 4's end state: one trajectory of 151
  # frames gives 141 training windows, enough for a batch of 128 distinct
  # ones (one cycle gives 41).
  advance = datagen.make_step_fn(dgen['sem'], dgen['cfg'])
  us_, ps_, cus_ = dgen['state']
  cycles = []
  t0 = time.perf_counter()
  for c in (1, 2):
    us_, ps_, cus_, _, fr = datagen.one_cycle(
        dgen['sem'], dgen['cfg'], advance,
        c * dgen['cfg'].num_steps_per_cycle, us_, ps_, cus_, None)
    cycles.append(fr)
  dns = {key: np.concatenate([dns[key]] + [f[key][1:] for f in cycles])
         for key in ('u', 'p')}
  les = restrict(dns)
  log(f'[30] two more datagen cycles from phase 4\'s state '
      f'({time.perf_counter() - t0:.1f} s): {les["u"].shape[0]} frames')
  require(np.isfinite(les['u']).all() and np.isfinite(les['p']).all(),
          'non-finite restricted frames')
  cfg.batch_size = TRAIN_BATCH
  steps_run, eval_steps = 2, 16
  torch.manual_seed(cfg.seed)
  model = train.create_model(cfg).to(device)
  state = train.create_train_state(model, cfg)
  num_params = sum(p.numel() for p in model.parameters())
  it = input_pipeline.create_split(cfg.batch_size, True, cfg, prefetch=0,
                                   frames=[les])
  n_windows = input_pipeline.get_num_examples(
      '', True, cfg.train_window_size, cfg.train_window_stride, frames=[les])
  spe = max(1, n_windows // cfg.batch_size)
  lr_fn = train.create_learning_rate_fn(
      cfg, cfg.learning_rate * cfg.batch_size / 256.0, spe)
  kl_fn = train.create_kl_penalty_fn(cfg, spe)
  preconds = train.make_solver_preconds(sem, cfg)
  log(f'[30] {cfg.element_grid_size}^2 order {cfg.order}, Re '
      f'{cfg.reynolds_number:g}, dt {cfg.dt:g}, BDF{cfg.time_order}, '
      f'{cfg.num_steps}-step rollouts ({cfg.num_pushforward_steps} '
      f'pushforward), model width {cfg.model.width} depth {cfg.model.depth} '
      f'dtype {cfg.model.dtype}, {num_params} parameters; {n_windows} '
      f'train windows of {cfg.train_window_size}, batch {cfg.batch_size}, '
      f'{steps_run} steps, one batched solver step a rollout step')
  before = [p.detach().clone() for p in model.parameters()]

  def timed_step(step, batch, batch_size):
    draws = train.make_draws_fn(model, batch_size, cfg.seed, step, device)
    torch.cuda.synchronize(device)
    reset()
    solves, iters = (linear_solve.transpose_solves,
                     linear_solve.transpose_iterations)
    t0 = time.perf_counter()
    _, metrics, _ = train.train_step(state, batch, draws, lr_fn, kl_fn,
                                     sem, cfg, preconds)
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3
    m = train.metrics_to_host(metrics)
    tr = (linear_solve.transpose_solves - solves,
          linear_solve.transpose_iterations - iters)
    log(f'[30] step {step} (batch {batch_size}): loss {m["loss"]:.6e} (mse '
        f'{m["mse"]:.6e}, kl {m["kl"]:.3e}), lr {m["learning_rate"]:.3e}, '
        f'cg_max_iters {m["cg_max_iters"]:g}, cg_max_resid '
        f'{m["cg_max_resid"]:.2e}, {ms:.1f} ms, launches (exchange2d, '
        f'stiffness_uniform) {read()}, backward solves {tr[0]} ({tr[1]} CG '
        f'iterations, every sample\'s)')
    return ms, read(), m, tr

  step_ms, step_launches, losses, cg_iters, tr_iters = [], [], [], [], []
  for step in range(steps_run):
    batch = {key: torch.as_tensor(v, device=device)
             for key, v in next(it).items()}
    ms, launched, m, tr = timed_step(step, batch, cfg.batch_size)
    step_ms.append(ms)
    step_launches.append(launched)
    losses.append(m['loss'])
    cg_iters.append(m['cg_max_iters'])
    tr_iters.append(tr)
  changed = sum(float((p.detach() - b).abs().max()) for p, b in
                zip(model.parameters(), before))
  require(all(math.isfinite(x) for x in losses), losses)
  require(changed > 0, 'the parameters did not change')
  require(max(cg_iters) < 50, cg_iters)
  require(all(min(x) > 0 for x in step_launches), step_launches)
  # One more step under the profiler (the CUDA activity alone: the per-op
  # tables over a step's launches would take minutes).
  batch = {key: torch.as_tensor(v, device=device)
           for key, v in next(it).items()}
  draws = train.make_draws_fn(model, cfg.batch_size, cfg.seed, steps_run,
                              device)
  t0 = time.perf_counter()
  prof = profile_datagen.device_busy(
      lambda: train.train_step(state, batch, draws, lr_fn, kl_fn, sem, cfg,
                               preconds), device)
  busy = None if prof is None else prof['busy_share']
  log(f'[30] profiled train step: {prof} ({time.perf_counter() - t0:.1f} s '
      f'with the trace\'s reading); busy '
      f'{"not measured" if prof is None else prof["busy_ms"]} ms against '
      f'the unprofiled steps\' last below')
  # One step at batch 16, for its launches beside those of a solver step a
  # sample at that batch.
  small = {key: torch.as_tensor(v[:16], device=device)
           for key, v in next(it).items()}
  ms16, launches16, m16, _ = timed_step(steps_run + 1, small, 16)
  require(math.isfinite(m16['loss']) and m16['cg_max_iters'] < 50, m16)
  # One eval at batch 4, its rollout shortened from 125 to 16 steps.
  cfg.eval_num_steps = eval_steps
  cfg.eval_window_size = eval_steps + 3
  cfg.eval_baseline = True
  ev_it = input_pipeline.create_split(4, False, cfg, prefetch=0,
                                      frames=[les])
  ebatch = {key: torch.as_tensor(v, device=device)
            for key, v in next(ev_it).items()}
  to_grid = train.make_uniform_transfer(sem, cfg)
  torch.cuda.synchronize(device)
  reset()
  t0 = time.perf_counter()
  ev = train.metrics_to_host(train.eval_step(
      state, ebatch, train.make_draws_fn(model, 4, cfg.seed + 1, 0, device),
      kl_fn, sem, to_grid, cfg, preconds))
  torch.cuda.synchronize(device)
  eval_ms = (time.perf_counter() - t0) * 1e3
  eval_launches = read()
  log(f'[30] eval at batch 4, rollout shortened to {eval_steps} steps (the '
      f'config has {niles_config.get_config().eval_num_steps}): mse '
      f'{ev["mse"]:.6e} (no-model baseline {ev["mse_baseline"]:.6e}), '
      f'tke_err {ev["tke_err"]:.4e} (baseline {ev["tke_err_baseline"]:.4e}), '
      f'cg_max_iters {ev["cg_max_iters"]:g}, {eval_ms:.1f} ms, launches '
      f'{eval_launches} (the eval step runs the model and the no-model '
      f'baseline)')
  require(all(math.isfinite(v) for v in ev.values()), ev)
  train_ms = step_ms[-1]
  busy_text = ('not measured' if prof is None else
               f'{prof["busy_ms"]:.1f} ms: {100 * busy:.1f}% of the profiled '
               f'step, {100 * prof["busy_ms"] / train_ms:.1f}% of the last '
               'timed step')
  log(f'[30] train step (batch {cfg.batch_size}, host clock): steps '
      f'{", ".join(f"{x:.1f}" for x in step_ms)} ms; launches per train step '
      f'(exchange2d, stiffness_uniform) {step_launches[-1]} (batch 16: '
      f'{launches16}, {ms16:.1f} ms); device busy {busy_text}; backward '
      f'solves per step {tr_iters[-1][0]}, {tr_iters[-1][1]} CG iterations '
      f'in all')

  names = ('exchange2d', 'stiffness_uniform')
  return {'train_step_ms': train_ms, 'step_ms': step_ms, 'eval_ms': eval_ms,
          'batch': cfg.batch_size,
          'train_step_launches': dict(zip(names, step_launches[-1])),
          'batch16_launches': dict(zip(names, launches16)),
          'batch16_ms': ms16, 'busy': prof, 'batched': batched,
          'les': les}


def run_tiny_train_phase(torch, device) -> None:
  """Phase 31: one train step at the tests' tiny configuration, the card
  against the CPU plain path."""
  from swirlfem_tpu_torch.niles import config as niles_config
  from swirlfem_tpu_torch.niles import input_pipeline
  from swirlfem_tpu_torch.niles import train

  # At the tests' tiny configuration: the model in float32 on both sides
  # (its inputs cast to float32, as in the JAX package), the solvers in
  # float32 on the card and float64 on the CPU.  Then the card again at
  # the configuration's own bfloat16 (autocast around the encoder and
  # decoder blocks), against the same CPU reference.
  tiny = niles_config.set_fields(niles_config.get_config(),
                                 niles_config.tiny_fields())
  require(tiny.model.dtype == 'bfloat16', tiny.model.dtype)
  tiny.model.dtype = 'float32'
  torch.manual_seed(31)
  model_c = train.create_model(tiny)
  with torch.no_grad():
    for p in model_c.parameters():
      p.add_(0.05 * torch.randn(p.shape))
  batch = next(input_pipeline.create_split(tiny.batch_size, True, tiny,
                                           prefetch=0))
  g = torch.Generator().manual_seed(31)
  draws = [model_c.sample_draws(tiny.batch_size, generator=g)
           for _ in range(tiny.num_steps)]

  def tiny_model(model_dtype, dev):
    tiny.model.dtype = model_dtype
    m = train.create_model(tiny)
    m.load_state_dict(model_c.state_dict())
    return m.to(dev)

  out = []
  for dev, dtype, model_dtype in ((device, torch.float32, 'float32'),
                                  ('cpu', torch.float64, 'float32'),
                                  (device, torch.float32, 'bfloat16')):
    st_ = train.create_train_state(tiny_model(model_dtype, dev), tiny)
    solver = train.build_solver(tiny, device=dev, dtype=dtype)
    tb = {key: torch.as_tensor(v, dtype=dtype, device=dev)
          for key, v in batch.items()}
    dr = [{key: v.to(dev) for key, v in d.items()} for d in draws]
    _, met, grads = train.train_step(
        st_, tb, lambda i: dr[i], lambda s: 1e-2, lambda s: 1e-3, solver,
        tiny, train.make_solver_preconds(solver, tiny))
    out.append((float(met['loss']), grad_norm(grads)))
  (l_c, n_c), (l_h, n_h), (l_b, n_b) = out
  dl, dn = abs(l_c - l_h) / abs(l_h), abs(n_c - n_h) / n_h
  log(f'[31] tiny config train step, card f32 vs CPU plain path f64: loss '
      f'{l_c:.8e} vs {l_h:.8e} (rel {dl:.3e}), global gradient norm '
      f'{n_c:.6e} vs {n_h:.6e} (rel {dn:.3e}); tolerance 1e-4 each')
  require(dl <= 1e-4 and dn <= 1e-4, (dl, dn))
  # bfloat16: the step within a bfloat16-class tolerance of the reference
  # (on the CPU's autocast the same step reads up to 3e-4 on the loss and
  # 7.3e-3 on the norm), and the model's output rounded (more than 1e-4
  # from the float32 model on the same input and draws) yet float32.
  dl_b, dn_b = abs(l_b - l_h) / abs(l_h), abs(n_b - n_h) / n_h
  x = torch.randn((tiny.batch_size, tiny.num_elements, tiny.num_channels),
                  generator=torch.Generator().manual_seed(32)).to(device)
  d0 = {key: v.to(device) for key, v in draws[0].items()}
  with torch.no_grad():
    y_b, _ = tiny_model('bfloat16', device)(x, draws=d0)
    y_f, _ = tiny_model('float32', device)(x, draws=d0)
  dy = rel_err(y_b, y_f)
  log(f'[31] tiny config train step, card bf16 autocast vs CPU plain path '
      f'f64: loss {l_b:.8e} (rel {dl_b:.3e}, tolerance 1e-2), global '
      f'gradient norm {n_b:.6e} (rel {dn_b:.3e}, tolerance 5e-2); model '
      f'output {y_b.dtype}, {dy:.3e} from the f32 model (must exceed 1e-4)')
  require(dl_b <= 1e-2 and dn_b <= 5e-2, (dl_b, dn_b))
  require(y_b.dtype == torch.float32 and dy > 1e-4, (y_b.dtype, dy))


def run_cylinder_phases(torch, device, kernel_checks, times, launches,
                        num_steps: int = 400) -> None:
  """Phases 32-35: the unstructured-mesh path on the Schaefer-Turek cylinder
  channel (228 elements, order 5, Re 100, BDF2, dt 2.5e-4, filter 0.05,
  float32; the dense Schur inverse, the Fischer history on the generic
  path).  Fills `times['stiffness2d_general']` with the cylinder's timings
  and `launches['stiffness2d_general_cylinder']` with row 3's launches on
  the E-last cylinder path."""
  import numpy as np
  from swirlfem_tpu_torch.core.bc import BCType
  from swirlfem_tpu_torch.core.quadrature import Nodes1D, NodeType
  from swirlfem_tpu_torch.core.refine import refine_premesh
  from swirlfem_tpu_torch.examples import cylinder as cyl
  from swirlfem_tpu_torch.examples import poisson
  from swirlfem_tpu_torch.niles.profile_datagen import StepProfiler
  from swirlfem_tpu_torch.ops import cuda_stiffness2d
  from swirlfem_tpu_torch.utils.box import unit_cube_mesh
  dtype = torch.float32
  small = dict(ns=4, nr=3, nx_down=10)
  general = cuda_stiffness2d.stiffness2d_general
  START_STEPS = 4  # pylint: disable=invalid-name

  # -- 32. row 3 on the cylinder's own factor fields -------------------------
  t0 = time.perf_counter()
  sem_el = cyl.make_cylinder_sem(device=device, dtype=dtype,
                                 unstructured_el_ops=True)
  small_el = cyl.make_cylinder_sem(3, **small, device=device, dtype=dtype,
                                   unstructured_el_ops=True)
  log(f'[32] E-last cylinder solvers built in {time.perf_counter() - t0:.2f}'
      f' s: keys {sem_el.fast_ops.stiffness_key}, '
      f'{small_el.fast_ops.stiffness_key}')
  checks = {}
  for name, ops in (('k=6 E=228', sem_el.fast_ops),
                    ('k=4 E=122', small_el.fast_ops)):
    require(ops.stiffness_key[0] == 'general' and ops.vinfo is None,
            (name, ops.stiffness_key))
    k, num_e = ops.wmass.shape[0], ops.wmass.shape[-1]
    us = tuple(kernel_checks.random_field((k, k, num_e), dtype=dtype,
                                          device=device, seed=s)
               for s in (1, 2))
    check = kernel_checks.check_stiffness2d_general(ops, us)
    plain = cuda_stiffness2d.stiffness2d_general_plain(
        us, (ops.g11, ops.g12, ops.g22), ops.mats['dmat'])
    check['rel_err_plain'] = check['max_abs_err'] / max(
        float(p.abs().max()) for p in plain)
    checks[name] = (ops, us, check)
    log(f'[32] stiffness2d_general on the cylinder, {name}, C = 2: {check}')
    require(check['rel_err_plain'] <= 1e-5, (name, check))
    require(check['rel_err_f64'] <= kernel_checks.STIFFNESS_REL_TOL,
            (name, check))
  ops, us, check = checks['k=6 E=228']
  gs, dmat = (ops.g11, ops.g12, ops.g22), ops.mats['dmat']
  cyl_t = {
      'ms': kernel_checks.time_ms(
          lambda: ops.stiffness_el_multi(us), device=device),
      'plain_ms': kernel_checks.time_ms(
          lambda: cuda_stiffness2d.stiffness2d_general_plain(us, gs, dmat),
          device=device, calls=PLAIN_CALLS),
      'library_ms': kernel_checks.time_ms(
          kernel_checks.library_general(us, gs, dmat), device=device)}
  flops, nbytes = cuda_stiffness2d.stiffness2d_counts(
      5, us[0].shape[-1], len(us), affine=False, dtype_bytes=4)
  cyl_t.update(kernel_checks.bound(flops, nbytes))
  log(f'[32] stiffness2d_general at the cylinder shape {tuple(us[0].shape)} '
      f'x 2: {cyl_t["ms"] * 1e3:.2f} us (plain {cyl_t["plain_ms"] * 1e3:.2f}'
      f', library {cyl_t["library_ms"] * 1e3:.2f}, bound '
      f'{cyl_t["bound_ms"] * 1e3:.3f} us, {cyl_t["bound_by"]})')
  times['stiffness2d_general'].update(
      {f'cylinder_{key}': val for key, val in cyl_t.items()})
  times['stiffness2d_general']['cylinder_max_abs_err'] = check['max_abs_err']

  # -- 33. the default cylinder on the generic path -------------------------
  dt = 2.5e-4
  t0 = time.perf_counter()
  sem = cyl.make_cylinder_sem(device=device, dtype=dtype)
  build_s = time.perf_counter() - t0
  # One dense Schur inverse for both paths: it is assembled from the
  # generic operators on the host, which the E-last solver shares.
  precond = sem.dense_pressure_preconditioner(dt, 2)
  mesh = sem.velocity.mesh
  log(f'[33] cylinder: {mesh.num_elements} elements, order {mesh.order}, '
      f'{mesh.num_nodes} velocity / {sem.pressure.pspace.mesh.num_nodes} '
      f'pressure nodes; build {build_s:.2f} s, dense Schur assembly and '
      f'pinv {precond.assembly_seconds:.2f} s (float64, host); '
      f'nullspace {getattr(precond, "has_nullspace", False)}')
  require(sem.fast_ops is None and sem.assembled_ops is not None,
          'the cylinder must take the generic path with assembled D')
  require(not getattr(precond, 'has_nullspace', False),
          'the outflow makes E nonsingular')

  # Each run takes num_steps + 10 steps in chunks of 10.  The host clock
  # reads steps 11 to num_steps (past the impulsive start's first chunk);
  # the profiler, where asked, the live loop's last chunk, which holds its
  # solve history.
  chunk, total = 10, num_steps + 10
  runs, profiles = {}, {}
  for name, s, kw in (('generic', sem, {}),
                      ('el', sem_el, dict(use_projection=False)),
                      ('generic, no history', sem,
                       dict(use_projection=False))):
    marks, window = {}, None
    if name != 'generic, no history':
      window = StepProfiler(chunk, device, rows=8)

    def on_chunk(done, marks=marks, window=window, name=name):
      if done in (chunk, num_steps):
        torch.cuda.synchronize(device)
        marks[done] = time.perf_counter()
      if window is not None and done == num_steps:
        window.start()
      elif window is not None and done == total:
        profiles[name] = window.stop()

    if name == 'el':
      general.launches = 0
    tele = {}
    u, p, trace, forces = cyl.run_cylinder_scan(
        s, dt=dt, num_steps=total, steps_per_dispatch=chunk,
        compute_forces=True, pressure_preconditioner=precond, telemetry=tele,
        on_chunk=on_chunk, **kw)
    torch.cuda.synchronize(device)
    runs[name] = (u, p, forces, tele)
    if name == 'el':
      launches['stiffness2d_general_cylinder'] = general.launches
    ms = (marks[num_steps] - marks[chunk]) / (num_steps - chunk) * 1e3
    vi, pi = tele['viscous_iterations'], tele['pressure_iterations']
    cd = float(forces[-1, 0]) * 20.0
    log(f'[{33 if name == "generic" else 34}] cylinder {name}: '
        f'{total} steps, {ms:.3f} ms/step (host clock, steps {chunk + 1}-'
        f'{num_steps}), viscous CG iterations mean {np.mean(vi):.2f} max '
        f'{max(vi)}, pressure CG first steps {pi[:START_STEPS]}, max after '
        f'{max(pi[START_STEPS:])}, C_d at the end {cd:.4f}, probe '
        f'{trace[-1]:+.5f}')
    if profiles.get(name) is not None:
      log(f'[33/34] cylinder {name}: '
          f'{profiles[name]["launches_per_step"]:.1f} launches a step, '
          f'device busy {100 * profiles[name]["busy_share"]:.1f} % (steps '
          f'{num_steps + 1}-{total} of the live loop, profiled)')
    require(all_finite((u, p)) and np.isfinite(forces).all(), name)
    # From the fifth step on: the impulsive start's first float32 pressure
    # solves sit on the rounding floor of the dense inverse (the JAX package
    # in float32: 945 iterations at the first step of this mesh).
    require(max(pi[START_STEPS:]) <= 3, (name, pi[:START_STEPS + 3]))
    require(forces[-1, 0] > 0, (name, forces[-1]))
  vi_el = runs['el'][3]['viscous_iterations']
  per_step = launches['stiffness2d_general_cylinder'] / total
  log(f'[34] stiffness2d_general launches on the E-last cylinder path: '
      f'{launches["stiffness2d_general_cylinder"]} in {total} steps '
      f'({per_step:.2f} a step; {sum(vi_el)} viscous CG iterations)')
  # Every viscous matvec is a launch: the lift's H, CG's initial residual
  # and one a CG iteration at least.
  require(launches['stiffness2d_general_cylinder'] >= sum(vi_el)
          + 2 * total, 'a viscous matvec ran without row 3')
  du = rel_err(runs['el'][0], runs['generic, no history'][0])
  dp = rel_err(runs['el'][1], runs['generic, no history'][1])
  du_h = rel_err(runs['el'][0], runs['generic'][0])
  dp_h = rel_err(runs['el'][1], runs['generic'][1])
  log(f'[34] E-last vs generic path, the same solves (no history): u rel '
      f'{du:.3e}, p rel {dp:.3e}; vs phase 33 (with the history: CG paths '
      f'differ at the 1e-5 tolerance) u rel {du_h:.3e}, p rel {dp_h:.3e}')
  # About 3x the largest readings (PERF.md section 6): u 3.1e-5, p 2.4e-3
  # over 25 pairs of runs on the card.  The pressure carries float32
  # rounding through E's conditioning, and the scatters' atomic adds run in
  # no fixed order: the generic path against itself reads p up to 2.0e-3.
  require(du <= 1e-4 and dp <= 7e-3, (du, dp))

  # -- 35. the small cylinder, card (f32) vs CPU (f64); Poisson ------------
  cpu = cyl.make_cylinder_sem(3, **small, device='cpu', dtype=torch.float64)
  cpu_el = cyl.make_cylinder_sem(3, **small, device='cpu',
                                 dtype=torch.float64,
                                 unstructured_el_ops=True)
  card = cyl.make_cylinder_sem(3, **small, device=device, dtype=dtype)
  small_runs = {}
  for name, a, b, kw in (('generic', card, cpu, {}),
                         ('el', small_el, cpu_el,
                          dict(use_projection=False))):
    outs = []
    for s in (a, b):
      outs.append(small_cylinder_steps(cyl, s, **kw))
    small_runs[name] = (a, kw, outs[0])
    du = rel_err(outs[0][0], outs[1][0])
    dp = rel_err(outs[0][1], outs[1][1])
    log(f'[35] small cylinder {name} path, 20 steps card f32 vs CPU f64: '
        f'u rel {du:.3e}, p rel {dp:.3e}')
    # About 3x the readings (PERF.md section 6): the scatters add in a
    # fixed order, and 12 card runs a path read one value, u 6.4e-5 and p
    # 3.1e-4 at most.  The JAX package's own float32 run is 1.7e-4 (u) and
    # 4.5e-4 (p) from its float64 run.
    require(du <= 2e-4 and dp <= 1e-3, (name, du, dp))
  for p_dtype, gate in ((torch.float64, 1e-8), (torch.float32, 1e-4)):
    pm = refine_premesh(unit_cube_mesh(8, ndim=2), Nodes1D.create(
        7, NodeType.GAUSS_LOBATTO_LEGENDRE))
    c = pm.node_coords
    exact = np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
    u = poisson.solve_poisson(pm.finalize(device=device, dtype=p_dtype),
                              2 * np.pi ** 2 * exact,
                              {'boundary': (BCType.DIRICHLET, 0)},
                              rtol=1e-10 if p_dtype == torch.float64
                              else 1e-6)
    err = float(np.abs(u.cpu().double().numpy() - exact).max())
    log(f'[35] solve_poisson on the card, 8x8 order 6, {p_dtype}: max error '
        f'against the exact sine {err:.3e} (gate {gate:g})')
    require(err <= gate, (p_dtype, err))
  return small_runs


def small_cylinder_steps(cyl, sem, **kw):
  """Phase 35's run: 20 steps of the small cylinder from the impulsive
  start."""
  return cyl.run_cylinder_scan(sem, dt=5e-4, num_steps=20,
                               steps_per_dispatch=10, kick_steps=10,
                               tol=1e-6, **kw)


def run_schwarz_phases(torch, device, kernel_checks, times, launches,
                       small_runs, *, order: int = 6, mesh=None,
                       num_steps: int = 200, repeats: int = 20) -> dict:
  """Phases 36-37: the fixed-order scatters' repeatability on the card and
  the two-level Schwarz pressure preconditioner on the JAX package's large
  cylinder (912 elements, order 6, 22,800 pressure dofs; dt at CFL 0.65,
  Re 100, BDF2, tol 1e-5, float32).  Returns the phase's readings;
  `times['stiffness2d_general']` gets row 3's timings at that cylinder's
  shape and `launches['stiffness2d_general_schwarz']` its launches on the
  E-last path there."""
  import numpy as np
  from swirlfem_tpu_torch.examples import cylinder as cyl
  from swirlfem_tpu_torch.niles.profile_datagen import StepProfiler
  from swirlfem_tpu_torch.ops import cuda_stiffness2d
  mesh = cyl.LARGE if mesh is None else mesh
  dtype = torch.float32
  general = cuda_stiffness2d.stiffness2d_general
  out = {}

  # -- 36. determinism -------------------------------------------------------
  t0 = time.perf_counter()
  sem = cyl.make_cylinder_sem(order, **mesh, device=device, dtype=dtype)
  sem_el = cyl.make_cylinder_sem(order, **mesh, device=device, dtype=dtype,
                                 unstructured_el_ops=True)
  dt = cyl.cfl_dt(sem, 0.65)
  build_s = time.perf_counter() - t0
  vmesh, pmesh = sem.velocity.mesh, sem.pressure.pspace.mesh
  log(f'[36] large cylinder: {vmesh.num_elements} elements, order {order}, '
      f'{vmesh.num_nodes} velocity / {pmesh.num_nodes} pressure nodes, dt '
      f'{dt:.4e} (CFL 0.65); both solvers built in {build_s:.2f} s')
  for name, (s, kw, first) in small_runs.items():
    again = small_cylinder_steps(cyl, s, **kw)
    same = torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
    log(f'[36] small cylinder {name} path, 20 steps twice on the card: '
        f'u and p bitwise equal {same} (u rel {rel_err(again[0], first[0]):.3e}'
        f', p rel {rel_err(again[1], first[1]):.3e})')
    require(same, f'phase 35\'s {name} steps are not repeatable')
  vel, vel_el = sem.nodal.velocity, sem_el.nodal.velocity
  gen = torch.Generator(device=device).manual_seed(36)
  rand = lambda *shape: torch.randn(shape, generator=gen, device=device,
                                    dtype=dtype)
  num_e, nper = tuple(vel.mesh.elements.shape)
  w1, w2 = rand(num_e, nper), rand(num_e, nper, 2)
  w_el = rand(*tuple(sem_el.nodal.v_el_t.shape))
  scatters = {
      'velocity mesh scatter': lambda: vel.mesh.scatter(w1),
      'velocity scatter (2 components)': lambda: vel.scatter(w2),
      'E-last velocity sum': lambda: sem_el._v_el_cov(w_el),  # pylint: disable=protected-access
  }
  for name, fn in scatters.items():
    first = fn()
    same = all(torch.equal(fn(), first) for _ in range(repeats))
    log(f'[36] {name} on the large mesh, {repeats} repeats: bitwise equal '
        f'{same}')
    require(same, name)

  # -- 37. the Schwarz preconditioner on the large cylinder -----------------
  # Row 3 at this cylinder's shape, (7, 7, 912) x 2 at order 6.
  ops = sem_el.fast_ops
  k, num_el = ops.wmass.shape[0], ops.wmass.shape[-1]
  us = tuple(kernel_checks.random_field((k, k, num_el), dtype=dtype,
                                        device=device, seed=s)
             for s in (3, 4))
  check = kernel_checks.check_stiffness2d_general(ops, us)
  log(f'[37] stiffness2d_general on the large cylinder, k={k} E={num_el}, '
      f'C = 2: {check}')
  require(check['rel_err_f64'] <= kernel_checks.STIFFNESS_REL_TOL, check)
  gs, dmat = (ops.g11, ops.g12, ops.g22), ops.mats['dmat']
  row3_t = {
      'ms': kernel_checks.time_ms(
          lambda: ops.stiffness_el_multi(us), device=device),
      'plain_ms': kernel_checks.time_ms(
          lambda: cuda_stiffness2d.stiffness2d_general_plain(us, gs, dmat),
          device=device, calls=PLAIN_CALLS),
      'library_ms': kernel_checks.time_ms(
          kernel_checks.library_general(us, gs, dmat), device=device)}
  flops, nbytes = cuda_stiffness2d.stiffness2d_counts(
      k - 1, num_el, len(us), affine=False, dtype_bytes=4)
  row3_t.update(kernel_checks.bound(flops, nbytes))
  log(f'[37] stiffness2d_general at the large cylinder\'s shape '
      f'{tuple(us[0].shape)} x 2: {row3_t["ms"] * 1e3:.2f} us (plain '
      f'{row3_t["plain_ms"] * 1e3:.2f}, library '
      f'{row3_t["library_ms"] * 1e3:.2f}, bound '
      f'{row3_t["bound_ms"] * 1e3:.3f} us, {row3_t["bound_by"]})')
  times['stiffness2d_general'].update(
      {f'schwarz_cylinder_{key}': val for key, val in row3_t.items()})
  times['stiffness2d_general']['schwarz_cylinder_max_abs_err'] = (
      check['max_abs_err'])

  precond = cyl.schwarz_preconditioner(sem, dt, **mesh)
  out.update(setup_s=precond.setup_seconds, colors=precond.colors,
             probe_applies=precond.probe_applies, coarse=precond.coarse,
             coarse_dofs=precond.coarse_dofs, overlap=precond.overlap,
             block_mb=precond.block_bytes / 2 ** 20)
  log(f'[37] Schwarz set-up {precond.setup_seconds:.2f} s (float64 probing '
      f'on the host): {precond.colors} distance-2 colours, '
      f'{precond.probe_applies} probe applies of E, overlap '
      f'{precond.overlap}, coarse {precond.coarse} ({precond.coarse_dofs} '
      f'dofs), local blocks {out["block_mb"]:.1f} MiB on the card; '
      f'nullspace {precond.has_nullspace}')
  require(not precond.has_nullspace and precond.coarse == 'p1dg',
          (precond.has_nullspace, precond.coarse))
  r = rand(pmesh.num_nodes)
  first = precond(r)
  same = all(torch.equal(precond(r), first) for _ in range(repeats))
  log(f'[36] Schwarz apply (its overlap and scatter sums) on the large mesh, '
      f'{repeats} repeats: bitwise equal {same}')
  require(same, 'the Schwarz apply is not repeatable')

  chunk, total = 10, num_steps + 10
  runs, start_steps = {}, 4
  for name, s, kw in (('el', sem_el, dict(use_projection=False)),
                      ('generic', sem, {}),
                      ('generic, no history', sem,
                       dict(use_projection=False))):
    marks, window, prof = {}, None, {}
    if name != 'generic, no history':
      window = StepProfiler(chunk, device, rows=8)

    def on_chunk(done, marks=marks, window=window, prof=prof):
      if done in (chunk, num_steps):
        torch.cuda.synchronize(device)
        marks[done] = time.perf_counter()
      if window is not None and done == num_steps:
        window.start()
      elif window is not None and done == total:
        prof['window'] = window.stop()

    general.launches = 0
    tele = {}
    u, p, trace = cyl.run_cylinder_scan(
        s, dt=dt, num_steps=total, steps_per_dispatch=chunk,
        pressure_preconditioner=precond, telemetry=tele, on_chunk=on_chunk,
        kick_steps=30000, **kw)
    torch.cuda.synchronize(device)
    row3 = general.launches
    ms = (marks[num_steps] - marks[chunk]) / (num_steps - chunk) * 1e3
    vi, pi = tele['viscous_iterations'], tele['pressure_iterations']
    reading = dict(ms_per_step=ms, viscous_mean=float(np.mean(vi)),
                   viscous_max=int(max(vi)), pressure_first=pi[:start_steps],
                   pressure_mean=float(np.mean(pi[start_steps:])),
                   pressure_max=int(max(pi[start_steps:])),
                   row3_per_step=row3 / total)
    if prof.get('window') is not None:
      reading.update(launches_per_step=prof['window']['launches_per_step'],
                     busy_share=prof['window']['busy_share'])
    runs[name] = (u, p, tele)
    out[name] = reading
    log(f'[37] large cylinder {name}: {total} steps, {ms:.3f} ms/step (host '
        f'clock, steps {chunk + 1}-{num_steps}), viscous CG mean '
        f'{reading["viscous_mean"]:.2f} max {reading["viscous_max"]}, '
        f'pressure CG first steps {pi[:start_steps]}, then mean '
        f'{reading["pressure_mean"]:.2f} max {reading["pressure_max"]}; row '
        f'3 {reading["row3_per_step"]:.2f} launches a step; probe '
        f'{trace[-1]:+.5f}')
    if 'launches_per_step' in reading:
      log(f'[37] large cylinder {name}: '
          f'{reading["launches_per_step"]:.1f} launches a step, device busy '
          f'{100 * reading["busy_share"]:.1f} % (steps {num_steps + 1}-'
          f'{total}, profiled)')
    require(all_finite((u, p)), name)
    # About 3x the largest reading from the fifth step on.
    require(reading['pressure_max'] <= SCHWARZ_PRESSURE_ITERATIONS,
            (name, pi[:start_steps + 3], reading['pressure_max']))
    if name == 'el':
      launches['stiffness2d_general_schwarz'] = row3
      require(row3 >= sum(vi) + 2 * total, 'a viscous matvec ran without '
              'row 3')
  du = rel_err(runs['el'][0], runs['generic, no history'][0])
  dp = rel_err(runs['el'][1], runs['generic, no history'][1])
  out.update(el_vs_generic_u=du, el_vs_generic_p=dp)
  log(f'[37] E-last vs generic path, the same solves (no history), both with '
      f'Schwarz: u rel {du:.3e}, p rel {dp:.3e}')
  require(du <= SCHWARZ_EL_GENERIC[0] and dp <= SCHWARZ_EL_GENERIC[1],
          (du, dp))

  # Three steps from the E-last run's state, with Schwarz and with plain
  # (projection-free) CG.
  hist = runs['el'][2]['history']
  with_schwarz = cyl.continue_cylinder(sem_el, hist, 3, dt=dt,
                                       pressure_preconditioner=precond)
  plain = cyl.continue_cylinder(sem_el, hist, 3, dt=dt, maxiter=5000)
  du = rel_err(with_schwarz[0], plain[0])
  dp = rel_err(with_schwarz[1], plain[1])
  out.update(plain_iterations=plain[2], schwarz_iterations=with_schwarz[2],
             schwarz_vs_plain_u=du, schwarz_vs_plain_p=dp)
  log(f'[37] 3 steps from the E-last state: pressure CG with Schwarz '
      f'{with_schwarz[2]}, plain CG {plain[2]}; Schwarz vs plain u rel '
      f'{du:.3e}, p rel {dp:.3e}')
  require(max(plain[2]) < 5000, ('plain CG hit its cap', plain[2]))
  require(du <= SCHWARZ_VS_PLAIN[0] and dp <= SCHWARZ_VS_PLAIN[1], (du, dp))
  require(5 * sum(with_schwarz[2]) <= sum(plain[2]),
          (with_schwarz[2], plain[2]))
  return out


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


# -- Phases 38-41: ranks that share the card ----------------------------------

NUM_RANKS = 4


def box_rank(ax, shard, *, cfg, tgv_solve, steps2d, steps3d, device):
  """Phases 38 and 40 on one rank (a `spmd.launch` function): the slab
  kernels against their plain versions and the float64 operator (rank 0
  times them while the others wait), then the certified sharded 2D
  datagen steps and the CG-solved sharded TGV-box steps, each kernel's
  launches counted on this rank."""
  import numpy as np
  import torch
  from swirlfem_tpu_torch.niles.datagen_distributed import (
      make_distributed_step_fn)
  from swirlfem_tpu_torch.nse.distributed import DistributedStokesBox
  from swirlfem_tpu_torch.nse.solver import extk_coeffs
  from swirlfem_tpu_torch.ops import cuda_stiffness
  from swirlfem_tpu_torch.ops import cuda_stiffness3d
  from swirlfem_tpu_torch.ops import kernel_checks
  dtype = torch.float32
  on_card = torch.device(device).type == 'cuda'
  sync = (lambda: torch.cuda.synchronize(device)) if on_card else (
      lambda: None)
  out = {}
  box2 = DistributedStokesBox(shard['slab2'], ax, device=device, dtype=dtype)
  box3 = DistributedStokesBox(shard['slab3'], ax, device=device, dtype=dtype)
  # -- 38. the kernels at the slab shapes ----------------------------------
  field = lambda shape, seed: kernel_checks.random_field(
      shape, dtype=dtype, device=device, seed=100 * ax.index + seed)
  k2, k3 = box2.ops.vinfo.order + 1, box3.ops.vinfo.order + 1
  e2 = box2.ops.wmass.shape[-1]
  e3 = box3.ops.wmass.shape[-1]
  us2 = tuple(field((k2, k2, e2), s) for s in (1, 2))
  us3 = tuple(field((k3, k3, k3, e3), s) for s in (3, 4, 5))
  out['shape2'] = (len(us2),) + tuple(us2[0].shape)
  out['shape3'] = (len(us3),) + tuple(us3[0].shape)
  if on_card:  # (a CPU rehearsal runs phase 40 alone)
    out['check2'] = kernel_checks.check_stiffness_uniform(box2.ops, us2)
    out['check3'] = kernel_checks.check_stiffness3d_uniform(box3.ops, us3)
  if on_card and ax.index == 0:
    amat = box2.ops.mats['amat']
    stack2 = torch.cat([u.reshape(k2 * k2, -1) for u in us2], dim=1)
    timed = {'times2': (lambda: box2.ops.stiffness_el_multi(us2),
                        lambda: cuda_stiffness.stiffness_uniform_plain(us2,
                                                                       amat),
                        lambda: torch.matmul(amat, stack2))}
    table = box3.ops.mats['table']
    a_dense = torch.as_tensor(cuda_stiffness3d.uniform_amat3d_np(
        box3.ops.c_uniform, box3.ops.w1, box3.ops.dmat), dtype=dtype,
                              device=device)
    stack3 = torch.cat([u.reshape(k3 ** 3, -1) for u in us3], dim=1)
    timed['times3'] = (
        lambda: cuda_stiffness3d.stiffness3d_uniform(us3, table),
        lambda: cuda_stiffness3d.stiffness3d_uniform_plain(us3, table),
        lambda: torch.matmul(a_dense, stack3))
    time_kernels(timed, out, kernel_checks, device, '[38] rank 0:')
  ax.psum(torch.zeros(1))  # the others wait for rank 0's timings
  # One collective's latency: a psum of one float on the card (through the
  # host) and on the host, 50 in a row on every rank; through the shared
  # slots, then with them off (every rank at once), through gloo.
  slots = ax.slots
  for where in ('card', 'host', 'card_gloo', 'host_gloo'):
    ax.slots = None if where.endswith('gloo') else slots
    x = torch.ones(1, device=device if where.startswith('card') else 'cpu')
    ax.psum(x)
    t0 = time.perf_counter()
    for _ in range(50):
      x = ax.psum(x) / ax.size
    float(x.sum())
    out[f'psum_ms_{where}'] = (time.perf_counter() - t0) / 50 * 1e3
  ax.slots = slots
  out['shared'] = slots is not None

  # -- 40. certified sharded 2D datagen steps -------------------------------
  advance = make_distributed_step_fn(box2, cfg, box2.to_device(shard['fbody']),
                                     exact_solves=False)
  us, ps, cus = box2.to_device(shard['state2'])
  sync()
  ax.reset_stats()
  cuda_stiffness.stiffness_uniform.launches = 0
  t0 = time.perf_counter()
  iters = []
  for _ in range(steps2d):
    u, p, cu, aux = advance.one_step(us, ps, cus)
    us, ps, cus = us[1:] + (u,), ps[1:] + (p,), cus[1:] + (cu,)
    iters.append(aux['u_star_info']['num_iterations'])
  sync()
  out['ms2'] = (time.perf_counter() - t0) / steps2d * 1e3
  out['launches2'] = cuda_stiffness.stiffness_uniform.launches
  out['iters2'] = iters
  out['stats2'] = dict(ax.stats)
  out['state2'] = (us[-1], ps[-1])

  # -- 40. CG-solved sharded TGV-box steps ----------------------------------
  solve = dict(tgv_solve)
  step = box3.make_step(time_order=2, alpha=0.05, preconditioner='fdm',
                        exact_solves=False, **solve)
  conv = box3.make_advection()
  ext = [float(c) for c in extk_coeffs(k=1)]
  us, ps, cus = box3.to_device(shard['state3'])
  sync()
  ax.reset_stats()
  cuda_stiffness3d.stiffness3d_uniform.launches = 0
  t0 = time.perf_counter()
  iters = []
  for _ in range(steps3d):
    f_el = tuple(-(ext[0] * a + ext[1] * b) for a, b in zip(*cus))
    u, p, aux = step(list(us), list(ps), f_el)
    us, ps, cus = us[1:] + (u,), ps[1:] + (p,), cus[1:] + (conv(u),)
    iters.append((aux['u_star_info']['num_iterations'],
                  aux['dp_info']['num_iterations']))
  sync()
  out['ms3'] = (time.perf_counter() - t0) / steps3d * 1e3
  out['launches3'] = cuda_stiffness3d.stiffness3d_uniform.launches
  out['iters3'] = [(int(v), int(q)) for v, q in iters]
  out['stats3'] = dict(ax.stats)
  out['state3'] = (us[-1], ps[-1])
  out['finite'] = bool(all(torch.isfinite(t).all() for t in
                           (*out['state2'][0], out['state2'][1],
                            *out['state3'][0], out['state3'][1])))
  return out


def cavity_rank(ax, shard, *, steps, order, reynolds, dt, tol, atol, device):
  """Phase 41 on one rank: this rank's partition of the lid-driven cavity
  under each exchange mode (`steps` maps a mode to its step count), from
  rest (the lid lifted, the generic operators, Jacobi viscous CG and
  projected pressure CG), each mode from the rank's row of the host's
  tables.  The state is kept after every mode's step count."""
  import torch
  from swirlfem_tpu_torch.core.bc import BCType
  from swirlfem_tpu_torch.examples.cavity import lid_boundary_field
  from swirlfem_tpu_torch.nse.solver import extk_coeffs
  from swirlfem_tpu_torch.nse.solver import StokesSEM
  dtype = torch.float32
  sync = ((lambda: torch.cuda.synchronize(device))
          if torch.device(device).type == 'cuda' else (lambda: None))
  bcs = {'boundary': (BCType.DIRICHLET, 0.0)}
  ext = [float(c) for c in extk_coeffs(k=1)]
  counts = sorted(set(steps.values()))
  out = {}
  for mode, count in steps.items():
    t0 = time.perf_counter()
    sem = StokesSEM.create(shard['premesh'], bcs, order=order, device=device,
                           dtype=dtype, axis=ax, tables=shard['tables'][mode])
    setup = time.perf_counter() - t0
    ub = lid_boundary_field(sem)
    zeros_u = torch.zeros((sem.velocity.mesh.num_nodes, 2), dtype=dtype,
                          device=device)
    zeros_p = torch.zeros(sem.pressure.pspace.mesh.num_nodes, dtype=dtype,
                          device=device)
    c0 = sem.C(zeros_u + ub)
    us, ps, cus = (zeros_u,) * 2, (zeros_p,) * 2, (c0,) * 2
    sync()
    ax.reset_stats()
    t0 = time.perf_counter()
    iters, states = [], {}
    for k in range(1, count + 1):
      cu = ext[0] * cus[0] + ext[1] * cus[1]
      u, p, aux = sem.stokes_one_step(
          list(us), list(ps), -cu, mu=1.0 / reynolds, dt=dt, time_order=2,
          u_boundary=ub, tol=tol, atol=atol, maxiter=2000)
      us, ps, cus = us[1:] + (u - ub,), ps[1:] + (p,), cus[1:] + (sem.C(u),)
      iters.append((aux['u_star_info']['num_iterations'],
                    aux['dp_info']['num_iterations']))
      if k in counts:
        states[k] = (us[-1] + ub, ps[-1])
    sync()
    wall = time.perf_counter() - t0
    plan = sem.velocity.mesh.exchange_neighbors
    out[mode] = {
        'states': states, 'setup_s': setup,
        'ms_per_step': wall / count * 1e3, 'iters': iters,
        'stats': {k: v / count for k, v in ax.stats.items()},
        'plan': type(plan).__name__ if plan is not None else 'psum',
        'v_idx': sem.velocity.mesh.node_indices,
        'p_idx': sem.pressure.pspace.mesh.node_indices,
        'v_xy': sem.velocity.mesh.node_coords,
        'p_xy': sem.pressure.pspace.mesh.node_coords}
  return out


def coordinate_rows(ref_xy, xy):
  """The row of `ref_xy` at each point of `xy` (the same node of two
  numberings of one mesh), or -1."""
  import numpy as np
  key = lambda a: [tuple(r) for r in np.round(np.asarray(a, np.float64)
                                               * 2.0 ** 24).astype(np.int64)]
  rows = {k: i for i, k in enumerate(key(ref_xy))}
  return np.asarray([rows.get(k, -1) for k in key(xy)])


def run_distributed_phases(torch, device, kernel_checks, times, launches, dg,
                           tgv_box) -> None:
  """Phases 38-41: the distributed layer on NUM_RANKS ranks that share the
  card (`parallel.spmd.launch`, gloo through host memory).

  `dg` holds the datagen solver, config, phase 4's end state and phase 5's
  certified state; `tgv_box` the Taylor-Green solver, phase 19's start
  state, solve settings and fused-key result.  Adds the slab shapes' times
  and per-rank launches to `times` and `launches`.
  """
  import dataclasses
  import numpy as np
  from swirlfem_tpu_torch.niles import datagen
  from swirlfem_tpu_torch.niles import datagen_distributed
  from swirlfem_tpu_torch.nse import distributed
  from swirlfem_tpu_torch.ops import cuda_build
  from swirlfem_tpu_torch.parallel import spmd
  cuda_build.library()  # built already; the ranks load it
  nr = NUM_RANKS
  sem, cfg = dg['sem'], dg['cfg']
  full3, tgv = tgv_box['full'], tgv_box['solve']

  # -- 38 and 40 in one launch -------------------------------------------
  t0 = time.perf_counter()
  slabs2 = distributed.split_box(sem, nr, dt=cfg.dt, time_order=cfg.time_order)
  slabs3 = distributed.split_box(full3, nr, dt=tgv['dt'], time_order=2)
  coords = sem.velocity.mesh.node_coords
  fbody = sem.velocity_to_el(
      (torch.sin(2 * np.pi * cfg.forcing_wavenumber * coords[..., 1]),))[0]
  shards = [{'slab2': slabs2[r], 'slab3': slabs3[r],
             'fbody': distributed.shard_el(fbody, r, nr, 2),
             'state2': distributed.shard_el(dg['state'], r, nr, 2),
             'state3': distributed.shard_el(tgv_box['state'], r, nr, 3)}
            for r in range(nr)]
  log(f'[38] host split of both boxes into {nr} slabs: '
      f'{time.perf_counter() - t0:.2f} s')
  steps2d, steps3d = 20, tgv_box['count']
  t0 = time.perf_counter()
  outs = spmd.launch(box_rank, shards, cfg=cfg, steps2d=steps2d,
                     steps3d=steps3d, device=str(device), timeout=900,
                     threads=None,
                     tgv_solve={k: tgv[k] for k in ('mu', 'dt', 'tol', 'atol',
                                                    'maxiter')})
  log(f'[38] {nr} ranks on {device}: launch to results '
      f'{time.perf_counter() - t0:.2f} s; one psum of a float: '
      f'{outs[0]["psum_ms_card"]:.3f} ms from the card (through the host), '
      f'{outs[0]["psum_ms_host"]:.3f} ms on the host through the shared '
      f'slots (shared: {outs[0]["shared"]}); through gloo '
      f'{outs[0]["psum_ms_card_gloo"]:.3f} and '
      f'{outs[0]["psum_ms_host_gloo"]:.3f} ms (rank 0, 50 in a row)')
  for r, o in enumerate(outs):
    log(f'[38] rank {r}: stiffness_uniform {o["shape2"]}: {o["check2"]}; '
        f'stiffness3d_uniform {o["shape3"]}: {o["check3"]}')
    require(o['check2']['rel_err_f64'] <= kernel_checks.STIFFNESS_REL_TOL,
            (r, o['check2']))
    require(o['check3']['rel_err_f64'] <= kernel_checks.STIFFNESS_REL_TOL,
            (r, o['check3']))
  for name, key, shape_key, check_key, flops_bytes in (
      ('stiffness_uniform', 'times2', 'shape2', 'check2', None),
      ('stiffness3d_uniform', 'times3', 'shape3', 'check3', None)):
    t = outs[0][key]
    shape = outs[0][shape_key]
    num_c, num_e = shape[0], shape[-1]
    if name == 'stiffness_uniform':
      k2 = shape[1] * shape[2]
      b = kernel_checks.bound(2 * k2 * k2 * num_e * num_c,
                              (k2 * k2 + 2 * num_c * k2 * num_e) * 4)
    else:
      from swirlfem_tpu_torch.ops import cuda_stiffness3d
      order = shape[1] - 1
      flops, nbytes = cuda_stiffness3d.stiffness3d_counts(
          order, num_e, num_c, variant='uniform', dtype_bytes=4)
      b = kernel_checks.bound(flops, nbytes + (order + 1) ** 2 * 4 * 4)
    entry = {'sharded_shape': list(shape), **{f'sharded_{k}': v
                                              for k, v in t.items()},
             'sharded_bound_ms': b['bound_ms'],
             'sharded_bound_by': b['bound_by'],
             'sharded_max_abs_err': max(o[check_key]['max_abs_err']
                                        for o in outs)}
    times[name].update(entry)
    log(f'[38] {name} at {shape} (rank 0, the others waiting): device '
        f'{t["ms"] * 1e3:.2f} us (plain {t["plain_ms"] * 1e3:.2f} us; '
        f'library {t["library_ms"] * 1e3:.2f} us); per eager call '
        f'{t["call_ms"] * 1e3:.2f} us; bound {b["bound_ms"] * 1e3:.2f} us '
        f'({b["bound_by"]})')

  # -- 40. the sharded steps against the single-device ones ----------------
  require(all(o['finite'] for o in outs), 'non-finite sharded state')
  u2 = distributed.unshard_el([o['state2'][0] for o in outs], 2)
  p2 = distributed.unshard_el([o['state2'][1] for o in outs], 2)
  u3 = distributed.unshard_el([o['state3'][0] for o in outs], 3)
  p3 = distributed.unshard_el([o['state3'][1] for o in outs], 3)
  cert_u, cert_p = dg['cert_state'][0][-1], dg['cert_state'][1][-1]
  fused_u, fused_p = tgv_box['fused_state'][0][-1], tgv_box['fused_state'][1][-1]
  host = lambda x: tuple(torch.as_tensor(c) for c in x)
  du2 = rel_err(host(u2), tuple(c.cpu() for c in cert_u))
  dp2 = rel_err(torch.as_tensor(p2), cert_p.cpu())
  du3 = rel_err(host(u3), tuple(c.cpu() for c in fused_u))
  dp3 = rel_err(torch.as_tensor(p3), fused_p.cpu())
  l2 = [o['launches2'] for o in outs]
  l3 = [o['launches3'] for o in outs]
  o0 = outs[0]
  log(f'[40] {steps2d} certified sharded 2D steps: {o0["ms2"]:.3f} ms/step '
      f'(rank 0), viscous CG {o0["iters2"]}, stiffness_uniform launches per '
      f'rank {l2}, collectives/step {o0["stats2"]["collectives"] / steps2d:.1f},'
      f' host-staged bytes/step {o0["stats2"]["host_bytes"] / steps2d:.0f}; '
      f'vs phase 5: u rel {du2:.3e}, p rel {dp2:.3e}')
  log(f'[40] {steps3d} CG-solved sharded TGV-box steps: {o0["ms3"]:.3f} '
      f'ms/step, CG (viscous, pressure) {o0["iters3"]}, stiffness3d_uniform '
      f'launches per rank {l3}, collectives/step '
      f'{o0["stats3"]["collectives"] / steps3d:.1f}, host-staged bytes/step '
      f'{o0["stats3"]["host_bytes"] / steps3d:.0f}; vs phase 19 (fused): u '
      f'rel {du3:.3e}, p rel {dp3:.3e}')
  require(all(n >= steps2d for n in l2), ('row 2 per rank', l2))
  require(all(n >= steps3d for n in l3), ('row 6 per rank', l3))
  require(du2 <= 1e-4 and du3 <= 1e-4, (du2, du3))
  # The pressure solves stop at their tolerances (the certified datagen
  # solve at atol 1e-4, whose second defect sweep may fire on one side
  # only: phase 6's 1e-2; the TGV box's at tol 1e-5), and the sharded FDM
  # transforms round otherwise: p read 2.6e-3 and 8.2e-5 (H100).
  require(dp2 <= 1e-2 and dp3 <= 3e-4, (dp2, dp3))
  times['stiffness_uniform']['sharded_launches_per_rank'] = l2
  times['stiffness3d_uniform']['sharded_launches_per_rank'] = l3
  times['stiffness_uniform']['sharded_launches_per_rank_step'] = (
      min(l2) / steps2d)
  times['stiffness3d_uniform']['sharded_launches_per_rank_step'] = (
      min(l3) / steps3d)

  # -- 39. distributed datagen at the reference configuration --------------
  cfg200 = dataclasses.replace(cfg, num_cycles=1, num_steps_per_cycle=200,
                               snapshot_every=10)
  t0 = time.perf_counter()
  walls, _, dstate, stats = datagen_distributed.run_simulation_distributed(
      None, cfg200, num_ranks=nr, device=device, dtype=torch.float32,
      sem=sem)
  launch_s = time.perf_counter() - t0
  state0 = datagen.initial_state(sem, cfg200)
  advance = datagen.make_step_fn(sem, cfg200)
  torch.cuda.synchronize(device)
  t0 = time.perf_counter()
  (us, ps, _), _ = advance(*state0)
  torch.cuda.synchronize(device)
  single_ms = (time.perf_counter() - t0) / 200 * 1e3
  du = rel_err(host(dstate[0][-1]), tuple(c.cpu() for c in us[-1]))
  dp = rel_err(torch.as_tensor(dstate[1][-1]), ps[-1].cpu())
  ms = walls[0] / 200 * 1e3
  log(f'[39] run_simulation_distributed, {cfg.resolution}^2 order '
      f'{cfg.order}, {nr} ranks on one card, 200 steps: {ms:.3f} ms/step '
      f'(rank 0, host clock; the single-device loop {single_ms:.3f}), '
      f'{stats["collectives_per_step"]:.1f} collectives/step, '
      f'{stats["host_bytes_per_step"]:.0f} host-staged bytes/step; launch to '
      f'results {launch_s:.1f} s; vs single-device: u rel {du:.3e}, p rel '
      f'{dp:.3e}')
  require(all_finite(tuple(torch.as_tensor(c) for c in dstate[0][-1])),
          'non-finite distributed datagen state')
  # Phase 6's gates (u 1e-4; p 1e-2, the exact solve's second sweep may
  # fire on one side only), p tightened to 3x its reading (7.8e-4, H100).
  require(du <= 1e-4 and dp <= 2.5e-3, (du, dp))

  run_cavity_phase(torch, device)


# Phase 41's steps a mode.  A partitioned cavity step takes 400-650
# pressure CG iterations (no preconditioner off the structured box) and
# 2,000-3,000 collectives of ~2 ms each from the card: ~5-6 s a step on an
# H100 in every mode (up to ~9 s on a slow host).  The psum mode runs 10
# steps (20, those of the walled phases, until the script outgrew its
# time); the neighbor and owner modes, whose arithmetic is the psum
# mode's (every sum in ascending rank order), run 3 and are held bitwise
# to the psum mode's state there.  All three at 20 took 369 s of the
# script's 889 s.
CAVITY_STEPS = {'psum': 10, 'neighbors': 3, 'owner': 3}
# (u, p) gates relative to the unpartitioned run's largest entry, by step
# count: about 3x the readings on an H100 (20 steps: 2.38e-7, 1.22e-5; 10
# steps: 2.98e-7, 1.10e-5; 3 steps: 1.61e-6, 1.14e-5; the same in every
# mode).
CAVITY_GATES = {20: (7.5e-7, 4e-5), 10: (9e-7, 3.3e-5), 3: (5e-6, 3.5e-5)}


def run_cavity_phase(torch, device, steps=None) -> None:
  """Phase 41: the lid-driven cavity partitioned NUM_RANKS ways, each
  exchange mode its `steps[mode]` steps (`CAVITY_STEPS`) against the
  unpartitioned run on the card, and against the psum mode's state after
  as many steps, bitwise.  The host builds each mode's tables once and
  ships every rank its row; a rank does its host work on one thread (the
  rest is on the card, and 4 ranks of 8 threads swamp a CPU rehearsal)."""
  import numpy as np
  from swirlfem_tpu_torch.core.bc import BCType
  from swirlfem_tpu_torch.examples.cavity import lid_boundary_field
  from swirlfem_tpu_torch.nse.solver import extk_coeffs
  from swirlfem_tpu_torch.nse.solver import StokesSEM
  from swirlfem_tpu_torch.parallel import spmd
  from swirlfem_tpu_torch.utils import partition
  from swirlfem_tpu_torch.utils.box import unit_cube_mesh
  steps = dict(steps or CAVITY_STEPS)
  nr = NUM_RANKS
  # -- 41. the lid-driven cavity partitioned 4 ways -------------------------
  n_el, order, re_, dt_ = 16, 7, 100.0, 1e-3
  tol, atol = 1e-6, 1e-9
  pm = unit_cube_mesh(n_el, ndim=2)
  parts = partition.partition(pm, nr)
  counts = np.bincount(parts, minlength=nr)
  bcs = {'boundary': (BCType.DIRICHLET, 0.0)}
  ref = StokesSEM.create(pm, bcs, order=order, device=device,
                         dtype=torch.float32)
  ub = lid_boundary_field(ref)
  zu = torch.zeros((ref.velocity.mesh.num_nodes, 2), device=device)
  zp = torch.zeros(ref.pressure.pspace.mesh.num_nodes, device=device)
  us, ps, cus = (zu,) * 2, (zp,) * 2, (ref.C(zu + ub),) * 2
  ext = [float(c) for c in extk_coeffs(k=1)]
  refs = {}
  for k in range(1, max(steps.values()) + 1):
    u, p, _ = ref.stokes_one_step(
        list(us), list(ps), -(ext[0] * cus[0] + ext[1] * cus[1]),
        mu=1.0 / re_, dt=dt_, time_order=2, u_boundary=ub, tol=tol,
        atol=atol, maxiter=2000)
    us, ps, cus = us[1:] + (u - ub,), ps[1:] + (p,), cus[1:] + (ref.C(u),)
    if k in steps.values():
      refs[k] = ((us[-1] + ub).cpu().numpy(), ps[-1].cpu().numpy())
  t0 = time.perf_counter()
  parted = pm.replace(partitions=parts)
  tables = {mode: StokesSEM.partition_tables(parted, order,
                                             exchange_mode=mode)
            for mode in steps}
  shards = [{'premesh': parted,
             'tables': {mode: rows[r] for mode, rows in tables.items()}}
            for r in range(nr)]
  log(f'[41] host tables of {len(steps)} modes, built once: '
      f'{time.perf_counter() - t0:.2f} s')
  t0 = time.perf_counter()
  outs = spmd.launch(cavity_rank, shards, steps=steps, order=order,
                     reynolds=re_, dt=dt_, tol=tol, atol=atol,
                     device=str(device), timeout=900, threads=1)
  log(f'[41] cavity {n_el}^2 order {order} in {nr} parts '
      f'(utils.partition: {counts.tolist()} elements): launch to results '
      f'{time.perf_counter() - t0:.1f} s')
  ref_v = ref.velocity.mesh.node_coords.numpy()
  ref_p = ref.pressure.pspace.mesh.node_coords.numpy()
  for mode, count in steps.items():
    u_ref, p_ref = refs[count]
    res = [o[mode] for o in outs]
    # The psum mode's arithmetic: its state after as many steps, bitwise.
    as_psum = all(
        np.array_equal(a, b) for o in outs
        for a, b in zip(o[mode]['states'][count], o['psum']['states'][count]))
    # Every copy of a shared velocity dof, on every rank, bitwise equal;
    # then each node against the unpartitioned run's node at its place
    # (the structured box numbers its nodes otherwise).
    num_v = int(max(r['v_idx'].max() for r in res)) + 1
    first = np.full((num_v, 2), np.nan, dtype=np.float32)
    same = True
    u_glob = np.full_like(u_ref, np.nan)
    p_glob = np.full_like(p_ref, np.nan)
    for r in res:
      u_r, p_r = r['states'][count]
      valid = r['v_idx'] >= 0
      ids, vals = r['v_idx'][valid], u_r[valid]
      seen = ~np.isnan(first[ids, 0])
      same &= bool(np.array_equal(first[ids[seen]], vals[seen]))
      first[ids[~seen]] = vals[~seen]
      at = coordinate_rows(ref_v, r['v_xy'][valid])
      require((at >= 0).all(), f'{mode}: a velocity node off the mesh')
      u_glob[at] = vals
      valid = r['p_idx'] >= 0
      at = coordinate_rows(ref_p, r['p_xy'][valid])
      require((at >= 0).all(), f'{mode}: a pressure node off the mesh')
      p_glob[at] = p_r[valid]
    require(not np.isnan(u_glob).any() and not np.isnan(p_glob).any(),
            f'{mode}: a dof is missing')
    du = float(np.abs(u_glob - u_ref).max() / np.abs(u_ref).max())
    dp = float(np.abs(p_glob - p_ref).max() / np.abs(p_ref).max())
    r0 = res[0]
    log(f'[41] {mode} ({r0["plan"]}), {count} steps: '
        f'{r0["ms_per_step"]:.2f} ms/step (rank 0), set-up '
        f'{r0["setup_s"]:.2f} s, CG (viscous, pressure) first/last '
        f'{r0["iters"][0]}/{r0["iters"][-1]}, collectives/step '
        f'{r0["stats"]["collectives"]:.0f}, host-staged bytes/step '
        f'{r0["stats"]["host_bytes"]:.0f}; copies bitwise equal {same}; '
        f'bitwise the psum mode\'s state {as_psum}; vs unpartitioned: u rel '
        f'{du:.3e}, p rel {dp:.3e}')
    require(same, f'{mode}: the copies of a shared dof differ')
    require(as_psum, f'{mode}: the state differs from the psum mode\'s')
    gate_u, gate_p = CAVITY_GATES[count]
    require(du <= gate_u and dp <= gate_p, (mode, count, du, dp))


# -- Phases 42-44: the distributed layer, part two -----------------------------

# The full-width distributed Schwarz run (phase 43): the JAX package's
# `experiments/schwarz_scale.py` configuration, its 8 partitions cut to the
# 4 ranks.  The ranks run it twice from the same float64 tables: in
# float32 at tol 1e-5 (the configuration's cut of the JAX run's float64 at
# 1e-8) for the times, the CG counts and the collectives, and in float64
# at the JAX run's tol 1e-8 for the steps' agreement with the same steps
# unpartitioned.  Two correct float32 runs at tol 1e-5 sit ~7e-2 apart in
# p after 5 steps on this mesh (PERF.md §6): too loose a yardstick for the
# partitioning.  Both stop at the relative test alone (atol 0; the JAX
# run's atol = tol = 1e-8 sits below its relative test in float64).
SCHWARZ_SCALE = dict(n=128, order=4, dt=1e-2, time_order=2, mu=1e-3,
                     tol=1e-5, tol64=1e-8, atol=0.0, steps=5, repeats=20)
# Phases 43-44's gates, relative to the reference's largest entry: about
# 3x the readings on an H100 (each the same in every call that read it):
# the float32 apply 2.389e-6 and the float64 one 2.687e-15 from the
# single-device float64 apply; the float64 steps u 1.226e-11, p 1.063e-10
# from the unpartitioned ones; at most 13 (float32) and 22 (float64)
# pressure CG iterations a step; the cavity gradient 2.590e-7, the scalar
# 3.578e-7.  The sharded gradient (a float32 sum over the ranks of about
# 5.35e9) reads 2.392e-8 and read 8.155e-8 under an earlier forcing: its
# gate is four float32 ulps (1.19e-7 each), not 3x one input's rounding.
LATE_GATES = {'apply': 7.2e-6, 'apply64': 8.1e-15, 'u43': 3.7e-11,
              'p43': 3.2e-10, 'iters43': {'float32': 39, 'float64': 66},
              'grad_box': 5e-7, 'grad_cavity': 7.8e-7, 'scalar': 1.1e-6}


def _host_adjoint(name, gs, size):
  """Every rank's input cotangent from every rank's output cotangent (the
  adjoint of each collective as `late_rank` calls it)."""
  import numpy as np
  ring = [(i, (i + 1) % size) for i in range(size)]
  out = []
  for r in range(size):
    if name == 'psum':
      total = gs[0]
      for g in gs[1:]:
        total = total + g
    elif name == 'ppermute':
      dst = [d for s, d in ring[:-1] if s == r]
      total = gs[dst[0]] if dst else np.zeros_like(gs[0])
    elif name == 'all_to_all':       # split 0, concat 1 (tiled)
      cols = gs.shape[2] // size
      total = np.concatenate([gs[j][:, r * cols:(r + 1) * cols]
                              for j in range(size)], axis=0)
    elif name == 'all_gather':       # stacked at axis 1
      total = gs[0][:, r]
      for g in gs[1:]:
        total = total + g[:, r]
    out.append(total)
  return out


def _comm_checks(ax, shard, device):
  """Phase 42 on one rank: every result on the card, read back."""
  import numpy as np
  import torch
  from swirlfem_tpu_torch.parallel import crystal_router
  from swirlfem_tpu_torch.parallel import pscan
  from swirlfem_tpu_torch.parallel import repartition
  me = ax.index
  out = {'scan': {}, 'route': {}}
  ops = {'add': torch.add, 'mul': torch.mul, 'maximum': torch.maximum,
         'minimum': torch.minimum}
  vals = torch.as_tensor(shard['scan_values'][me], device=device)
  for name, op in ops.items():
    for method in ('all_gather', 'tree'):
      out['scan'][(name, method)] = pscan.pscan(vals, op, ax, reduction=True,
                                                method=method)
  ints = torch.as_tensor(shard['bits'][me], device=device)
  out['preduce'] = pscan.preduce(ints, torch.bitwise_or, ax)
  route = shard['route']
  data = {'a': torch.as_tensor(route['a'][me], device=device),
          'b': torch.as_tensor(route['b'][me], device=device)}
  target = torch.as_tensor(route['target'][me], device=device)
  for impl in ('dense', 'ppermute', 'ragged'):
    out['route'][impl] = crystal_router.crystal_router_spmd(
        int(route['n'][me]), data, target, ax=ax,
        out_capacity=route['capacity'], implementation=impl)
  rp = shard['repartition']
  fields = {'u': torch.as_tensor(rp['fields'], device=device)}
  t0 = time.perf_counter()
  there, _ = repartition.repartition_element_fields(ax, rp['old'], rp['new'],
                                                    fields)
  back, _ = repartition.repartition_element_fields(ax, rp['new'], rp['old'],
                                                   there)
  out['repartition'] = {'there': there['u'], 'back': back['u'],
                        'ms': (time.perf_counter() - t0) * 1e3}
  rng = np.random.default_rng(42)
  ring = [(i, (i + 1) % ax.size) for i in range(ax.size)]
  cases = {'psum': lambda x: ax.psum(x),
           'ppermute': lambda x: ax.ppermute(x, ring[:-1]),
           'all_to_all': lambda x: ax.all_to_all(x, 0, 1),
           'all_gather': lambda x: ax.all_gather(x, 1)}
  out['adjoint'] = {}
  for name, fn in cases.items():
    xs = rng.standard_normal((ax.size, ax.size, 2))
    x = torch.as_tensor(xs[me], device=device).requires_grad_()
    y = fn(x)
    gs = rng.standard_normal((ax.size,) + tuple(y.shape))
    y.backward(torch.as_tensor(gs[me], device=device))
    out['adjoint'][name] = {'gs': gs, 'grad': x.grad}
  return out


def late_rank(ax, shard, *, device, scale, cfg, cavity):
  """Phases 42-44 on one rank (a `spmd.launch` function)."""
  import torch
  from swirlfem_tpu_torch.core.bc import BCType
  from swirlfem_tpu_torch.examples.cavity import lid_boundary_field
  from swirlfem_tpu_torch.nse.distributed import DistributedStokesBox
  from swirlfem_tpu_torch.nse.scalar import ScalarTransport
  from swirlfem_tpu_torch.nse.solver import StokesSEM
  from swirlfem_tpu_torch.ops import cuda_stiffness
  from swirlfem_tpu_torch.ops.fdm_element import build_element_fdm
  dtype = torch.float32
  sync = ((lambda: torch.cuda.synchronize(device))
          if torch.device(device).type == 'cuda' else (lambda: None))
  bcs = {'boundary': (BCType.DIRICHLET, 0.0)}
  out = {}
  # -- 42. the communication layer ------------------------------------------
  out['comm'] = _comm_checks(ax, shard['comm'], device)

  # -- 43. the full-width distributed Schwarz -------------------------------
  # float32 at tol 1e-5 (the configuration's cut) for the times, the CG
  # counts and the collectives; float64 at the JAX run's tol 1e-8 for the
  # steps' agreement with the unpartitioned run.
  s43 = shard['s43']
  out['s43'] = {}
  for rank_dtype, tol in ((torch.float32, scale['tol']),
                          (torch.float64, scale['tol64'])):
    t0 = time.perf_counter()
    sem = StokesSEM.create(s43['premesh'], bcs, order=scale['order'],
                           device=device, dtype=rank_dtype, axis=ax,
                           tables=s43['tables'])
    m = s43['schwarz'].on_rank(ax, device=device, dtype=rank_dtype)
    fdm = build_element_fdm(sem)
    sync()
    res = {'setup_s': time.perf_counter() - t0}
    r = torch.as_tensor(s43['r'], dtype=rank_dtype, device=device)
    y = m(r)
    sync()
    ax.reset_stats()
    t0 = time.perf_counter()
    same = True
    for _ in range(scale['repeats']):
      same &= bool(torch.equal(m(r), y))
    sync()
    res['apply'] = {'y': y, 'bitwise': same,
                    'ms': (time.perf_counter() - t0) / scale['repeats'] * 1e3,
                    'collectives': ax.stats['collectives'] / scale['repeats']}
    u0 = torch.as_tensor(s43['u0'], dtype=rank_dtype, device=device)
    zp = torch.zeros(sem.pressure.pspace.mesh.num_nodes, dtype=rank_dtype,
                     device=device)
    us, ps = [u0, 0.9 * u0], [zp, zp]
    sync()
    ax.reset_stats()
    t0 = time.perf_counter()
    iters = []
    for _ in range(scale['steps']):
      u, p, aux = sem.stokes_one_step(
          us, ps, 0.0, pressure_preconditioner=m, viscous_fdm=fdm,
          mu=scale['mu'], dt=scale['dt'], time_order=scale['time_order'],
          tol=tol, atol=scale['atol'], maxiter=2000)
      us, ps = [us[-1], u], [ps[-1], p]
      iters.append((int(aux['u_star_info']['num_iterations']),
                    int(aux['dp_info']['num_iterations'])))
    sync()
    res['steps'] = {'u': us[-1], 'p': ps[-1], 'iters': iters,
                    'ms': (time.perf_counter() - t0) / scale['steps'] * 1e3,
                    'stats': {k: v / scale['steps']
                              for k, v in ax.stats.items()}}
    out['s43'][str(rank_dtype).removeprefix('torch.')] = res
    del sem, m, fdm

  # -- 44. the certified sharded step, differentiated ------------------------
  box = DistributedStokesBox(shard['slab'], ax, device=device, dtype=dtype)
  step = box.make_step(mu=1.0 / cfg.reynolds_number, dt=cfg.dt,
                       time_order=cfg.time_order, tol=1e-5, atol=1e-4,
                       preconditioner='fdm', exact_solves=False)
  bus, bps, _ = box.to_device(shard['state'])
  f_base = box.to_device(shard['f_base'])
  theta = torch.tensor(1.0, dtype=dtype, device=device, requires_grad=True)
  sync()
  cuda_stiffness.stiffness_uniform.launches = 0
  t0 = time.perf_counter()
  u, _, _ = step(list(bus), list(bps), tuple(theta * c for c in f_base))
  loss = sum((c * c).sum() for c in u)
  fwd = cuda_stiffness.stiffness_uniform.launches
  loss.backward()
  sync()
  out['grad_box'] = {'grad': float(theta.grad), 'loss': float(loss.detach()),
                     'launches_fwd': fwd,
                     'launches_bwd': cuda_stiffness.stiffness_uniform.launches
                                     - fwd,
                     'ms': (time.perf_counter() - t0) * 1e3}

  # -- 44. the partitioned cavity step, differentiated; the scalar ----------
  sem = StokesSEM.create(cavity['premesh'], bcs, order=cavity['order'],
                         device=device, dtype=dtype, axis=ax,
                         tables=shard['cavity']['tables'])
  ub = lid_boundary_field(sem)
  zu = torch.zeros((sem.velocity.mesh.num_nodes, 2), dtype=dtype,
                   device=device)
  zp = torch.zeros(sem.pressure.pspace.mesh.num_nodes, dtype=dtype,
                   device=device)
  c0 = sem.C(zu + ub)
  w = torch.as_tensor(shard['cavity']['w'], dtype=dtype, device=device)
  # The forcing's scaled part: a smooth field as a covector, split among
  # its copies (1 / multiplicity), as the JAX test splits it.
  g = torch.as_tensor(shard['cavity']['g'], dtype=dtype, device=device)
  theta = torch.tensor(1.0, dtype=dtype, device=device, requires_grad=True)
  sync()
  t0 = time.perf_counter()
  u, _, aux = sem.stokes_one_step(
      [zu, zu], [zp, zp], -c0 + theta * (w[:, None] * g),
      mu=1.0 / cavity['reynolds'],
      dt=cavity['dt'], time_order=2, u_boundary=ub, tol=cavity['tol'],
      atol=cavity['atol'], maxiter=2000)
  loss = ax.psum((w[:, None] * u * u).sum())
  loss.backward(torch.ones_like(loss) if ax.index == 0
                else torch.zeros_like(loss))
  sync()
  out['grad_cavity'] = {'grad': float(theta.grad),
                        'loss': float(loss.detach()),
                        'ms': (time.perf_counter() - t0) * 1e3,
                        'iters': (int(aux['u_star_info']['num_iterations']),
                                  int(aux['dp_info']['num_iterations']))}
  st = ScalarTransport.create(sem, bcs)
  xy = sem.velocity.mesh.node_coords.to(device=device, dtype=dtype)
  valid = (torch.as_tensor(sem.velocity.mesh.node_indices, device=device)
           >= 0).to(dtype)
  th = torch.sin(torch.pi * xy[:, 0]) * torch.sin(torch.pi * xy[:, 1]) * valid
  uu = torch.stack([torch.sin(torch.pi * xy[:, 1]) * xy[:, 0] * (1 - xy[:, 0]),
                    0.1 * torch.cos(torch.pi * xy[:, 0])], -1) * valid[:, None]
  thetas = [th, th]
  sync()
  t0 = time.perf_counter()
  for _ in range(cavity['scalar_steps']):
    new, _ = st.one_step(thetas, [uu, uu], **cavity['scalar'])
    thetas = [thetas[1], new]
  sync()
  out['scalar'] = {'theta': thetas[1],
                   'ms': (time.perf_counter() - t0)
                         / cavity['scalar_steps'] * 1e3,
                   'v_idx': sem.velocity.mesh.node_indices,
                   'v_xy': sem.velocity.mesh.node_coords}
  return out


def _cavity_forcing(xy, mask):
  """Phase 44's scaled forcing on the cavity: a smooth field, zero on the
  walls (rows masked by `mask`)."""
  import numpy as np
  xy = np.asarray(xy, dtype=np.float64)
  bump = np.sin(np.pi * xy[:, 0]) * np.sin(np.pi * xy[:, 1])
  return np.stack([bump, 0.5 * bump * xy[:, 0]], axis=-1) * mask


def _warped_box(n):
  """The JAX package's `experiments/schwarz_scale.py` premesh: an n x n
  unit box, warped, on the generic refine path."""
  import numpy as np
  from swirlfem_tpu_torch.utils.box import unit_cube_mesh
  pm = unit_cube_mesh(n, ndim=2)
  c = np.asarray(pm.node_coords)
  return pm.replace(node_coords=np.stack(
      [c[:, 0] + 0.06 * np.sin(np.pi * c[:, 1]),
       c[:, 1] + 0.04 * np.sin(2 * np.pi * c[:, 0])], axis=-1), box_info=None)


def run_late_distributed_phases(torch, device, times, dg) -> None:
  """Phases 42-44 on NUM_RANKS ranks that share the card, in one launch:
  the host builds every table first (the Schwarz set-up among them), then
  the ranks run, then the single-device references run on the card.
  `dg` holds the datagen solver and its config; row 2's launches on the
  differentiated sharded step go into `times`."""
  import numpy as np
  from swirlfem_tpu_torch.core.bc import BCType
  from swirlfem_tpu_torch.examples.cavity import lid_boundary_field
  from swirlfem_tpu_torch.niles import datagen
  from swirlfem_tpu_torch.nse import distributed
  from swirlfem_tpu_torch.nse.scalar import ScalarTransport
  from swirlfem_tpu_torch.nse.solver import StokesSEM
  from swirlfem_tpu_torch.ops import schwarz
  from swirlfem_tpu_torch.ops import schwarz_distributed
  from swirlfem_tpu_torch.ops.fdm_element import build_element_fdm
  from swirlfem_tpu_torch.parallel import repartition
  from swirlfem_tpu_torch.parallel import spmd
  from swirlfem_tpu_torch.utils import partition
  from swirlfem_tpu_torch.utils.box import unit_cube_mesh
  nr = NUM_RANKS
  sc = SCHWARZ_SCALE
  bcs = {'boundary': (BCType.DIRICHLET, 0.0)}
  rng = np.random.default_rng(0)
  dtype = torch.float32

  # -- 42. host inputs --------------------------------------------------------
  t0 = time.perf_counter()
  pm0 = _warped_box(sc['n'])
  parts = partition.partition(pm0, nr)
  log(f'[42] utils.partition.partition of the {sc["n"]}^2 mesh into {nr}: '
      f'{time.perf_counter() - t0:.2f} s, '
      f'{np.bincount(parts, minlength=nr).tolist()} elements')
  num_e = pm0.num_elements
  slabs = np.arange(num_e) // (num_e // nr)
  old_ids, old_counts = repartition.partition_layout(parts, nr)
  kk = sc['order'] + 1
  global_fields = rng.standard_normal((num_e, kk * kk, 2)).astype(np.float32)
  route = {'n': rng.integers(0, 7, nr), 'target': rng.integers(0, nr, (nr, 6)),
           'a': rng.standard_normal((nr, 6)).astype(np.float32),
           'b': rng.integers(0, 100, (nr, 6, 2)).astype(np.int32),
           'capacity': nr * 6}
  comm = [{'scan_values': (np.arange(nr * 3).reshape(nr, 3) % 5 + 1).astype(
               np.float32),
           'bits': np.asarray([1 << r for r in range(nr)], np.int32),
           'route': route,
           'repartition': {'old': parts, 'new': slabs,
                           'fields': np.where(
                               (old_ids[r] >= 0)[:, None, None],
                               global_fields[np.clip(old_ids[r], 0, None)],
                               0.0).astype(np.float32)}}
          for r in range(nr)]

  # -- 43. the host set-up -----------------------------------------------------
  # One float64 twin: the distributed tables (float64; each rank casts
  # them to its dtype), the single-device Schwarz and its steps.
  t0 = time.perf_counter()
  pm = pm0.replace(partitions=parts)
  twin = StokesSEM.create(pm0, bcs, order=sc['order'], device=device,
                          dtype=torch.float64)
  twin_s = time.perf_counter() - t0
  cap = (sc['n'] + 1) ** 2 + 1
  tables = schwarz_distributed.build_distributed_schwarz(
      twin, pm, bcs, sc['dt'], sc['time_order'], coarse='vertex-cheb',
      overlap=0, max_coarse_dofs=cap)
  t0 = time.perf_counter()
  rows = StokesSEM.partition_tables(pm, sc['order'], exchange_mode='neighbors')
  rows_s = time.perf_counter() - t0
  row_bytes = [tables.row(r).nbytes for r in range(nr)]
  log(f'[43] {sc["n"]}^2 warped cavity, order {sc["order"]} ({num_e} '
      f'elements) in {nr} parts: twin on the card {twin_s:.2f} s; '
      f'distributed Schwarz set-up {tables.setup_seconds:.2f} s ('
      f'{tables.colors} colours, {tables.probe_applies} probe applies, '
      f'coarse {tables.coarse} with {tables.coarse_dofs} dofs, Chebyshev '
      f'degree {tables.cheb_degree}, overlap {tables.overlap}); table bytes '
      f'a rank (float64) {row_bytes}; partitioned solver tables (neighbors) '
      f'{rows_s:.2f} s')
  single = schwarz.build_schwarz_pressure_solver(
      twin, pm0, bcs, sc['dt'], sc['time_order'], coarse='vertex-cheb',
      overlap=0, max_coarse_dofs=cap)
  log(f'[43] single-device Schwarz on the same twin: set-up '
      f'{single.setup_seconds:.2f} s')
  npn = twin.pressure.pspace.mesh.num_nodes
  r_glob = rng.standard_normal(npn)
  vc = twin.velocity.mesh.node_coords.numpy()
  mask = np.asarray(twin.velocity.interior_mask).reshape(len(vc), -1)
  u0 = np.stack([np.sin(np.pi * vc[:, 1]) * vc[:, 0] * (1 - vc[:, 0]),
                 0.1 * np.cos(np.pi * vc[:, 0])], axis=-1) * mask

  def shard(x, idx):
    valid = (idx != -1).astype(np.float64)
    return x[np.clip(idx, 0, None)] * valid.reshape(
        idx.shape + (1,) * (x.ndim - 1))

  # -- 44. host inputs ---------------------------------------------------------
  sem, cfg = dg['sem'], dg['cfg']
  # The datagen's deterministic start (independent of the earlier phases).
  start = datagen.initial_state(sem, cfg)
  box_slabs = distributed.split_box(sem, nr, dt=cfg.dt,
                                    time_order=cfg.time_order)
  # The forcing's direction: the start's velocity, as the JAX package's
  # sharded-gradient test scales it (``tests/test_distributed_fast.py:125``).
  f_base = tuple(c.contiguous() for c in start[0][-1])
  cav = dict(n=16, order=7, reynolds=100.0, dt=1e-3, tol=1e-6, atol=1e-9,
             scalar_steps=3,
             scalar=dict(kappa=1e-2, dt=1e-3, time_order=2, tol=1e-6))
  cav_pm = unit_cube_mesh(cav['n'], ndim=2)
  cav_parted = cav_pm.replace(partitions=partition.partition(cav_pm, nr))
  cav_rows = StokesSEM.partition_tables(cav_parted, cav['order'],
                                        exchange_mode='psum')
  v_ids = [row['velocity'].node_indices for row in cav_rows]
  mult = np.zeros(int(max(v.max() for v in v_ids)) + 1)
  for v in v_ids:
    np.add.at(mult, v[v >= 0], 1.0)
  shards = []
  for r in range(nr):
    p_idx = rows[r]['pressure'].node_indices
    v_idx = rows[r]['velocity'].node_indices
    w = np.where(v_ids[r] >= 0, 1.0 / mult[np.clip(v_ids[r], 0, None)], 0.0)
    row_v = cav_rows[r]['velocity']
    g_rank = _cavity_forcing(row_v.node_coords, np.ones((len(w), 1)))
    shards.append({
        'comm': comm[r],
        's43': {'premesh': pm, 'tables': rows[r],
                'schwarz': tables.row(r), 'r': shard(r_glob, p_idx),
                'u0': shard(u0, v_idx)},
        'slab': box_slabs[r],
        'state': distributed.shard_el(start, r, nr, 2),
        'f_base': distributed.shard_el(f_base, r, nr, 2),
        'cavity': {'tables': cav_rows[r], 'w': w, 'g': g_rank}})
  t0 = time.perf_counter()
  outs = spmd.launch(late_rank, shards, device=str(device), scale=sc,
                     cfg=cfg, cavity=dict(cav, premesh=cav_parted),
                     timeout=900, threads=1)
  log(f'[42-44] {nr} ranks on {device}: launch to results '
      f'{time.perf_counter() - t0:.1f} s')

  # -- 42. against the host ----------------------------------------------------
  vals = comm[0]['scan_values']
  np_ops = {'add': np.add, 'mul': np.multiply, 'maximum': np.maximum,
            'minimum': np.minimum}
  for (name, method), _ in outs[0]['comm']['scan'].items():
    op = np_ops[name]
    total = vals[0]
    for v in vals[1:]:
      total = op(total, v)
    unit = {'add': 0, 'mul': 1, 'maximum': np.finfo(np.float32).min,
            'minimum': np.finfo(np.float32).max}[name]
    for r, o in enumerate(outs):
      scan, red = o['comm']['scan'][(name, method)]
      want = np.full(3, unit, np.float32)
      for v in vals[:r]:
        want = op(want, v)
      require(np.array_equal(scan, want) and np.array_equal(red, total),
              ('pscan', name, method, r, scan, want))
  require(all(int(o['comm']['preduce']) == (1 << nr) - 1 for o in outs),
          'preduce bitwise_or')
  forms_alike = all(
      all(np.array_equal(a, b) for a, b in zip(
          _flat(o['comm']['route'][impl]), _flat(o['comm']['route']['dense'])))
      for o in outs for impl in ('ppermute', 'ragged'))
  counts = [int(o['comm']['route']['dense'][0]) for o in outs]
  want_counts = [sum(int((route['target'][s, :route['n'][s]] == d).sum())
                     for s in range(nr)) for d in range(nr)]
  require(forms_alike, 'the router forms place rows differently')
  require(counts == want_counts, (counts, want_counts))
  new_ids, new_counts = repartition.partition_layout(slabs, nr)
  there_ok = all(
      np.array_equal(o['comm']['repartition']['there'][:new_counts[r]],
                     global_fields[new_ids[r, :new_counts[r]]])
      for r, o in enumerate(outs))
  back_ok = all(np.array_equal(o['comm']['repartition']['back'],
                               comm[r]['repartition']['fields'])
                for r, o in enumerate(outs))
  require(there_ok and back_ok, ('repartition', there_ok, back_ok))
  adj_ok = True
  for name in outs[0]['comm']['adjoint']:
    gs = outs[0]['comm']['adjoint'][name]['gs']
    want = _host_adjoint(name, gs, nr)
    adj_ok &= all(np.array_equal(o['comm']['adjoint'][name]['grad'], want[r])
                  for r, o in enumerate(outs))
  require(adj_ok, 'a collective backward differs from its host adjoint')
  log(f'[42] pscan/preduce (add, mul, max, min; all_gather and tree) equal '
      f'the host oracle; router dense/ppermute/ragged bitwise alike, counts '
      f'{counts}; repartition partition -> slabs -> partition of '
      f'{num_e} x {kk * kk} x 2 element fields bitwise '
      f'({outs[0]["comm"]["repartition"]["ms"]:.1f} ms both ways, rank 0); '
      f'psum/ppermute/all_to_all/all_gather backward equal their host '
      f'adjoints')

  # -- 43. against the single-device Schwarz on the card ---------------------
  y_u = single(torch.as_tensor(r_glob, dtype=torch.float64,
                               device=device)).cpu().numpy()
  d_apply = {}
  for key in ('float32', 'float64'):
    d = 0.0
    for r, o in enumerate(outs):
      idx = rows[r]['pressure'].node_indices
      d = max(d, float(np.abs(o['s43'][key]['apply']['y'][idx >= 0]
                              - y_u[idx[idx >= 0]]).max()))
    d_apply[key] = d / np.abs(y_u).max()
  bitwise = all(o['s43'][key]['apply']['bitwise'] for o in outs
                for key in ('float32', 'float64'))
  fdm_u = build_element_fdm(twin)
  us = [torch.as_tensor(u0, dtype=torch.float64, device=device)]
  us.append(0.9 * us[0])
  zp = torch.zeros(npn, dtype=torch.float64, device=device)
  ps = [zp, zp]
  torch.cuda.synchronize(device)
  t0 = time.perf_counter()
  iters_u = []
  for _ in range(sc['steps']):
    u, p, aux = twin.stokes_one_step(
        us, ps, 0.0, mu=sc['mu'], dt=sc['dt'], time_order=sc['time_order'],
        tol=sc['tol64'], atol=sc['atol'], maxiter=2000,
        pressure_preconditioner=single, viscous_fdm=fdm_u)
    us, ps = [us[-1], u], [ps[-1], p]
    iters_u.append((int(aux['u_star_info']['num_iterations']),
                    int(aux['dp_info']['num_iterations'])))
  torch.cuda.synchronize(device)
  ms_u = (time.perf_counter() - t0) / sc['steps'] * 1e3
  u_ref, p_ref = us[-1].cpu().numpy(), ps[-1].cpu().numpy()
  # Every rank's dofs in the global numbering (each pressure dof lives on
  # one rank; a shared velocity dof's copies are equal).
  u_part = np.zeros_like(u_ref)
  p_part = np.zeros_like(p_ref)
  for r, o in enumerate(outs):
    v_idx = rows[r]['velocity'].node_indices
    p_idx = rows[r]['pressure'].node_indices
    u_part[v_idx[v_idx >= 0]] = o['s43']['float64']['steps']['u'][v_idx >= 0]
    p_part[p_idx[p_idx >= 0]] = o['s43']['float64']['steps']['p'][p_idx >= 0]
  # u relative to the reference's largest entry, p with its mean removed.
  q_part, q_ref = p_part - p_part.mean(), p_ref - p_ref.mean()
  du = float(np.abs(u_part - u_ref).max() / np.abs(u_ref).max())
  dp = float(np.abs(q_part - q_ref).max() / np.abs(q_ref).max())
  o0 = outs[0]['s43']
  for key, tol in (('float32', sc['tol']), ('float64', sc['tol64'])):
    a, st = o0[key]['apply'], o0[key]['steps']
    log(f'[43] {key}: apply {a["ms"]:.2f} ms (rank 0, mean of '
        f'{sc["repeats"]}), {a["collectives"]:.0f} collectives, vs the '
        f'single-device float64 apply rel {d_apply[key]:.3e}; '
        f'{sc["steps"]} partitioned steps at tol {tol:.0e}: '
        f'{st["ms"]:.1f} ms/step (rank 0), CG (viscous, pressure) '
        f'{st["iters"]}, collectives/step {st["stats"]["collectives"]:.0f}, '
        f'host-staged bytes/step {st["stats"]["host_bytes"]:.0f}; rank '
        f'set-up on the card {o0[key]["setup_s"]:.2f} s')
  log(f'[43] {sc["repeats"]} repeats of the apply bitwise on every rank in '
      f'both dtypes: {bitwise}; unpartitioned float64 steps on the card at '
      f'tol {sc["tol64"]:.0e}: {ms_u:.1f} ms/step, CG {iters_u}; the '
      f'partitioned float64 steps vs them: u rel {du:.3e}, p rel (mean '
      f'removed) {dp:.3e}')
  require(bitwise, 'the distributed Schwarz apply does not repeat bitwise')
  require(d_apply['float32'] <= LATE_GATES['apply'] and
          d_apply['float64'] <= LATE_GATES['apply64'], ('apply', d_apply))
  require(du <= LATE_GATES['u43'] and dp <= LATE_GATES['p43'], (du, dp))
  for key in ('float32', 'float64'):
    runs = [o['s43'][key]['steps']['iters'] for o in outs]
    require(all(p_it <= LATE_GATES['iters43'][key] for _, p_it in runs[0]),
            (key, 'pressure CG iterations', runs[0]))
    require(all(run == runs[0] for run in runs),
            (key, 'the ranks took different CG paths'))

  # -- 44. the single-device references ----------------------------------------
  mu = 1.0 / cfg.reynolds_number
  vp_el, pp_el = sem.fdm_el_preconditioners(mu, cfg.dt, cfg.time_order)
  us_, ps_, _ = start
  theta = torch.tensor(1.0, dtype=dtype, device=device, requires_grad=True)
  from swirlfem_tpu_torch.ops import cuda_stiffness
  cuda_stiffness.stiffness_uniform.launches = 0
  u, _, _ = sem.stokes_one_step_el(
      list(us_), list(ps_), tuple(theta * c for c in f_base), mu=mu,
      dt=cfg.dt, time_order=cfg.time_order, tol=1e-5, atol=1e-4,
      pressure_preconditioner_el=pp_el, viscous_preconditioner_el=vp_el,
      exact_solves=False)
  loss = sum((c * c).sum() for c in u)
  loss.backward()
  g_single = float(theta.grad)
  g_box = sum(o['grad_box']['grad'] for o in outs)
  l_box = sum(o['grad_box']['loss'] for o in outs)
  d_box = abs(g_box - g_single) / abs(g_single)
  fwd = [o['grad_box']['launches_fwd'] for o in outs]
  bwd = [o['grad_box']['launches_bwd'] for o in outs]
  log(f'[44] certified sharded datagen step, d loss/d forcing scale: '
      f'{g_box:.8e} (sum of the ranks; loss {l_box:.6e}) vs single-device '
      f'{g_single:.8e} (loss {float(loss.detach()):.6e}): rel {d_box:.3e}; '
      f'row 2 '
      f'launches per rank forward {fwd}, backward {bwd}; '
      f'{outs[0]["grad_box"]["ms"]:.1f} ms forward + backward (rank 0)')
  require(d_box <= LATE_GATES['grad_box'], ('grad box', d_box))
  require(all(n > 0 for n in fwd + bwd), ('row 2 launches', fwd, bwd))
  times['stiffness_uniform']['sharded_grad_launches_per_rank'] = {
      'forward': fwd, 'backward': bwd}

  ref = StokesSEM.create(cav_pm, bcs, order=cav['order'], device=device,
                         dtype=dtype)
  ub = lid_boundary_field(ref)
  zu = torch.zeros((ref.velocity.mesh.num_nodes, 2), dtype=dtype,
                   device=device)
  zp = torch.zeros(ref.pressure.pspace.mesh.num_nodes, dtype=dtype,
                   device=device)
  c0 = ref.C(zu + ub)
  theta = torch.tensor(1.0, dtype=dtype, device=device, requires_grad=True)
  g_field = torch.as_tensor(_cavity_forcing(
      ref.velocity.mesh.node_coords.numpy(),
      np.asarray(ref.velocity.interior_mask)),
                            dtype=dtype, device=device)
  u, _, _ = ref.stokes_one_step(
      [zu, zu], [zp, zp], -c0 + theta * g_field, mu=1.0 / cav['reynolds'],
      dt=cav['dt'],
      time_order=2, u_boundary=ub, tol=cav['tol'], atol=cav['atol'],
      maxiter=2000)
  loss = (u * u).sum()
  loss.backward()
  g_ref = float(theta.grad)
  g_cav = sum(o['grad_cavity']['grad'] for o in outs)
  d_cav = abs(g_cav - g_ref) / abs(g_ref)
  log(f'[44] partitioned cavity step (psum mode), d loss/d forcing scale: '
      f'{g_cav:.8e} (sum of the ranks) vs unpartitioned {g_ref:.8e}: rel '
      f'{d_cav:.3e}; loss {outs[0]["grad_cavity"]["loss"]:.6e} vs '
      f'{float(loss.detach()):.6e}; CG {outs[0]["grad_cavity"]["iters"]}; '
      f'{outs[0]["grad_cavity"]["ms"]:.0f} ms forward + backward (rank 0)')
  require(d_cav <= LATE_GATES['grad_cavity'], ('grad cavity', d_cav))

  st = ScalarTransport.create(ref, bcs)
  xy = ref.velocity.mesh.node_coords.to(device=device, dtype=dtype)
  th = torch.sin(torch.pi * xy[:, 0]) * torch.sin(torch.pi * xy[:, 1])
  uu = torch.stack([torch.sin(torch.pi * xy[:, 1]) * xy[:, 0] * (1 - xy[:, 0]),
                    0.1 * torch.cos(torch.pi * xy[:, 0])], -1)
  thetas = [th, th]
  with torch.no_grad():
    for _ in range(cav['scalar_steps']):
      new, _ = st.one_step(thetas, [uu, uu], **cav['scalar'])
      thetas = [thetas[1], new]
  th_ref = thetas[1].cpu().numpy()
  ref_xy = ref.velocity.mesh.node_coords.numpy()
  d_sc = 0.0
  for o in outs:
    valid = o['scalar']['v_idx'] >= 0
    at = coordinate_rows(ref_xy, o['scalar']['v_xy'][valid])
    require((at >= 0).all(), 'a scalar node off the mesh')
    d_sc = max(d_sc, float(np.abs(o['scalar']['theta'][valid]
                                  - th_ref[at]).max()))
  d_sc /= np.abs(th_ref).max()
  log(f'[44] {cav["scalar_steps"]} partitioned scalar steps: '
      f'{outs[0]["scalar"]["ms"]:.1f} ms/step (rank 0) vs unpartitioned: rel '
      f'{d_sc:.3e}')
  require(d_sc <= LATE_GATES['scalar'], ('scalar', d_sc))


# -- Phase 45: data-parallel training on ranks that share the card -----------

# The global batch of phase 45 (4 samples a rank) and its gates against the
# single-process trainer: the loss (relative, the larger of the two steps')
# and the parameters after the steps (largest difference over the largest
# parameter), 3x the readings on an NVIDIA H100 80GB HBM3 at 700 W
# (2.564e-7 and 2.755e-5: the model's bf16 autocast at batch 4 a rank
# against batch 16, amplified in the parameters by AdamW's normalisation).
DP_BATCH = 16
DP_STEPS = 2
DP_GATES = {'loss': 7.7e-7, 'params': 8.3e-5}


def dp_steps(torch, cfg, batch, steps, device, lr, axis=None) -> dict:
  """`steps` train steps of the default model (seeded by ``cfg.seed``) on
  `batch` (numpy, the global batch), on one process or, with `axis`, on
  this rank's rows of it with the global draws' rows and the gradients
  averaged across the ranks.  Returns the set-up seconds (model, solver
  and preconditioners on the device), each step's loss, host-clock ms,
  collectives, host-staged bytes and row 1 and 2 launches, and the
  parameters after each step."""
  t_setup = time.perf_counter()
  from swirlfem_tpu_torch.niles import train
  from swirlfem_tpu_torch.ops import cuda_exchange
  from swirlfem_tpu_torch.ops import cuda_stiffness
  torch.manual_seed(cfg.seed)
  model = train.create_model(cfg).to(device)
  state = train.create_train_state(model, cfg)
  sem = train.build_solver(cfg, device=device)
  preconds = train.make_solver_preconds(sem, cfg)
  size = cfg.batch_size
  rows = None
  if axis is not None:
    local = size // axis.size
    rows = slice(axis.index * local, (axis.index + 1) * local)
  tb = {key: torch.as_tensor(v if rows is None else v[rows], device=device)
        for key, v in batch.items()}
  kl_fn = train.create_kl_penalty_fn(cfg, 1)
  counters = (cuda_exchange.exchange2d, cuda_stiffness.stiffness_uniform)
  on_card = torch.device(device).type == 'cuda'
  sync = (lambda: torch.cuda.synchronize(device)) if on_card else (
      lambda: None)  # (a CPU rehearsal)
  out = {key: [] for key in ('loss', 'ms', 'collectives', 'host_bytes',
                             'launches', 'params')}
  sync()
  out['setup_s'] = time.perf_counter() - t_setup
  for step in range(steps):
    draws = train.make_draws_fn(model, size, cfg.seed, step, device, rows)
    sync()
    for c in counters:
      c.launches = 0
    if axis is not None:
      axis.reset_stats()
    t0 = time.perf_counter()
    state, metrics, _ = train.train_step(state, tb, draws, lambda _: lr,
                                         kl_fn, sem, cfg, preconds,
                                         axis=axis)
    sync()
    out['ms'].append((time.perf_counter() - t0) * 1e3)
    out['loss'].append(float(metrics['loss']))
    stats = axis.stats if axis is not None else {'collectives': 0,
                                                'host_bytes': 0}
    out['collectives'].append(stats['collectives'])
    out['host_bytes'].append(stats['host_bytes'])
    out['launches'].append([c.launches for c in counters])
    out['params'].append(torch.cat([p.detach().reshape(-1).cpu()
                                    for p in model.parameters()]).numpy())
  return out


def dp_train_rank(ax, shard, *, cfg, batch, steps, device, lr):
  """Phase 45 on one rank (a `spmd.launch` function)."""
  del shard
  import torch
  return dp_steps(torch, cfg, batch, steps, device, lr, axis=ax)


def run_data_parallel_phase(torch, device, training) -> dict:
  """Phase 45: `NUM_RANKS` data-parallel ranks sharing the card train
  `DP_STEPS` steps on a global batch of `DP_BATCH` windows of phase 30's
  frames, against the single-process trainer on the same batch, draws and
  initial parameters."""
  import numpy as np
  from swirlfem_tpu_torch.niles import config as niles_config
  from swirlfem_tpu_torch.niles import input_pipeline
  from swirlfem_tpu_torch.parallel import spmd

  cfg = niles_config.get_config()
  cfg.drag_coeff = 0.05  # the datagen's, as in phase 30
  cfg.batch_size = DP_BATCH
  lr = cfg.learning_rate * cfg.batch_size / 256.0
  batch = next(input_pipeline.create_split(
      cfg.batch_size, True, cfg, prefetch=0, seed=45,
      frames=[training['les']]))
  t0 = time.perf_counter()
  outs = spmd.launch(dp_train_rank, [None] * NUM_RANKS, cfg=cfg, batch=batch,
                     steps=DP_STEPS, device=str(device), lr=lr, timeout=900,
                     threads=1)
  launch_s = time.perf_counter() - t0
  ref = dp_steps(torch, cfg, batch, DP_STEPS, device, lr)
  r0 = outs[0]
  same = all(np.array_equal(o['params'][s], r0['params'][s])
             for o in outs[1:] for s in range(DP_STEPS))
  dloss = max(abs(a - b) / abs(b) for a, b in zip(r0['loss'], ref['loss']))
  scale = float(np.abs(ref['params'][-1]).max())
  dparams = float(np.abs(r0['params'][-1] - ref['params'][-1]).max()) / scale
  moved = float(np.abs(ref['params'][-1] - ref['params'][0]).max()) / scale
  log(f'[45] {NUM_RANKS} data-parallel ranks on {device}, global batch '
      f'{cfg.batch_size} ({cfg.batch_size // NUM_RANKS} a rank), '
      f'{DP_STEPS} steps: launch to results {launch_s:.1f} s (set-up on '
      f'rank 0 {r0["setup_s"]:.1f} s, single process {ref["setup_s"]:.1f} '
      f's); rank 0 ms/step '
      f'{[round(x, 1) for x in r0["ms"]]} (single process '
      f'{[round(x, 1) for x in ref["ms"]]}); collectives a step '
      f'{r0["collectives"]}, host-staged bytes a step {r0["host_bytes"]}; '
      f'launches (exchange2d, stiffness_uniform) a step on rank 0 '
      f'{r0["launches"]} (single process {ref["launches"]}); parameters '
      f'bitwise equal on every rank after every step: {same}; loss '
      f'{r0["loss"]} vs {ref["loss"]} (rel {dloss:.3e}, gate '
      f'{DP_GATES["loss"]:g}); parameters after {DP_STEPS} steps vs the '
      f'single process {dparams:.3e} of their scale {scale:.3e} (gate '
      f'{DP_GATES["params"]:g}; the steps moved them {moved:.3e})')
  require(same, 'the ranks\' parameters differ')
  require(all(math.isfinite(x) for o in outs for x in o['loss']),
          [o['loss'] for o in outs])
  require(dloss <= DP_GATES['loss'], dloss)
  require(dparams <= DP_GATES['params'], dparams)
  require(moved > 0, 'the parameters did not change')
  require(all(min(x) > 0 for x in r0['launches']), r0['launches'])
  return {'ms': r0['ms'], 'setup_s': r0['setup_s'],
          'collectives': r0['collectives'],
          'host_bytes': r0['host_bytes'], 'dloss': dloss,
          'dparams': dparams}


def _flat(tree):
  """The arrays of a (nested) result, in a fixed order."""
  if isinstance(tree, dict):
    return [a for k in sorted(tree) for a in _flat(tree[k])]
  if isinstance(tree, (list, tuple)):
    return [a for v in tree for a in _flat(v)]
  return [tree]


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
  frames = []  # the cycle's frames: phase 30's training data
  with tempfile.TemporaryDirectory() as tmp:
    walls, sem, state = datagen.run_simulation(
        tmp if have_h5py else None, cfg, device=device, dtype=dtype,
        frames_out=frames)
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
  dg = {'sem': sem, 'cfg': cfg, 'state': state, 'us': us,
        'cert_state': cert_state}
  run_split_phases(torch, device, dtype, tgv, kernel_checks, times,
                   launches, dg, walled, tgv_box)
  run_knob_phase(torch, device, dtype)
  training = run_training_phases(torch, device, kernel_checks, frames, dg)
  run_tiny_train_phase(torch, device)
  small_runs = run_cylinder_phases(torch, device, kernel_checks, times,
                                   launches)
  schwarz = run_schwarz_phases(torch, device, kernel_checks, times, launches,
                               small_runs)
  run_distributed_phases(torch, device, kernel_checks, times, launches, dg,
                         tgv_box)
  run_late_distributed_phases(torch, device, times, dg)
  run_data_parallel_phase(torch, device, training)

  kernels = [
      {'name': 'exchange2d', 'route': 'cuda',
       'source': 'swirlfem_tpu_torch/csrc/exchange2d.cu',
       'replaces': 'swirlfem_tpu/ops/pallas_exchange.py:43',
       'launches': launches['exchange2d'],
       'train_step_launches': training['train_step_launches']['exchange2d'],
       'train_batch': training['batch'],
       'train_step_launches_batch16':
           training['batch16_launches']['exchange2d'],
       # Both components of the 128-sample batch in one launch (phase 29).
       'batched': {key: training['batched'][key]
                   for key in ('float32', 'float64')},
       'max_abs_err': ex['max_abs_err'], **times['exchange2d']},
      {'name': 'stiffness_uniform', 'route': 'cuda',
       'source': 'swirlfem_tpu_torch/csrc/stiffness_uniform.cu',
       'replaces': 'swirlfem_tpu/ops/pallas_stiffness.py:323',
       'launches': launches['stiffness_uniform'],
       'train_step_launches':
           training['train_step_launches']['stiffness_uniform'],
       'train_step_launches_batch16':
           training['batch16_launches']['stiffness_uniform'],
       'folded_batch': training['batched']['stiffness_folded'],
       'max_abs_err': st['max_abs_err'], **times['stiffness_uniform']},
      {'name': 'stiffness2d_general', 'route': 'cuda',
       'source': 'swirlfem_tpu_torch/csrc/stiffness2d_general.cu',
       'replaces': 'swirlfem_tpu/ops/pallas_stiffness.py:165',
       'launches': launches['stiffness2d_general'],
       'cylinder_launches': launches['stiffness2d_general_cylinder'],
       'schwarz_cylinder_launches': launches['stiffness2d_general_schwarz'],
       'schwarz_cylinder_launches_per_step': schwarz['el']['row3_per_step'],
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

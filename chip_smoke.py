#!/usr/bin/env python3
"""Drives the PyTorch port's main path once on one CUDA card, and checks it.

The main path is the Kolmogorov DNS datagen of swirlfem_tpu_torch at the
reference configuration (64x64 elements, order 8, BDF3, Re 2e4, dt 1e-4)
in float32.  Phases:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels (csrc/*.cu, nvcc, sm_90a);
  3. compare each kernel with its plain PyTorch version at the slice's
     shapes: exchange2d bitwise, stiffness_uniform within 1e-5 of the
     float64 operator;
  4. run one 500-step datagen cycle through `run_simulation` (launch
     counters reset just before);
  5. run 20 certified-solve steps (FDM-seeded viscous CG, which runs the
     stiffness kernel) and hold them against the exact-solve steps;
  6. run 20 steps on the card and the same 20 through the plain path on the
     CPU, from one state, and compare;
  7. time each kernel against its plain version (CUDA events): device
     time alone ("ms") and per eager call, dispatch included ("call_ms").

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


def log(msg: str) -> None:
  print(msg, flush=True)


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


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device', file=sys.stderr)
    return 1
  from swirlfem_tpu_torch.niles import datagen
  from swirlfem_tpu_torch.ops import cuda_build
  from swirlfem_tpu_torch.ops import cuda_exchange
  from swirlfem_tpu_torch.ops import cuda_stiffness
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
      f'{exch_cycle} ({exch_cycle / cfg.num_steps_per_cycle:.1f}/step)')
  require(all_finite(state), 'non-finite datagen state')
  require(exch_cycle > 0, 'the datagen cycle never launched exchange2d')
  require(0 < cfl < 1, cfl)

  # -- 5. certified-solve steps ---------------------------------------------
  certified = datagen.make_one_step(sem, cfg, exact_solves=False)
  exact = datagen.make_one_step(sem, cfg, exact_solves=True)
  torch.cuda.synchronize(device)
  t0 = time.perf_counter()
  cert_state, auxes = steps(certified, state, 20)
  torch.cuda.synchronize(device)
  ms_cert = (time.perf_counter() - t0) / 20 * 1e3
  stiff_launches = cuda_stiffness.stiffness_uniform.launches
  launches = {'exchange2d': cuda_exchange.exchange2d.launches,
              'stiffness_uniform': stiff_launches}
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
  timed = {
      'exchange2d': (lambda: cuda_exchange.exchange2d(w),
                     lambda: cuda_exchange.exchange2d_plain(w)),
      'stiffness_uniform': (
          lambda: cuda_stiffness.stiffness_uniform(us, amat),
          lambda: cuda_stiffness.stiffness_uniform_plain(us, amat)),
  }
  times = {}
  for name, (kernel, plain) in timed.items():
    times[name] = {
        key: kernel_checks.time_ms(fn, device=device, device_only=dev_only)
        for key, fn, dev_only in (('ms', kernel, True),
                                  ('plain_ms', plain, True),
                                  ('call_ms', kernel, False),
                                  ('plain_call_ms', plain, False))}
    log(f'[7] {name}: device {times[name]["ms"] * 1e3:.2f} us (plain '
        f'{times[name]["plain_ms"] * 1e3:.2f} us); per eager call '
        f'{times[name]["call_ms"] * 1e3:.2f} us (plain '
        f'{times[name]["plain_call_ms"] * 1e3:.2f} us)')
  # GDOF/s as the JAX bench counts them: nodal velocity dofs per apply
  # (bench.py:550); FLOP/s from the dense element operator's 2 k^4 E C.
  dofs = sem.velocity.mesh.num_nodes * sem.velocity.mesh.ndim
  flops = 2 * amat.shape[0] ** 2 * us[0].shape[-1] * len(us)
  t_st = times['stiffness_uniform']['ms']
  log(f'[7] stiffness_uniform apply, {n}x{n} order {cfg.order}, 2 '
      f'components: {dofs / t_st / 1e6:.3f} GDOF/s ({dofs} nodal dofs), '
      f'{flops / t_st / 1e9:.1f} GFLOP/s')

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
  ]
  for kern in kernels:
    require(kern['launches'] > 0, kern)
    require(all(math.isfinite(kern[key]) for key in
                ('max_abs_err', 'ms', 'plain_ms', 'call_ms', 'plain_call_ms')),
            kern)
  print(json.dumps({'kernels': kernels}))
  print(smi)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())

"""3D Taylor-Green vortex at Re 1600 on the el-form path.

Counterpart of ``swirlfem_tpu/examples/taylor_green_3d.py``.  The initial
field

    u = ( sin(x) cos(y) cos(z), -cos(x) sin(y) cos(z), 0 )

on the triply periodic cube [0, 2pi]^3 transitions to turbulence, peaks in
dissipation near t ~ 9 and decays.  The step is `StokesSEM.stokes_one_step_el`
with exact FDM solves; two dissipation measures are recorded every step:

  * resolved dissipation  eps = mu/|O| sum_c u_c . A u_c  (the stiffness
    quadratic form; on a congruent box one launch of the
    ``stiffness3d_uniform`` kernel per step on a CUDA device);
  * total dissipation  -dE/dt, central differences of the per-step kinetic
    energy on the host.

Per step the kinetic energy, the dissipation, the solve iterations and the
residual stay on the device; a chunk of steps reads them once.  Run on a
GPU host from the repository root (the 16^3, order-7, alpha 0.05 run of
``experiments/tgv_16_7_a05.json``):

    python -m swirlfem_tpu_torch.examples.taylor_green_3d --alpha 0.05 \\
        --out tgv_16_7_a05.json [--profile-steps 20]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from swirlfem_tpu_torch.linalg.cg import tree_map
from swirlfem_tpu_torch.linalg.cg import vdot
from swirlfem_tpu_torch.nse.solver import extk_coeffs
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.utils.box import unit_cube_mesh

TWO_PI = 2.0 * np.pi


def create_tgv(n_el: int = 16, order: int = 7, *,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str = 'cuda') -> StokesSEM:
  """Triply periodic [0, 2pi]^3 spectral-element solver."""
  premesh = unit_cube_mesh(n_el, ndim=3, a=0.0, b=TWO_PI,
                           periodic_dims=(0, 1, 2))
  return StokesSEM.create(premesh, boundary_conditions={}, order=order,
                          device=device, dtype=dtype)


def tgv_initial(sem: StokesSEM):
  """Taylor-Green initial velocity as an el-form component tuple."""
  c = sem.velocity.mesh.node_coords.numpy()
  x, y, z = c[:, 0], c[:, 1], c[:, 2]
  u = (np.sin(x) * np.cos(y) * np.cos(z),
       -np.cos(x) * np.sin(y) * np.cos(z),
       np.zeros_like(x))
  return sem.velocity_to_el(tuple(torch.as_tensor(v) for v in u))


def _flat_el(sem, w):
  """(k,)*3 + (n,)*3 el state -> (k,)*3 + (E,) flat-E tensor."""
  info = sem.fast_ops.vinfo
  kk = info.order + 1
  return w.reshape((kk,) * 3 + (info.num_elements_per_dim ** 3,))


def make_diagnostics(sem: StokesSEM, mu: float, vol: float | None = None):
  """Returns ``(ke, diss)`` on el-form velocity tuples, as 0-d tensors.

  ke    = (1/|O|) 1/2 int |u|^2          (mass-weighted sum)
  diss  = (mu/|O|) int |grad u|^2        (stiffness quadratic form; equals
          2 mu <S:S> = mu <|omega|^2> for periodic divergence-free u)
  """
  ops = sem.fast_ops
  info = ops.vinfo
  kk = info.order + 1
  eshape = (info.num_elements_per_dim,) * 3
  wmass_el = ops.wmass.reshape((kk,) * 3 + eshape)
  if vol is None:
    vol = float(ops.wmass.double().sum())

  def ke(us_el):
    return 0.5 / vol * sum(vdot(wmass_el * u, u) for u in us_el)

  def diss(us_el):
    flat = tuple(_flat_el(sem, u) for u in us_el)
    au = ops.stiffness_el_multi(flat)
    return mu / vol * sum(vdot(a, u) for a, u in zip(au, flat))

  return ke, diss


def make_advance(sem: StokesSEM, *, mu: float, dt: float,
                 time_order: int = 2, alpha: float = 0.0,
                 steps_per_chunk: int = 200, tol: float = 1e-5,
                 atol: float = 1e-6):
  """Chunk advance ``(us, ps, cus) -> (carry, (ke, diss, iters, resid))``.

  A Python loop over `steps_per_chunk` steps (the JAX package's
  ``lax.scan``); ke, diss and resid come back as device tensors of one entry
  per step, iters as a list of ints.  The FDM inverses are built from the
  full solver, then the step runs on `StokesSEM.slim_for_el_step`.
  """
  info = sem.fast_ops.vinfo
  kk = info.order + 1
  eshape = (info.num_elements_per_dim,) * 3
  ext = [float(c) for c in extk_coeffs(k=time_order - 1)]
  vp_el, pp_el = sem.fdm_el_preconditioners(mu, dt, time_order)
  vol = float(sem.fast_ops.wmass.double().sum())
  sem = sem.slim_for_el_step()
  ke_fn, diss_fn = make_diagnostics(sem, mu, vol=vol)

  def conv_el(ut):
    outs = sem.fast_ops.convection_el(*[_flat_el(sem, c) for c in ut])
    return tuple(o.reshape((kk,) * 3 + eshape) for o in outs)

  def advance(us, ps, cus):
    kes, disses, iters, resids = [], [], [], []
    for _ in range(steps_per_chunk):
      cu = tree_map(lambda *xs: sum(e * x for e, x in zip(ext[::-1],
                                                          xs[::-1])), *cus)
      f_el = tree_map(lambda c: -c, cu)
      # maxiter stays small: a capped solve can never stall a long run.
      u, p, aux = sem.stokes_one_step_el(
          list(us), list(ps), f_el, mu=mu, dt=dt, time_order=time_order,
          alpha=alpha, tol=tol, atol=atol, maxiter=100,
          pressure_preconditioner_el=pp_el, viscous_preconditioner_el=vp_el,
          exact_solves=True)
      us, ps, cus = us[1:] + (u,), ps[1:] + (p,), cus[1:] + (conv_el(u),)
      iters.append(max(aux['u_star_info']['num_iterations'],
                       aux['dp_info']['num_iterations']))
      resids.append(torch.maximum(aux['u_star_info']['residual'],
                                  aux['dp_info']['residual']))
      kes.append(ke_fn(u))
      disses.append(diss_fn(u))
    return (us, ps, cus), (torch.stack(kes), torch.stack(disses), iters,
                           torch.stack(resids))

  return advance, conv_el


def default_dt(sem: StokesSEM, cfl: float = 0.3, u_max: float = 1.3) -> float:
  """CFL-derived step: TGV velocities stay O(1) (max |u| ~ 1.3 in the
  turbulent phase), so dt = cfl * dx_min / u_max."""
  from swirlfem_tpu_torch.niles.datagen import min_node_spacing
  return cfl * min_node_spacing(sem.velocity.mesh) / u_max


def initial_state(sem: StokesSEM, conv_el, time_order: int):
  """The el history ``(us, ps, cus)`` of the TGV initial field at rest
  pressure, `time_order` copies deep."""
  u0 = tgv_initial(sem)
  m = sem.fast_ops.pinfo.order + 1
  n = sem.fast_ops.pinfo.num_elements_per_dim
  p0 = torch.zeros((m,) * 3 + (n,) * 3, dtype=sem.dtype, device=sem.device)
  cu0 = conv_el(u0)
  return (u0,) * time_order, (p0,) * time_order, (cu0,) * time_order


def run_tgv(re: float = 1600.0, n_el: int = 16, order: int = 7, *,
            t_end: float = 20.0, dt: float | None = None,
            time_order: int = 2, alpha: float = 0.0,
            dtype: torch.dtype = torch.float32,
            device: torch.device | str = 'cuda',
            steps_per_chunk: int = 250, tol: float = 1e-5,
            num_chunks: int | None = None, verbose: bool = False) -> dict:
  """Runs TGV to ``t_end`` (or for `num_chunks` chunks); returns the KE and
  dissipation series, their peaks, the solve telemetry and the final state
  (``us``, ``ps``, ``cus``) with the full solver ``sem``."""
  sem = create_tgv(n_el, order, dtype=dtype, device=device)
  mu = 1.0 / re
  if dt is None:
    dt = default_dt(sem)
  advance, conv_el = make_advance(
      sem, mu=mu, dt=dt, time_order=time_order, alpha=alpha,
      steps_per_chunk=steps_per_chunk, tol=tol)
  us, ps, cus = initial_state(sem, conv_el, time_order)

  if num_chunks is None:
    num_chunks = max(int(round(t_end / (dt * steps_per_chunk))), 1)
  kes, disses, walls = [], [], []
  cg_iters_chunks, cg_resid_chunks = [], []
  t0 = time.perf_counter()
  for i in range(num_chunks):
    (us, ps, cus), (ke_c, diss_c, it_c, rs_c) = advance(us, ps, cus)
    ke_c = ke_c.double().cpu().numpy()
    diss_c = diss_c.double().cpu().numpy()
    cg_iters_chunks.append(int(max(it_c)))
    cg_resid_chunks.append(float(rs_c.max()))
    walls.append(time.perf_counter() - t0)
    if not np.isfinite(ke_c).all():
      t_i = (i + 1) * steps_per_chunk * dt
      raise FloatingPointError(
          f'TGV blew up in chunk {i} (t ~ {t_i:.2f}); raise the resolution '
          'or pass alpha > 0')
    kes.append(ke_c)
    disses.append(diss_c)
    if verbose:
      print(f't {(i + 1) * steps_per_chunk * dt:7.3f}  '
            f'KE {ke_c[-1]:.6f}  eps {diss_c[-1]:.6f}  '
            f'cg it/res {cg_iters_chunks[-1]}/{cg_resid_chunks[-1]:.2e}  '
            f'wall {walls[-1]:.1f} s', flush=True)

  ke = np.concatenate(kes)
  diss = np.concatenate(disses)
  t = dt * np.arange(1, ke.size + 1)
  dedt = -np.gradient(ke, dt) if ke.size > 1 else np.zeros_like(ke)
  i_peak = int(np.argmax(diss))
  j_peak = int(np.argmax(dedt[1:-1])) + 1 if ke.size > 2 else 0
  return {
      'sem': sem, 'us': us, 'ps': ps, 'cus': cus,
      't': t, 'ke': ke, 'dissipation': diss, 'dedt': dedt,
      'dt': dt, 'steps': int(ke.size),
      'wall_s': walls[-1],
      'chunk_walls_s': walls,
      'peak_dissipation': float(diss[i_peak]),
      'peak_dissipation_time': float(t[i_peak]),
      'peak_dedt': float(dedt[j_peak]),
      'peak_dedt_time': float(t[j_peak]),
      'cg_max_iters': int(max(cg_iters_chunks)),
      'cg_max_resid': float(max(cg_resid_chunks)),
      'cg_iters_per_chunk': cg_iters_chunks,
      'cg_resid_per_chunk': cg_resid_chunks,
  }


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--re', type=float, default=1600.0)
  parser.add_argument('--n-el', type=int, default=16)
  parser.add_argument('--order', type=int, default=7)
  parser.add_argument('--t-end', type=float, default=20.0)
  parser.add_argument('--alpha', type=float, default=0.05)
  parser.add_argument('--time-order', type=int, default=2)
  parser.add_argument('--steps-per-chunk', type=int, default=250)
  parser.add_argument('--out', default=None, help='JSON file of the run')
  parser.add_argument('--profile-steps', type=int, default=0,
                      help='then profile this many steps (torch.profiler)')
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit('taylor_green_3d: no CUDA device')
  device = torch.device('cuda', 0)
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
  print(f'card: {card}', flush=True)
  r = run_tgv(args.re, args.n_el, args.order, t_end=args.t_end,
              time_order=args.time_order, alpha=args.alpha, device=device,
              steps_per_chunk=args.steps_per_chunk, verbose=True)
  # The first chunk includes the one-time costs (first launches, cuBLAS
  # heuristics); steady ms/step is taken over the later chunks.
  walls = r['chunk_walls_s']
  steady = ((walls[-1] - walls[0]) / (len(walls) - 1) / args.steps_per_chunk
            * 1e3 if len(walls) > 1 else walls[0] / args.steps_per_chunk * 1e3)
  summary = {
      'card': card, 're': args.re, 'n_el': args.n_el, 'order': args.order,
      'alpha': args.alpha, 'time_order': args.time_order, 'dtype': 'float32',
      'dt': r['dt'], 'steps': r['steps'], 'wall_s': r['wall_s'],
      'ms_per_step_steady': steady,
      'peak_dissipation': r['peak_dissipation'],
      'peak_dissipation_time': r['peak_dissipation_time'],
      'peak_dedt': r['peak_dedt'], 'peak_dedt_time': r['peak_dedt_time'],
      'ke_final': float(r['ke'][-1]),
      'cg_max_iters': r['cg_max_iters'], 'cg_max_resid': r['cg_max_resid'],
  }
  print(json.dumps(summary), flush=True)
  if args.profile_steps:
    from swirlfem_tpu_torch.niles.profile_datagen import profile_steps
    sem = r['sem']
    advance, _ = make_advance(sem, mu=1.0 / args.re, dt=r['dt'],
                              time_order=args.time_order, alpha=args.alpha,
                              steps_per_chunk=args.profile_steps)
    state = (r['us'], r['ps'], r['cus'])
    summary['profile'] = profile_steps(lambda: advance(*state),
                                       args.profile_steps, device)
  if args.out:
    series = {key: np.asarray(r[key]).tolist()
              for key in ('t', 'ke', 'dissipation', 'dedt')}
    with open(args.out, 'w', encoding='utf-8') as f:
      json.dump({**summary, **series}, f)


if __name__ == '__main__':
  main()

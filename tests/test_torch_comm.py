"""The port's communication layer (`parallel.pscan`, `semi_traced`,
`crystal_router`, `repartition` and the collectives' adjoints) on gloo
ranks of this host, against the JAX package under `spmd_map` on virtual CPU
devices (``tests/test_comm.py``, ``tests/test_parallel.py:413``).

Every result must match exactly: the scans and reductions of integers and
of small floats, the router's placement in each of its forms (dense,
ppermute rotations and the uneven all-to-all), and the repartitioned
fields.  Each collective's backward is held to its adjoint computed here
from every rank's cotangent, and to `torch.autograd.gradcheck` on the
ranks.  Four ranks start once for the module, and three for the
non-power-of-two tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.parallel import crystal_router as jcr
from swirlfem_tpu.parallel import pscan as jpscan
from swirlfem_tpu.parallel.repartition import repartition_element_fields \
    as jrepartition
from swirlfem_tpu.parallel.spmd import device_mesh
from swirlfem_tpu.parallel.spmd import spmd_map
from swirlfem_tpu_torch.parallel import crystal_router
from swirlfem_tpu_torch.parallel import repartition
from swirlfem_tpu_torch.parallel import spmd
import torch_port_ranks
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

P = 4
JOPS = {'add': jnp.add, 'mul': jnp.multiply, 'maximum': jnp.maximum,
        'minimum': jnp.minimum, 'bitwise_or': jnp.bitwise_or}
TREE_OPS = ('add', 'mul', 'maximum', 'minimum')
ROUTE_SEEDS = range(6)
CAP = 6


def _scans(num):
  rng = np.random.default_rng(5)
  tree_vals = rng.integers(1, 4, size=(num, 3)).astype(np.float64)
  cases = {
      'add_int': ('add', np.arange(1, num + 1, dtype=np.int32), {}),
      'maximum_int': ('maximum', np.arange(1, num + 1, dtype=np.int32), {}),
      'exclusive': ('add', np.random.default_rng(0).integers(
          0, 10, num).astype(np.int32), {}),
      'mul_reduction': ('mul', np.arange(num, dtype=np.float64) + 1,
                        {'reduction': True}),
      'vector': ('add', np.arange(num * 3, dtype=np.float64).reshape(num, 3),
                 {}),
      'auto_big': ('add', np.ones((num, 5000)), {}),
      'tree_reduction': ('add', np.arange(1.0, num + 1.0),
                         {'reduction': True, 'method': 'tree'}),
  }
  for op in TREE_OPS:
    for method in ('tree', 'all_gather'):
      cases[f'{method}_{op}'] = (op, tree_vals, {'method': method})
  return cases


def _routes():
  cases = {}
  rng = np.random.default_rng(42)
  n = rng.integers(0, CAP + 1, P).astype(np.int32)
  target = rng.integers(0, P, (P, CAP)).astype(np.int32)
  data = rng.standard_normal((P, CAP))
  cases['roundtrip'] = {'n': n, 'target': target, 'data': {'a': data},
                        'setup': True}
  cases['growth'] = {
      'n': np.full(P, 4, np.int32), 'target': np.zeros((P, 4), np.int32),
      'data': {'a': np.arange(P * 4, dtype=np.float64).reshape(P, 4),
               'b': np.arange(P * 4, dtype=np.int32).reshape(P, 4, 1) * 2},
      'setup': True}
  for seed in ROUTE_SEEDS:
    rng = np.random.default_rng(100 + seed)
    n = rng.integers(0, CAP + 1, P).astype(np.int32)
    if seed == 0:
      n[:] = 0
    if seed == 1:
      n[:P // 2] = 0
    target = rng.integers(0, P, (P, CAP)).astype(np.int32)
    if seed == 2:
      target[:] = 3
    cases[f'forms{seed}'] = {
        'n': n, 'target': target, 'out_capacity': P * CAP,
        'data': {'a': rng.standard_normal((P, CAP)),
                 'b': rng.integers(0, 100, (P, CAP, 2)).astype(np.int32)}}
  return cases


def _ragged_case(seed, width):
  rng = np.random.default_rng(seed)
  cm = rng.integers(0, 5, (P, P))
  cm[1] = 0                 # a rank that sends nothing
  cm[:, 2] = 0              # a rank that receives nothing
  rows = []
  for s in range(P):
    r = [np.full(width, 1000.0 * s + 10 * d + k)
         for d in range(P) for k in range(cm[s, d])]
    rows.append(np.asarray(r).reshape(-1, width))
  return {'counts': cm, 'rows': rows}


def _repartition_case():
  rng = np.random.default_rng(3)
  num_elements = 37
  old = rng.integers(0, P, num_elements)
  new = rng.integers(0, P, num_elements)
  ids, counts = repartition.partition_layout(old, P)
  data = rng.standard_normal((num_elements, 5))
  stacked = np.zeros((P, ids.shape[1], 5))
  for p in range(P):
    stacked[p, :counts[p]] = data[ids[p, :counts[p]]]
  return {'old': old, 'new': new, 'stacked': stacked, 'data': data}


def _jax_scan(dmesh, name, values, kw):
  fn = spmd_map(lambda v: jpscan.pscan(v, JOPS[name], 'x', **kw), dmesh, 'x')
  out = fn(jnp.asarray(values))
  return jax.tree.map(np.asarray, out)


def _jax_preduce(op):
  return lambda v: jpscan.preduce(v, op, 'x')


def _jax_dense_router(capacity):
  return lambda n, d, t: jcr.crystal_router_spmd(
      n, d, t, axis_name='x', out_capacity=capacity, implementation='dense')


@pytest.fixture(scope='module')
def run():
  dmesh = device_mesh('x', P)
  scans = _scans(P)
  routes = _routes()
  ragged = {'slots': _ragged_case(1, 3),
            'gloo': _ragged_case(2, spmd.SHARED_BYTES // 8)}
  rp = _repartition_case()
  preduce = {'or': ('bitwise_or', np.asarray(
      [0b101, 0b011, 0b110, 0b111], dtype=np.int32))}
  shard = {'scans': scans, 'preduce': preduce, 'routes': routes,
           'ragged': ragged, 'repartition': rp, 'adjoints': 11}
  ranks = torch_port_ranks.in_background(spmd.launch, torch_port_ranks.comm,
                                         [shard] * P)
  scans3 = {'tree_reduction': _scans(3)['tree_reduction']}
  jax_out = {'scans': {k: _jax_scan(dmesh, *v) for k, v in scans.items()},
             'scans3': {k: _jax_scan(device_mesh('x', 3), *v)
                        for k, v in scans3.items()},
             'preduce': {k: np.asarray(spmd_map(
                 _jax_preduce(JOPS[name]), dmesh, 'x')(jnp.asarray(vals)))
                         for k, (name, vals) in preduce.items()}}
  router = jcr.crystal_router_setup(dmesh, 'x')
  routes_j = {}
  for key, case in routes.items():
    data = {k: jnp.asarray(v) for k, v in case['data'].items()}
    if case.get('setup'):
      fwd = router(jnp.asarray(case['n']), data, jnp.asarray(case['target']))
      routes_j[key] = jax.tree.map(np.asarray, fwd)
    else:
      fn = spmd_map(_jax_dense_router(case['out_capacity']), dmesh, 'x')
      routes_j[key] = jax.tree.map(np.asarray, fn(
          jnp.asarray(case['n']), data, jnp.asarray(case['target'])))
  jax_out['routes'] = routes_j
  out_j, counts_j = jrepartition(dmesh, 'x', rp['old'], rp['new'],
                                 {'u': jnp.asarray(rp['stacked']),
                                  'w': 2.0 * jnp.asarray(rp['stacked'])})
  jax_out['repartition'] = (jax.tree.map(np.asarray, out_j),
                            np.asarray(counts_j))
  outs = ranks.result()
  ranks3 = spmd.launch(torch_port_ranks.comm, [
      {'scans': scans3, 'preduce': {}, 'routes': {}, 'ragged': {},
       'repartition': {'old': rp['old'] % 3, 'new': rp['new'] % 3,
                       'stacked': _repartition_case_stacked(rp, 3)}}] * 3)
  return {'jax': jax_out, 'ranks': outs, 'ranks3': ranks3, 'shard': shard}


def _repartition_case_stacked(rp, num):
  ids, counts = repartition.partition_layout(rp['old'] % num, num)
  stacked = np.zeros((num, ids.shape[1], 5))
  for p in range(num):
    stacked[p, :counts[p]] = rp['data'][ids[p, :counts[p]]]
  return stacked


def test_ranks_import_no_jax(run):
  assert all(o['no_jax'] for o in run['ranks'] + run['ranks3'])


@pytest.mark.parametrize('key', sorted(_scans(P)))
def test_pscan_matches_jax(run, key):
  want = run['jax']['scans'][key]
  for r, o in enumerate(run['ranks']):
    got = o['scans'][key]
    if isinstance(want, (tuple, list)):
      for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w[r])
    else:
      np.testing.assert_array_equal(got, want[r])


def test_tree_pscan_with_reduction_non_power_of_two(run):
  scan_j, red_j = run['jax']['scans3']['tree_reduction']
  for r, o in enumerate(run['ranks3']):
    scan, red = o['scans']['tree_reduction']
    np.testing.assert_array_equal(scan, scan_j[r])
    np.testing.assert_array_equal(red, red_j[r])
  np.testing.assert_array_equal(
      [o['scans']['tree_reduction'][0] for o in run['ranks3']], [0, 1, 3])


def test_preduce_bitwise(run):
  want = run['jax']['preduce']['or']
  for r, o in enumerate(run['ranks']):
    np.testing.assert_array_equal(o['preduce']['or'], want[r])
    assert int(o['preduce']['or']) == 0b111


def test_semi_traced_scalar(run):
  for r, o in enumerate(run['ranks']):
    np.testing.assert_array_equal(o['semi']['global'], np.arange(P) < P // 2)
    assert float(o['semi']['local']) == (10.0 if r < P // 2 else 0.0)
    np.testing.assert_array_equal(o['semi']['where'],
                                  np.where(np.arange(P) < P // 2, 3, P))


def _route_oracle(n, data, target):
  buckets = [[] for _ in range(P)]
  for p in range(P):
    for j in range(int(n[p])):
      buckets[int(target[p, j])].append((p, data[p, j]))
  return buckets


def test_crystal_router_roundtrip(run):
  case = run['shard']['routes']['roundtrip']
  want_n, want_d, want_s = run['jax']['routes']['roundtrip']
  buckets = _route_oracle(case['n'], case['data']['a'], case['target'])
  for p, o in enumerate(run['ranks']):
    n_out, data_out, source = o['routes']['roundtrip']['fwd']
    assert int(n_out) == len(buckets[p]) == int(want_n[p])
    np.testing.assert_array_equal(data_out['a'], want_d['a'][p])
    np.testing.assert_array_equal(source, want_s[p])
    got = sorted(zip(source[:int(n_out)].tolist(),
                     data_out['a'][:int(n_out)].tolist()))
    assert got == sorted((s, float(v)) for s, v in buckets[p])
    n_back, data_back, _ = o['routes']['roundtrip']['back']
    assert int(n_back) == int(case['n'][p])
    np.testing.assert_array_equal(
        sorted(data_back['a'][:int(n_back)].tolist()),
        sorted(case['data']['a'][p, :case['n'][p]].tolist()))


def test_crystal_router_pytree_and_growth(run):
  want_n, want_d, want_s = run['jax']['routes']['growth']
  for p, o in enumerate(run['ranks']):
    n_out, out, source = o['routes']['growth']['fwd']
    assert int(n_out) == int(want_n[p]) == (P * 4 if p == 0 else 0)
    for key in ('a', 'b'):
      np.testing.assert_array_equal(out[key], want_d[key][p])
    np.testing.assert_array_equal(source, want_s[p])
  n0 = int(run['ranks'][0]['routes']['growth']['fwd'][0])
  assert sorted(run['ranks'][0]['routes']['growth']['fwd'][1]['a'][:n0]
                .tolist()) == list(range(P * 4))


@pytest.mark.parametrize('seed', range(12))
def test_ragged_offsets_match_jax(seed):
  rng = np.random.default_rng(seed)
  num = int(rng.integers(2, 9))
  cm = rng.integers(0, 5, (num, num)).astype(np.int32)
  if seed % 3 == 0:
    cm[rng.integers(num)] = 0
  if seed % 4 == 0:
    cm[:, rng.integers(num)] = 0
  for me in range(num):
    got = crystal_router.ragged_offsets(torch.as_tensor(cm), me)
    want = jcr.ragged_offsets(jnp.asarray(cm), me)
    for g, w in zip(got, want):
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize('seed', ROUTE_SEEDS)
def test_router_forms_match_jax_dense(run, seed):
  """The dense, ppermute and ragged forms place every row alike, and as
  the JAX package's dense form does, zeros past the count included."""
  key = f'forms{seed}'
  want_n, want_d, want_s = run['jax']['routes'][key]
  for p, o in enumerate(run['ranks']):
    for impl in ('dense', 'ppermute', 'ragged'):
      n_out, data, source = o['routes'][key][impl]
      assert int(n_out) == int(want_n[p]), (impl, p)
      np.testing.assert_array_equal(source, want_s[p], err_msg=impl)
      for leaf in ('a', 'b'):
        np.testing.assert_array_equal(data[leaf], want_d[leaf][p],
                                      err_msg=impl)


@pytest.mark.parametrize('path', ['slots', 'gloo'])
def test_ragged_all_to_all(run, path):
  case = run['shard']['ragged'][path]
  cm = case['counts']
  for d, o in enumerate(run['ranks']):
    want = [case['rows'][s][sum(cm[s, :d]):sum(cm[s, :d + 1])]
            for s in range(P)]
    want = np.concatenate(want) if want else np.zeros((0, 1))
    np.testing.assert_array_equal(o['ragged'][path], want.reshape(
        (-1,) + case['rows'][0].shape[1:]))


@pytest.mark.parametrize('num', [3, P])
def test_repartition_element_fields(run, num):
  """Routed element fields land in the new partitioning's canonical order,
  bitwise (``tests/test_parallel.py:413``), in both router forms; at 4
  ranks bitwise the JAX package's too."""
  rp = run['shard']['repartition']
  outs = run['ranks'] if num == P else run['ranks3']
  new = rp['new'] % num
  new_ids, new_counts = repartition.partition_layout(new, num)
  for p, o in enumerate(outs):
    for impl in ('dense', 'ragged'):
      got = o['repartition'][impl]
      k = new_counts[p]
      np.testing.assert_array_equal(got['u'][:k],
                                    rp['data'][new_ids[p, :k]])
      np.testing.assert_array_equal(got['w'][:k],
                                    2.0 * rp['data'][new_ids[p, :k]])
      if num == P:
        want, counts = run['jax']['repartition']
        np.testing.assert_array_equal(counts, new_counts)
        np.testing.assert_array_equal(got['u'], want['u'][p])
        np.testing.assert_array_equal(got['w'], want['w'][p])


def _host_adjoint(name, gs, size):
  """Every rank's input cotangent from every rank's output cotangent."""
  ring = [(i, (i + 1) % size) for i in range(size)]
  out = []
  for r in range(size):
    if name == 'psum':
      total = gs[0]
      for g in gs[1:]:
        total = total + g
      out.append(total)
    elif name == 'ppermute':
      dst = [d for s, d in ring[:-1] if s == r]
      out.append(gs[dst[0]] if dst else np.zeros_like(gs[0]))
    elif name == 'all_to_all':       # forward: split 0, concat 1 (tiled)
      # Rank r's row block j went to rank j, as its column block r.
      chunk = gs.shape[1]
      cols = gs.shape[2] // size
      del chunk
      out.append(np.concatenate([gs[j][:, r * cols:(r + 1) * cols]
                                 for j in range(size)], axis=0))
    elif name == 'all_to_all_untiled':  # split 0 (size), stacked at 1
      out.append(np.stack([gs[j][:, r] for j in range(size)], axis=0))
    elif name == 'all_gather':         # stacked at axis 1
      total = gs[0][:, r]
      for g in gs[1:]:
        total = total + g[:, r]
      out.append(total)
    else:                              # tiled along axis 1
      n = gs.shape[2] // size
      total = gs[0][:, r * n:(r + 1) * n]
      for g in gs[1:]:
        total = total + g[:, r * n:(r + 1) * n]
      out.append(total)
  return out


ADJOINTS = ('psum', 'ppermute', 'all_to_all', 'all_to_all_untiled',
            'all_gather', 'all_gather_tiled')


@pytest.mark.parametrize('name', ADJOINTS)
def test_collective_backward_is_its_adjoint(run, name):
  outs = run['ranks']
  gs = outs[0]['adjoints'][name]['gs']
  want = _host_adjoint(name, gs, P)
  for r, o in enumerate(outs):
    got = o['adjoints'][name]
    np.testing.assert_array_equal(got['gs'], gs)
    np.testing.assert_array_equal(got['grad'], want[r])
    assert got['gradcheck'], (name, r)
  # The backward's collectives count like any other.
  assert outs[0]['adjoints']['stats']['collectives'] > 2 * len(ADJOINTS)


def test_all_gather_through_slots_and_gloo(run):
  outs = run['ranks']
  small = np.stack([o['gather']['small'] for o in outs])
  big = np.stack([o['gather']['big'] for o in outs])
  for o in outs:
    np.testing.assert_array_equal(o['gather']['small_out'],
                                  np.moveaxis(small, 0, 1))
    np.testing.assert_array_equal(o['gather']['big_out'], big)
    np.testing.assert_array_equal(o['gather']['tiled_out'],
                                  np.concatenate(small, axis=0))

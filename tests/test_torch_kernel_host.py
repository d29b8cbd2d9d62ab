"""The host side of the 3D and split kernels, on the CPU.

The dense 3D kernel ('highest', 3xTF32): the operator's TF32 split is a
round to nearest, ties away from zero, to 10 mantissa bits; its layout is
the order of ``wgmma``'s K-major core matrices; and three TF32 passes stay in the
FP32 class where one pass does not.  The affine split kernel: its work plan
writes every (component, row, column) once and fits a block.  The pair
kernels (congruent, general and affine) and the general FP32 3D kernel:
their blocks fit at every k, their persistent walks cover every (element,
component) once, and the launch check takes k <= 10 and names the knob of
the plain path beyond.  The dense split kernel ('bf16x3' in 3D; 'bf16x3'
and 'default' on the 2D operator): its operator layout is
split_operator_np's split in wgmma's 32-byte swizzle at each panel, and its
persistent walk covers every (component, panel, element unit) once.  The
congruent FP32 3D kernel: its plan fits a block at every k and dtype, and
its persistent walk covers every (component, tile) once.  The periodic
exchange: its launch geometry writes every entry of up to four fields once
at every k.  The general 2D kernel: its block fits at every k and tile, and
its persistent walk covers every (component, element) once.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from swirlfem_tpu_torch.core.quadrature import differentiation_matrix_1d
from swirlfem_tpu_torch.core.quadrature import NodeType
from swirlfem_tpu_torch.core.quadrature import Quadrature1D
from swirlfem_tpu_torch.ops import cuda_exchange
from swirlfem_tpu_torch.ops import cuda_split
from swirlfem_tpu_torch.ops import cuda_stiffness
from swirlfem_tpu_torch.ops import cuda_stiffness2d
from swirlfem_tpu_torch.ops import cuda_stiffness3d
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
from swirlfem_tpu_torch.nse.solver import StokesSEM
import torch_port_threads  # noqa: F401  pylint: disable=unused-import


def _amat3d(order, c=(1.3, 0.8, 0.5)):
  quad = Quadrature1D.create(order + 1, NodeType.GAUSS_LOBATTO_LEGENDRE)
  return cuda_stiffness3d.uniform_amat3d_np(
      c, quad.weights, differentiation_matrix_1d(quad.nodes))


def _rna11(x32):
  """Round to 11 significant bits (TF32), ties away from zero, by frexp in
  float64: an independent spelling of ``cvt.rna.tf32.f32``."""
  x = np.asarray(x32, dtype=np.float64)
  m, e = np.frexp(x)                       # |m| in [0.5, 1)
  scaled = np.abs(m) * 2.0 ** 11           # in [1024, 2048)
  r = np.copysign(np.floor(scaled + 0.5) / 2.0 ** 11, x)  # keeps -0.0
  return np.ldexp(r, e).astype(np.float32)


@pytest.mark.parametrize('order', [2, 7])
def test_tf32_split_rounds_to_nearest_away(order):
  a64 = _amat3d(order)
  a32 = a64.astype(np.float32)
  hi, lo = cuda_stiffness3d.tf32_split_np(a64)
  np.testing.assert_array_equal(hi.view(np.uint32), _rna11(a32).view(np.uint32))
  np.testing.assert_array_equal(lo.view(np.uint32),
                                _rna11(a32 - hi).view(np.uint32))
  assert not (hi.view(np.uint32) & 0x1fff).any()
  assert not (lo.view(np.uint32) & 0x1fff).any()
  # hi + lo carries 22 significant bits of the float32 operator.
  scale = np.abs(a32).max()
  assert np.abs(hi.astype(np.float64) + lo - a32).max() <= 2.0 ** -21 * scale
  # Ties go away from zero: 1 + 2^-11 is halfway between TF32 neighbours.
  ties = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11],
                  dtype=np.float32)
  np.testing.assert_array_equal(
      cuda_stiffness3d.tf32_round_np(ties),
      np.array([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2 * 2.0 ** -10],
               dtype=np.float32))


@pytest.mark.parametrize('order', [2, 7, 9])
def test_tf32_layout_is_the_wgmma_core_matrix_order(order):
  """Entry [p, c, part, s, h, n, r, q] holds row 256 p + 8 n + r, depth
  16 c + 8 s + 4 h + q of hi (part 0) or lo (part 1): 8 x 4 core matrices
  of a K-major operand, one contiguous 32 KB run per (panel, chunk)."""
  a64 = _amat3d(order)
  k3 = a64.shape[0]
  layout = cuda_stiffness3d.dense_tf32_layout_np(a64)
  m_pad, k_pad = -(-k3 // 256) * 256, -(-k3 // 16) * 16
  assert layout.shape == (m_pad // 256, k_pad // 16, 2, 2, 2, 32, 8, 4)
  assert layout.shape == cuda_stiffness3d.dense_tf32_layout_shape(k3)
  assert layout.dtype == np.float32 and layout.flags.c_contiguous
  assert layout[0, 0].nbytes == 32768
  parts = np.zeros((2, m_pad, k_pad), np.float32)
  parts[:, :k3, :k3] = cuda_stiffness3d.tf32_split_np(a64)
  rng = np.random.default_rng(order)
  for idx in zip(*(rng.integers(0, n, 300) for n in layout.shape)):
    p, c, part, s, h, n, r, q = idx
    assert layout[idx] == parts[part, 256 * p + 8 * n + r,
                                16 * c + 8 * s + 4 * h + q], idx
  # Every entry, and the zero padding.
  back = layout.transpose(2, 0, 5, 6, 1, 3, 4, 7).reshape(2, m_pad, k_pad)
  np.testing.assert_array_equal(back, parts)


def _emulate(a64, u32, passes):
  """``lo u_hi + hi u_lo + hi u_hi`` (three passes) or ``hi u_hi`` (one),
  TF32 operands, float32 sums."""
  hi, lo = cuda_stiffness3d.tf32_split_np(a64)
  u_hi = cuda_stiffness3d.tf32_round_np(u32)
  u_lo = cuda_stiffness3d.tf32_round_np(u32 - u_hi)
  if passes == 1:
    return hi @ u_hi
  return (lo @ u_hi + hi @ u_lo) + hi @ u_hi


def test_3xtf32_reads_the_fp32_class():
  """At k = 8 (order 7) three TF32 passes read <= 1e-6 of the largest
  output from the float64 operator, as FP32 does; one pass reads > 1e-5."""
  a64 = _amat3d(7)
  u32 = np.random.default_rng(0).standard_normal((a64.shape[0], 64)).astype(
      np.float32)
  ref = a64 @ u32.astype(np.float64)
  scale = np.abs(ref).max()
  err = lambda y: np.abs(y.astype(np.float64) - ref).max() / scale
  three, one = err(_emulate(a64, u32, 3)), err(_emulate(a64, u32, 1))
  fp32 = err(a64.astype(np.float32) @ u32)
  assert three <= 1e-6 and fp32 <= 1e-6, (three, fp32)
  assert one > 1e-5, one


def test_sem3d_ops_keep_the_tf32_layout():
  """The congruent box's dense operator and its TF32 layout, made once."""
  sem = StokesSEM.create(unit_cube_mesh(2, ndim=3, periodic_dims=(0, 1, 2)),
                         {}, order=3, device='cpu', dtype=torch.float32)
  ops = sem.fast_ops
  layout = ops.dense_tf32()
  assert layout is ops.dense_tf32() and layout.dtype == torch.float32
  a64 = cuda_stiffness3d.uniform_amat3d_np(ops.c_uniform, ops.w1, ops.dmat)
  np.testing.assert_array_equal(layout.numpy(),
                                cuda_stiffness3d.dense_tf32_layout_np(a64))


# The dense 3D kernel in 'bf16x3' (csrc/stiffness3d_dense_split.cu): its
# operator layout and the persistent walk it shares with the 3xTF32 one.


def _bf16_bits(x):
  return torch.as_tensor(np.ascontiguousarray(x)).to(torch.bfloat16).view(
      torch.int16).numpy()


@pytest.mark.parametrize('order', [1, 2, 7, 9])
def test_dense_bf16_layout_is_the_wgmma_swizzled_order(order):
  """Entry [p, c, part, n, r, s, q] holds, bit for bit, row 256 p + 8 n + r
  and depth 16 c + 8 (s ^ (r >> 2 & 1)) + q of split_operator_np's hi (part
  0) or lo (part 1), zero past the operator (the depth padded to a multiple
  of 32): 32-byte rows of a K-major operand in wgmma's 32-byte swizzle, one
  contiguous 16 KB run per (panel, chunk)."""
  a64 = _amat3d(order)
  k3 = a64.shape[0]
  layout = cuda_split.dense_bf16_layout_np(a64)
  m_pad, k_pad = -(-k3 // 256) * 256, -(-k3 // 32) * 32
  assert layout.shape == (m_pad // 256, k_pad // 16, 2, 32, 8, 2, 8)
  assert layout.shape == cuda_split.dense_bf16_layout_shape(k3)
  assert layout.dtype == np.float32 and layout.flags.c_contiguous
  assert layout[0, 0].size * 2 == 16384
  split = cuda_split.split_operator_np(a64)
  want = np.zeros((2, m_pad, k_pad), dtype=np.int16)
  want[:, :split.shape[1], :split.shape[2]] = _bf16_bits(split)
  assert not want[:, k3:].any() and not want[:, :, k3:].any()
  got = _bf16_bits(layout)
  part, n, r, unit, q = np.indices(layout.shape[2:])
  for p, c in itertools.product(range(layout.shape[0]),
                                range(layout.shape[1])):
    rows = 256 * p + 8 * n + r
    depths = 16 * c + 8 * (unit ^ ((r >> 2) & 1)) + q
    np.testing.assert_array_equal(got[p, c], want[part, rows, depths])


def _dense_walk(num_e, num_c, k3, grid, panel=256, max_width=2):
  """The tiles each persistent block of the dense kernels walks
  (csrc/stiffness3d_dense.cuh: first_tile, start_tile), written out as
  (component, panel, first 64-element unit, width in units)."""
  units, panels = -(-num_e // 64), -(-k3 // panel)
  total = num_c * panels * units
  base, rem = divmod(total, grid)
  walks = []
  for b in range(grid):
    pos, end = b * base + min(b, rem), (b + 1) * base + min(b + 1, rem)
    tiles = []
    while pos < end:
      seg, off = divmod(pos, units)
      width = (2 if max_width == 2 and min(end, (seg + 1) * units) - pos >= 2
               else 1)
      tiles.append(divmod(seg, panels) + (off, width))
      pos += width
    walks.append(tiles)
  return walks


@pytest.mark.parametrize('num_sms', [132, 7])
def test_dense_walk_covers_every_unit_once(num_sms):
  """Each (component, panel, 64-element unit) in exactly one tile of one
  block, ragged E included, a tile's units in one (component, panel)
  segment; at the path's shape (16^3 elements, order 7, C = 3) 384 units
  on 132 blocks, at most 3 a block."""
  for num_e, k, num_c in itertools.product((1, 37, 64, 65, 257, 4096),
                                           (2, 5, 8, 10), (1, 3, 4)):
    k3 = k ** 3
    units, panels = -(-num_e // 64), -(-k3 // 256)
    grid = min(num_c * panels * units, num_sms)
    seen = np.zeros((num_c, panels, units), dtype=np.int64)
    for tiles in _dense_walk(num_e, num_c, k3, grid):
      for c, p, col, width in tiles:
        assert col + width <= units
        seen[c, p, col:col + width] += 1
    assert (seen == 1).all(), (num_e, k, num_c)
  if num_sms == 132:
    walks = _dense_walk(4096, 3, 512, 132)
    assert sum(w for tiles in walks for *_, w in tiles) == 384
    assert max(sum(w for *_, w in tiles) for tiles in walks) == 3


def _amat2d(order, c=(1.3, 0.2, 0.7)):
  quad = Quadrature1D.create(order + 1, NodeType.GAUSS_LOBATTO_LEGENDRE)
  return cuda_stiffness.uniform_amat_np(
      c, np.outer(quad.weights, quad.weights),
      differentiation_matrix_1d(quad.nodes))


@pytest.mark.parametrize('precision', ['bf16x3', 'default'])
@pytest.mark.parametrize('order', range(1, 11))
def test_uniform_split_layout_is_the_wgmma_swizzled_order(order, precision):
  """The 2D operator's layout at a panel P (by default k^2 rounded up to
  16, one panel; also P = 16): entry [p, c, part, n, r, s, q] holds, bit
  for bit, row P p + 8 n + r and depth 16 c + 8 (s ^ (r >> 2 & 1)) + q of
  split_operator_np's hi (part 0) or, at 'bf16x3' only, lo (part 1), zero
  past the operator; a stage's two 16-deep chunks of a panel are one
  contiguous run of a multiple of 1 KB (the field chunk after it stays
  1024-byte aligned for TMA's 128-byte swizzle)."""
  a64 = _amat2d(order)
  k2 = a64.shape[0]
  passes = cuda_split.PASSES[precision]
  parts = 2 if passes == 3 else 1
  split = cuda_split.split_operator_np(a64)
  hi, lo = torch.as_tensor(split).to(torch.bfloat16)
  k_pad = -(-k2 // 32) * 32
  assert cuda_split.uniform_split_panel(k2) == -(-k2 // 16) * 16 <= 128
  for panel in (None, 16):
    layout = cuda_split.uniform_split_layout(hi, lo, k2, passes, panel)
    panel = panel or cuda_split.uniform_split_panel(k2)
    panels = -(-k2 // panel)
    assert tuple(layout.shape) == (panels, k_pad // 16, parts, panel // 8, 8,
                                   2, 8)
    assert tuple(layout.shape) == cuda_split.uniform_split_layout_shape(
        k2, passes, panel)
    assert layout.dtype == torch.bfloat16 and layout.is_contiguous()
    assert layout[0, :2].numel() * 2 % 1024 == 0
    want = np.zeros((2, panels * panel, k_pad), dtype=np.int16)
    want[:, :split.shape[1], :split.shape[2]] = _bf16_bits(split)
    got = layout.view(torch.int16).numpy()
    part, n, r, unit, q = np.indices(layout.shape[2:])
    for p, c in itertools.product(range(panels), range(layout.shape[1])):
      np.testing.assert_array_equal(
          got[p, c], want[part, panel * p + 8 * n + r,
                           16 * c + 8 * (unit ^ ((r >> 2) & 1)) + q])
    np.testing.assert_array_equal(
        layout.float().numpy(),
        cuda_split.dense_bf16_layout_np(a64, panel, parts))


def test_uniform_split_panel_spreads_few_units():
  """The 2D panel: one panel (k^2 rounded up to 16) where the (component,
  unit) pairs fill the card, the smallest multiple of 16 that leaves each
  block an SM of its own where they are few."""
  assert cuda_split.uniform_split_panel(81, 4096, 2, 132) == 96
  assert cuda_split.uniform_split_panel(81, 4096, 1, 132) == 48
  assert cuda_split.uniform_split_panel(64, 256, 2, 132) == 16
  assert cuda_split.uniform_split_panel(121, 37, 4, 132) == 16
  for rows, num_e, num_c in itertools.product((4, 25, 64, 81, 100, 121),
                                              (1, 37, 256, 1000, 4096),
                                              (1, 2, 4)):
    panel = cuda_split.uniform_split_panel(rows, num_e, num_c, 132)
    assert panel % 16 == 0 and 16 <= panel <= -(-rows // 16) * 16
    blocks = num_c * -(-num_e // 64) * -(-rows // panel)
    assert blocks <= 132 or panel == -(-rows // 16) * 16


@pytest.mark.parametrize('num_sms', [132, 7])
def test_uniform_split_walk_covers_every_unit_once(num_sms):
  """The 2D kernel (one warpgroup, tiles of one 64-element unit by one
  panel, up to two blocks an SM): each (component, panel, unit) in exactly
  one tile of one block at E = 256 (the lid-driven box), 4096 (datagen)
  and ragged E; at the datagen shape (C = 2) 128 tiles, one a block, in
  one wave, on the lid-driven box 32 (four panels of 16 rows)."""
  for num_e, k, num_c in itertools.product((1, 37, 256, 1000, 4096),
                                           (2, 8, 9, 11), (1, 2, 4)):
    k2 = k * k
    panel = cuda_split.uniform_split_panel(k2, num_e, num_c, num_sms)
    units, panels = -(-num_e // 64), -(-k2 // panel)
    grid = min(num_c * panels * units, 2 * num_sms)
    seen = np.zeros((num_c, panels, units), dtype=np.int64)
    for tiles in _dense_walk(num_e, num_c, k2, grid, panel, max_width=1):
      for c, p, col, width in tiles:
        assert width == 1
        seen[c, p, col] += 1
    assert (seen == 1).all(), (num_e, k, num_c)
  if num_sms == 132:
    walks = _dense_walk(4096, 2, 81, 128, 96, max_width=1)
    assert [len(tiles) for tiles in walks] == [1] * 128
    walks = _dense_walk(256, 2, 64, 32, 16, max_width=1)
    assert [len(tiles) for tiles in walks] == [1] * 32


def test_sem2d_ops_keep_the_split_layout():
  """Sem2DOps makes the 2D layout once per class; on the CPU the wrapper
  runs the plain version of the class, with or without the layout."""
  sem = StokesSEM.create(unit_cube_mesh(2, ndim=2, periodic_dims=(0, 1)),
                         {}, order=4, device='cpu', dtype=torch.float32)
  us = (torch.randn(5, 5, 8, generator=torch.Generator().manual_seed(0)),)
  for precision, passes in cuda_split.PASSES.items():
    ops = dataclasses.replace(sem.fast_ops, kernel_precision=precision)
    layout = ops.dense_bf16()
    assert layout is ops.dense_bf16() and layout.dtype == torch.bfloat16
    hi, lo = ops.split_operator()
    torch.testing.assert_close(
        layout, cuda_split.uniform_split_layout(hi, lo, 25, passes),
        rtol=0, atol=0)
    want = cuda_split.stiffness_uniform_split_plain(us, hi, lo, passes)
    for got in (cuda_split.stiffness_uniform_split(us, hi, lo, passes, layout),
                cuda_split.stiffness_uniform_split(us, hi, lo, passes),
                ops.stiffness_el_multi(us)):
      torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)


def test_dense_split_wrapper_keeps_its_layout():
  """Sem3DOps makes the bf16 layout once; on the CPU the wrapper runs the
  plain version of the split class, with or without the layout."""
  sem = StokesSEM.create(unit_cube_mesh(2, ndim=3, periodic_dims=(0, 1, 2)),
                         {}, order=3, device='cpu', dtype=torch.float32)
  ops = sem.fast_ops
  layout = ops.dense_bf16()
  assert layout is ops.dense_bf16() and layout.dtype == torch.bfloat16
  a64 = cuda_stiffness3d.uniform_amat3d_np(ops.c_uniform, ops.w1, ops.dmat)
  np.testing.assert_array_equal(
      layout.float().numpy(), cuda_split.dense_bf16_layout_np(a64))
  us = (torch.randn(4, 4, 4, 8, generator=torch.Generator().manual_seed(0)),)
  hi, lo = ops.dense_split()
  want = cuda_split.stiffness_uniform_split_plain(us, hi, lo, 3)
  for got in (cuda_split.stiffness3d_dense_split(us, hi, lo, layout),
              cuda_split.stiffness3d_dense_split(us, hi, lo)):
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)


def test_launch_checks_name_the_plain_path_knob():
  """Every 3D kernel refuses k = 11 (order 10), and its message names
  use_kernels=False, which runs the plain versions at any order."""
  us = (torch.zeros(11, 11, 11, 2),)
  for check in (cuda_stiffness3d._check_launchable,  # pylint: disable=protected-access
                cuda_stiffness3d._check_split_launchable):  # pylint: disable=protected-access
    with pytest.raises(ValueError, match='use_kernels=False') as err:
      check('stiffness3d_uniform', us, 1, 11, torch.float32)
    assert 'Queue 3 item 6' in str(err.value)


def _affine_coverage(plan, num_e, k2, num_c):
  """The affine split kernel's index arithmetic under `plan`
  (csrc/stiffness2d_affine_split.cu), written out: how often the blocks
  write each output value, (C, k^2, E)."""
  tiles = -(-num_e // plan.tile)
  out = np.zeros((num_c, k2, num_e), dtype=np.int64)
  for panel in range(plan.panels):
    r0 = panel * plan.rows
    for block in range(plan.blocks):
      for n in range(block, num_c * tiles, plan.blocks):
        comp, tile = divmod(n, tiles)
        for warp in range(plan.rows // 16):
          rows = slice(r0 + 16 * warp, min(k2, r0 + 16 * warp + 16))
          out[comp, rows, tile * plan.tile:(tile + 1) * plan.tile] += 1
  return out


@pytest.mark.parametrize('num_sms', [132, 7])
def test_affine_work_plan_covers_every_output_once(num_sms):
  for num_e, k2, num_c in itertools.product((1, 37, 256, 257, 4096),
                                            (4, 64, 81, 100), (1, 2, 3, 4)):
    plan = cuda_split.affine_work_plan(num_e, k2, num_c, num_sms)
    assert (_affine_coverage(plan, num_e, k2, num_c) == 1).all(), (
        num_e, k2, num_c, plan)
    m_pad = -(-k2 // 16) * 16
    assert plan.rows % 16 == 0 and 16 <= plan.rows <= 128
    assert plan.panels * plan.rows >= m_pad and plan.tile in (16, 32)
    # Every depth step in one slice, a warp's steps in its registers.
    assert 1 <= plan.splits <= m_pad // 16
    assert -(-(m_pad // 16) // plan.splits) <= cuda_split.AFFINE_MAX_STEPS
    assert (plan.rows // 16) * plan.splits <= 8  # warps of a block
    assert cuda_split.affine_smem_bytes(plan.rows, m_pad, plan.tile,
                                        plan.splits) <= 232448


def test_affine_work_plan_fills_the_card_at_the_path_shapes():
  """The lid-driven cavity (16^2, order 7, C = 2): 128 blocks of 16 rows x
  16 columns, four warps splitting the depth; the datagen box (64^2, order
  8): two blocks of six warps per SM on two 48-row panels, each walking
  about two 32-column tiles."""
  lid = cuda_split.affine_work_plan(256, 64, 2, 132)
  assert lid == cuda_split.AffinePlan(4, 16, 16, 4, 32), lid
  datagen = cuda_split.affine_work_plan(4096, 81, 2, 132)
  assert datagen == cuda_split.AffinePlan(2, 48, 32, 2, 132), datagen


@pytest.mark.parametrize('k2', [4, 64, 81])
def test_affine_fragments_are_the_mma_a_fragments(k2):
  """Register q of lane (g, t) at [mt, ks, o, part] packs the two bf16 of
  rows 16 mt + g (+8 for q = 1, 3), columns 16 ks + 2t, 2t + 1 (+8 for
  q = 2, 3) of block o of hi or lo, the lower column in the low half."""
  rng = np.random.default_rng(k2)
  m64 = rng.standard_normal((3 * k2, k2))
  split = torch.as_tensor(cuda_split.split_operator_np(m64, num_blocks=3))
  hi, lo = split.to(torch.bfloat16)
  frags = cuda_split.affine_fragments(hi, lo)
  r_pad, d_pad = hi.shape[0] // 3, hi.shape[1]
  assert tuple(frags.shape) == (r_pad // 16, d_pad // 16, 3, 2, 32, 4)
  assert frags.dtype == torch.int32 and frags.is_contiguous()
  bits = torch.stack([hi, lo]).view(torch.int16).numpy().astype(np.uint16)
  words = frags.numpy().view(np.uint32)
  for mt, ks, o, part, lane, q in itertools.product(
      range(r_pad // 16), range(d_pad // 16), range(3), range(2),
      range(0, 32, 5), range(4)):
    g, t = divmod(lane, 4)
    row = o * r_pad + 16 * mt + g + 8 * (q & 1)
    col = 16 * ks + 2 * t + 8 * (q >> 1)
    want = int(bits[part, row, col]) | (int(bits[part, row, col + 1]) << 16)
    assert int(words[mt, ks, o, part, lane, q]) == want


# The general bf16x3 pair kernels (csrc/stiffness3d_pair_columns.cuh): the
# block layout the host mirrors, the persistent blocks' walk, the zero tiles
# they skip, and the orders they take.


@pytest.mark.parametrize('k', range(2, cuda_stiffness3d.MAX_K + 1))
def test_pair_columns_layout_fits_one_block_an_sm(k):
  """Every order up to 9 (k = 10): the block fits the card's shared memory
  at 6 to 8 warps, one warp per (16-row tile, 8-element group), its
  operand rows an odd number of 16-byte units (no bank conflicts)."""
  lay = cuda_stiffness3d.pair_columns_layout(k)
  m_pad = -(-k * k // 16) * 16
  assert lay['m_pad'] == m_pad
  assert lay['tile_e'] == 8 * lay['groups']
  assert lay['threads'] == 32 * (m_pad // 16) * lay['groups']
  assert 192 <= lay['threads'] <= 256
  assert lay['smem_bytes'] <= cuda_stiffness3d.SMEM_LIMIT
  assert lay['ld_b'] >= k * lay['tile_e'] and (lay['ld_b'] // 8) % 2 == 1
  if k == 8:  # the path's order 7: 16 elements, 8 warps, 138 KB
    assert (lay['tile_e'], lay['threads'], lay['smem_bytes']) == (
        16, 256, 141568)


@pytest.mark.parametrize('k', range(2, cuda_stiffness3d.MAX_K + 1))
def test_pair_columns_affine_layout_fits_one_block_an_sm(k):
  """The affine kernel has the general kernels' block but for its table
  (D, Dw, w, w2: 3 k^2 + k floats for k^2), and fits at every k up to 10,
  where its transposed operator's split could not fit beside the rest."""
  lay = cuda_stiffness3d.pair_columns_layout(k, affine=True)
  general = cuda_stiffness3d.pair_columns_layout(k)
  table = lambda n: 4 * -(-n // 4) * 4
  assert {key: v for key, v in lay.items() if key != 'smem_bytes'} == {
      key: v for key, v in general.items() if key != 'smem_bytes'}
  assert lay['smem_bytes'] - general['smem_bytes'] == (
      table(3 * k * k + k) - table(k * k))
  assert lay['smem_bytes'] <= cuda_stiffness3d.SMEM_LIMIT
  m_pad = lay['m_pad']
  t_split = 2 * m_pad * (2 * m_pad + 8) * 2  # T's (hi, lo), padded rows
  if k >= 9:
    assert lay['smem_bytes'] + t_split > cuda_stiffness3d.SMEM_LIMIT


@pytest.mark.parametrize('k', range(2, cuda_stiffness3d.MAX_K + 1))
def test_congruent_pair_columns_layout_fits_one_block_an_sm(k):
  """The congruent pair kernel on the columns layout (csrc/
  stiffness3d_pair_columns.cuh:CongruentLayout, written out): the general
  kernels' tile, threads and operand rows; its table (3 k^2 + k floats),
  A2's split (2 parts of m_pad rows of m_pad + 8 bf16, an odd number of
  16-byte units) and a ring of two split field operands (2 x 2 parts of
  m_pad rows of ld_b bf16) within one block at every k up to 10; and its
  persistent blocks, which walk the general kernels' tiles, cover every
  (element, component) once."""
  lay = cuda_stiffness3d.pair_congruent_layout(k)
  general = cuda_stiffness3d.pair_columns_layout(k)
  assert {key: v for key, v in lay.items() if key != 'smem_bytes'} == {
      key: v for key, v in general.items() if key != 'smem_bytes'}
  m_pad, ld_b = lay['m_pad'], lay['ld_b']
  assert ((m_pad + 8) * 2 // 16) % 2 == 1
  table = 4 * (-(-(3 * k * k + k) // 4) * 4)
  assert lay['smem_bytes'] == (table + 2 * m_pad * (m_pad + 8) * 2
                               + 2 * 2 * m_pad * ld_b * 2)
  assert lay['smem_bytes'] <= cuda_stiffness3d.SMEM_LIMIT
  expect = {8: (16, 256, 88864), 10: (8, 224, 133856)}
  if k in expect:
    assert (lay['tile_e'], lay['threads'], lay['smem_bytes']) == expect[k]
  for num_e, num_c, (num_sms, per_sm) in itertools.product(
      (1, 7, 8, 27, 257, 4096), (1, 3, 4), ((132, 1), (7, 2))):
    grid = cuda_stiffness3d.pair_columns_grid(num_e, k, num_sms, per_sm)
    tile_e = lay['tile_e']
    seen = np.zeros((num_c, -(-num_e // tile_e) * tile_e), dtype=np.int64)
    for units in _pair_columns_walk(num_e, num_c, k, grid):
      for tile, comp in units:
        seen[comp, tile * tile_e:(tile + 1) * tile_e] += 1
    assert (seen == 1).all(), (num_e, num_c, grid)


def _pair_columns_walk(num_e, num_c, k, grid):
  """The (tile, component) units each persistent block walks, in its order
  (csrc/stiffness3d_pair_columns.cuh: tiles b, b + grid, ..., each through
  its components), written out."""
  tiles = -(-num_e // cuda_stiffness3d.pair_columns_layout(k)['tile_e'])
  return [[(tile, comp) for tile in range(b, tiles, grid)
           for comp in range(num_c)] for b in range(grid)]


@pytest.mark.parametrize('num_sms,blocks_per_sm', [(132, 1), (7, 2)])
def test_pair_columns_blocks_cover_every_element_once(num_sms, blocks_per_sm):
  """Each (element, component) in exactly one block's walk, ragged E
  included; at the path's shape (16^3 elements, order 7) one block per SM
  and none idle."""
  for num_e, k, num_c in itertools.product((1, 7, 8, 27, 257, 4096),
                                           (2, 5, 8, 9, 10), (1, 3, 4)):
    grid = cuda_stiffness3d.pair_columns_grid(num_e, k, num_sms,
                                              blocks_per_sm)
    tile_e = cuda_stiffness3d.pair_columns_layout(k)['tile_e']
    seen = np.zeros((num_c, -(-num_e // tile_e) * tile_e), dtype=np.int64)
    for units in _pair_columns_walk(num_e, num_c, k, grid):
      for tile, comp in units:
        seen[comp, tile * tile_e:(tile + 1) * tile_e] += 1
    assert (seen == 1).all(), (num_e, k, num_c, grid)
    assert 1 <= grid <= num_sms * blocks_per_sm
  assert cuda_stiffness3d.pair_columns_grid(4096, 8, 132, 1) == 132


def _eye_tile_live(k, ri, ci):
  """The kernel's test of a 16 x 16 tile of I (x) D, written out."""
  m = k * k
  r0, r1 = 16 * ri // k, (min(16 * ri + 16, m) - 1) // k
  c0, c1 = 16 * ci // k, (min(16 * ci + 16, m) - 1) // k
  return max(r0, c0) <= min(r1, c1)


@pytest.mark.parametrize('k', range(2, cuda_stiffness3d.MAX_K + 1))
def test_pair_columns_skip_only_zero_tiles(k):
  """The kernels skip the tiles of I (x) D (and of its transpose) that the
  test calls dead: each is zero in DP's split; D (x) I has no zero tile."""
  rng = np.random.default_rng(k)
  d = rng.uniform(0.5, 1.5, (k, k))  # no zero entry
  dp = cuda_split.pair_derivative_split_np(d)  # (2, 2 m_pad, m_pad)
  m_pad = dp.shape[2]
  assert dp.shape[1] == 2 * m_pad and m_pad % 16 == 0
  tiles = m_pad // 16
  dead = 0
  for ri, ci in itertools.product(range(tiles), repeat=2):
    rows, cols = slice(16 * ri, 16 * ri + 16), slice(16 * ci, 16 * ci + 16)
    assert dp[0, rows, cols].any()  # D (x) I
    eye = dp[:, m_pad:][:, rows, cols]
    if _eye_tile_live(k, ri, ci):
      assert eye[0].any()
    else:
      dead += 1
      assert not eye.any()
    assert _eye_tile_live(k, ri, ci) == _eye_tile_live(k, ci, ri)
  if k == 8:  # off the block diagonal of 4 x 4 tiles
    assert dead == 12


def test_general_pair_kernels_take_k_up_to_10():
  """The launch check: every pair kernel (general, pairz, congruent and
  affine) takes 2 <= k <= 10 and refuses k = 11; all float32 only."""
  check = cuda_stiffness3d._check_split_launchable  # pylint: disable=protected-access
  names = ('stiffness3d_pair_general', 'stiffness3d_pairz_general',
           'stiffness3d_pair', 'stiffness3d_pair_affine')
  for k in range(2, 11):
    us = (torch.zeros(k, k, k, 3),)
    for name in names:
      check(name, us, 1, k, torch.float32)
      with pytest.raises(TypeError, match='float32'):
        check(name, us, 1, k, torch.float64)
  for name in names:
    with pytest.raises(ValueError, match='k <= 10'):
      check(name, us, 1, 11, torch.float32)


@pytest.mark.parametrize('order,impl,refused', [
    (5, 'pairs4', True), (5, 'pairs2', False), (8, 'pairs2', True),
    (3, 'pairs4', False)])
def test_superslab_keys_refuse_what_the_reference_refuses(order, impl,
                                                          refused):
  """pairs2 / pairs4 stack 2 / 4 slabs: where that does not divide k, the
  JAX package's kernel asserts and the port raises, on every device."""
  sem = StokesSEM.create(unit_cube_mesh(1, ndim=3, periodic_dims=(0, 1, 2)),
                         {}, order=order, device='cpu', dtype=torch.float64)
  ops = dataclasses.replace(sem.fast_ops, use_uniform_kernel=False,
                            general_kernel_impl=impl)
  k = order + 1
  us = (torch.ones(k, k, k, 1, dtype=torch.float64),)
  if refused:
    with pytest.raises(ValueError, match='multiple of'):
      ops.stiffness_el_multi(us)
  else:
    pair = dataclasses.replace(ops, general_kernel_impl='pair')
    torch.testing.assert_close(ops.stiffness_el_multi(us)[0],
                               pair.stiffness_el_multi(us)[0], rtol=0, atol=0)


# The general FP32 3D kernel (csrc/stiffness3d_general.cu): its block, the
# rows of its lines, and its persistent blocks' walk.


@pytest.mark.parametrize('itemsize', [4, 8], ids=['f32', 'f64'])
@pytest.mark.parametrize('k', range(2, cuda_stiffness3d.MAX_K + 1))
def test_general3d_layout_fits_one_block_an_sm(k, itemsize):
  """8-element tiles, at most 8 warps, every line of each axis in one slot
  of one round, and the tiles and tables within the shared memory of one
  block; in float32 the six factor tiles stay beside U, R and S up to
  k = 9 (order 8)."""
  lay = cuda_stiffness3d.general3d_layout(k, itemsize)
  assert lay['tile_e'] == 8 and lay['slots'] == 4
  assert 1 <= lay['warps'] <= 8 and lay['threads'] == 32 * lay['warps']
  slots = lay['warps'] * lay['slots']
  assert slots % 4 == 0 and slots * lay['rounds'] >= k * k
  assert slots * (lay['rounds'] - 1) < k * k  # no idle round
  assert lay['rows'] == k ** 3 + (k * k if k % 2 == 0 else 0)
  assert lay['smem_bytes'] <= cuda_stiffness3d.SMEM_LIMIT
  if itemsize == 4:
    assert lay['factor_tiles'] == (k <= 9)
  if k == 8 and itemsize == 4:  # the path's order 7: 8 warps, 162.5 KB
    assert (lay['threads'], lay['smem_bytes']) == (256, 166400)


def _general3d_rows(k):
  """The shared-memory rows of the general 3D kernel's lines, ``(k^2, k)``
  each (csrc/stiffness3d_general.cu: row(), and the line bases of stages
  A-D, written out): xi line ``(q, r)`` at index ``q k + r`` holds the
  points ``(a, q, r)``, eta line ``(m, r)`` the points ``(m, b, r)``, zeta
  line ``(m, q)`` the points ``(m, q, c)``; point P lies at row
  ``P + P // k`` where k is even, else at row P."""
  pad = 1 if k % 2 == 0 else 0
  lines = np.arange(k * k)[:, None]
  a = np.arange(k)[None, :]
  row = lambda p: p + pad * (p // k)
  return {'xi': row(a * k * k + lines),
          'eta': row((lines // k) * k * k + a * k + lines % k),
          'zeta': row(lines * k + a)}


@pytest.mark.parametrize('k', range(2, cuda_stiffness3d.MAX_K + 1))
def test_general3d_lines_cover_every_point_without_bank_conflicts(k):
  """Along each axis the k^2 lines hold every point once, at distinct rows.
  A warp reads four neighbouring lines 4i..4i+3 at a time: in float32
  (32-byte rows, a quarter of the banks each) their rows are distinct
  mod 4 at every step along the zeta lines, and along every axis at
  k = 4, 5, 8 and 9; in float64 (64-byte rows, two lines a half warp) the
  lines 2i, 2i + 1 are an odd number of rows apart, every axis, every k."""
  rows = _general3d_rows(k)
  pad = 1 if k % 2 == 0 else 0
  all_rows = np.arange(k ** 3) + pad * (np.arange(k ** 3) // k)
  for axis, line_rows in rows.items():
    assert line_rows.shape == (k * k, k)
    assert sorted(line_rows.ravel()) == sorted(all_rows)
    pairs = line_rows[0:k * k - 1:2], line_rows[1:k * k:2]
    assert ((pairs[1] - pairs[0]) % 2 == 1).all(), axis
    if axis == 'zeta' or k in (4, 5, 8, 9):
      for g0 in range(0, k * k, 4):
        quarters = line_rows[g0:g0 + 4] % 4
        for step in range(k):
          assert len(set(quarters[:, step])) == len(quarters), (axis, g0)
  # The lines are the axes' lines: xi lines vary the first index, etc.
  point = lambda row: row - pad * (row // (k + pad))
  for axis, stride in (('xi', k * k), ('eta', k), ('zeta', 1)):
    steps = np.diff(point(rows[axis]), axis=1)
    assert (steps == stride).all(), axis


def _general3d_walk(num_e, num_c, k, grid):
  """The (tile, component) units each persistent block of the general 3D
  kernel walks (tiles b, b + grid, ..., each through its components)."""
  tiles = -(-num_e // cuda_stiffness3d.general3d_layout(k)['tile_e'])
  return [[(tile, comp) for tile in range(b, tiles, grid)
           for comp in range(num_c)] for b in range(grid)]


@pytest.mark.parametrize('num_sms,blocks_per_sm', [(132, 1), (7, 2)])
def test_general3d_blocks_cover_every_element_once(num_sms, blocks_per_sm):
  """Each (element, component) in exactly one block's walk, ragged E
  included; at the path's shape (16^3 elements, order 7) one block per SM
  and none idle."""
  for num_e, k, num_c in itertools.product((1, 7, 16, 27, 257, 4096),
                                           (2, 5, 8, 9, 10), (1, 3, 4)):
    grid = cuda_stiffness3d.general3d_grid(num_e, k, num_sms, blocks_per_sm)
    tile_e = cuda_stiffness3d.general3d_layout(k)['tile_e']
    seen = np.zeros((num_c, -(-num_e // tile_e) * tile_e), dtype=np.int64)
    for units in _general3d_walk(num_e, num_c, k, grid):
      for tile, comp in units:
        seen[comp, tile * tile_e:(tile + 1) * tile_e] += 1
    assert (seen == 1).all(), (num_e, k, num_c, grid)
    assert 1 <= grid <= num_sms * blocks_per_sm
  assert cuda_stiffness3d.general3d_grid(4096, 8, 132, 1) == 132


@pytest.mark.parametrize('itemsize', [4, 8], ids=['f32', 'f64'])
@pytest.mark.parametrize('k', range(2, cuda_stiffness3d.MAX_K + 1))
def test_uniform3d_plan_fits_one_block_an_sm(k, itemsize):
  """The congruent 3D kernel's plan (csrc/stiffness3d_uniform.cu: Plan):
  128-byte rows (32 float32 or 16 float64 elements a tile) where two
  stages fit beside the output tile (k <= 8), half that beyond; two to four
  stages; the tile's field as at most four TMA boxes of at most 256 rows,
  each a multiple of 128 bytes, covering the k^3 points; the warps' planes
  cover the k planes and their rounds the k^2 zeta lines; all of it in one
  block's shared memory."""
  plan = cuda_stiffness3d.uniform3d_plan(k, itemsize)
  te = plan['tile_e']
  assert te == (128 if k <= 8 else 64) // itemsize
  assert 2 <= plan['stages'] <= 4
  assert plan['boxes'] <= 4 and plan['box_rows'] <= 256
  assert plan['boxes'] * plan['box_rows'] >= k ** 3
  assert plan['box_rows'] * te * itemsize % 128 == 0
  assert plan['stage_bytes'] == plan['boxes'] * plan['box_rows'] * te * itemsize
  slots = 32 // te
  assert (plan['warps'] - 1) * slots < k <= plan['warps'] * slots
  assert plan['rounds'] * plan['warps'] * slots >= k * k
  assert plan['threads'] == 32 * plan['warps'] + 32
  fixed = plan['smem_bytes'] - plan['stages'] * plan['stage_bytes']
  assert fixed >= 256 + k ** 3 * te * itemsize + (2 * k * k + 3 * k) * itemsize
  assert plan['smem_bytes'] <= cuda_stiffness3d.SMEM_LIMIT
  if plan['stages'] < 4:
    assert plan['smem_bytes'] + plan['stage_bytes'] > cuda_stiffness3d.SMEM_LIMIT


@pytest.mark.parametrize('num_sms,blocks_per_sm', [(132, 1), (7, 2)])
def test_uniform3d_walk_covers_every_unit_once(num_sms, blocks_per_sm):
  """Each (component, tile) unit of the congruent 3D kernel in exactly one
  block's contiguous range, ragged E included; at the TGV shape (16^3
  elements, order 7, C = 3) 384 units of 32 elements on 132 blocks, at
  most 3 a block."""
  for num_e, k, num_c, itemsize in itertools.product(
      (1, 37, 512, 4096), (2, 8, 9, 10), (1, 3, 4), (4, 8)):
    te = cuda_stiffness3d.uniform3d_plan(k, itemsize)['tile_e']
    tiles = -(-num_e // te)
    grid = cuda_stiffness3d.uniform3d_grid(num_e, k, num_c, num_sms,
                                          blocks_per_sm, itemsize)
    assert grid == min(num_c * tiles, num_sms * blocks_per_sm)
    seen = np.zeros((num_c, tiles), dtype=np.int64)
    for units in cuda_stiffness3d.uniform3d_walk(num_e, k, num_c, grid,
                                                 itemsize):
      for c, tile in units:
        seen[c, tile] += 1
    assert (seen == 1).all(), (num_e, k, num_c, itemsize)
  if num_sms == 132:
    walks = cuda_stiffness3d.uniform3d_walk(4096, 8, 3, 132)
    assert sum(map(len, walks)) == 384 and max(map(len, walks)) == 3


# The periodic exchange (csrc/exchange2d.cu): its launch geometry.


def _exchange_coverage(k, n0, n1, num_fields, geo):
  """How often the kernel writes each entry of the fields, ``(F, k, k, n0,
  n1)``, written out from csrc/exchange2d.cu: the plane (a, b) from
  blockIdx.y, z, the field from threadIdx.z, the row blockIdx.x ty +
  threadIdx.y (stored where below n0), the chunks threadIdx.x, + tx, ...
  below n1 / width, each `width` values."""
  chunks = n1 // geo.width
  seen = np.zeros((num_fields, k, k, n0, n1), dtype=np.int64)
  assert geo.grid[1:] == (k, k)
  for bx, y, x in itertools.product(range(geo.grid[0]), range(geo.ty),
                                    range(geo.tx)):
    row = bx * geo.ty + y
    if row >= n0:
      continue
    for c in range(x, chunks, geo.tx):
      seen[:, :, :, row, c * geo.width:(c + 1) * geo.width] += 1
  return seen


@pytest.mark.parametrize('k', range(2, 11))
def test_exchange2d_geometry_covers_every_entry_once(k):
  """Every entry of every field written once, n0 != n1, n1 a multiple of 4
  and not, both dtypes, 1-4 fields, aligned or not; 16-byte chunks exactly
  where n1 and the pointers allow them; whole warps and a power-of-two row
  within one where the neighbours travel by shuffle."""
  for (n0, n1), itemsize, num_fields, aligned, threads in itertools.product(
      ((3, 8), (5, 7), (20, 64), (1, 1), (64, 12), (2, 600)), (4, 8),
      (1, 2, 3, 4), (True, False), (128, 256, 512)):
    geo = cuda_exchange.launch_geometry(k, n0, n1, itemsize, num_fields,
                                        aligned, threads)
    seen = _exchange_coverage(k, n0, n1, num_fields, geo)
    assert (seen == 1).all(), (k, n0, n1, itemsize, num_fields, geo)
    width = 16 // itemsize
    assert geo.vec == (aligned and n1 % width == 0)
    assert geo.width == (width if geo.vec else 1)
    assert geo.tx * geo.ty * num_fields <= threads and geo.ty <= n0
    if geo.shuffle:
      assert geo.tx == n1 // geo.width and geo.tx <= 32
      assert 32 % geo.tx == 0 and geo.tx * geo.ty * num_fields % 32 == 0


def test_exchange2d_geometry_at_the_datagen_shape():
  """(9, 9, 64, 64) float32: 16-byte chunks, a row of 16 lanes, shuffles;
  one field 4 x 81 blocks of 256 threads, two fields in one launch the
  same threads a block over twice the bands."""
  one = cuda_exchange.launch_geometry(9, 64, 64, 4, 1)
  two = cuda_exchange.launch_geometry(9, 64, 64, 4, 2)
  assert one == cuda_exchange.Geometry(True, 4, 16, 16, True, (4, 9, 9))
  assert two == cuda_exchange.Geometry(True, 4, 16, 8, True, (8, 9, 9))


def test_exchange2d_takes_up_to_four_fields():
  """One field in, one out; a tuple in, a tuple out; more than four fields,
  or fields of different shapes, are refused."""
  rng = np.random.default_rng(0)
  ws = tuple(torch.as_tensor(rng.standard_normal((3, 3, 4, 5)))
             for _ in range(5))
  assert isinstance(cuda_exchange.exchange2d(ws[0]), torch.Tensor)
  outs = cuda_exchange.exchange2d(ws[:4])
  assert isinstance(outs, tuple) and len(outs) == 4
  for w, o in zip(ws, outs):
    assert torch.equal(o, cuda_exchange.exchange2d_plain(w))
  with pytest.raises(ValueError, match='1..4 fields'):
    cuda_exchange.exchange2d(ws)
  with pytest.raises(ValueError, match='share shape'):
    cuda_exchange.exchange2d((ws[0], ws[1][..., :4]))


# The general 2D stiffness (csrc/stiffness2d_general.cu): its block and its
# persistent blocks' walk.


@pytest.mark.parametrize('k', range(2, cuda_stiffness2d.MAX_K + 1))
def test_general2d_layout_fits_one_block(k):
  """A thread a line of an element, whole warps; nine tiles (and, in
  float64, the tables of D and D^T) within one block's shared memory at
  every k, the tiles of 8 and 32 elements in float32 and of 8 in float64;
  at 8 a warp's four lines start on distinct bank groups, rows and columns
  alike."""
  for itemsize, te in ((4, 32), (4, 8), (8, 8)):
    lay = cuda_stiffness2d.general2d_layout(k, itemsize, te)
    assert lay['tile_e'] == te
    assert lay['threads'] % 32 == 0
    assert lay['threads'] - 32 < k * te <= lay['threads'] <= 1024
    assert lay['smem_bytes'] <= 232448
    table = 0 if itemsize == 4 else 2 * k * (-(-k // 2) * 2)  # f64: D, D^T
    assert lay['smem_bytes'] == (table + 9 * k * lay['line']) * itemsize
    assert lay['line'] >= k * te
    if itemsize == 4 and te < 32:
      lines = np.arange(32 // te)  # a warp's lines
      for q in range(k):
        rows = (lines * lay['line'] + q * te) % 32 // te  # row a = line
        cols = (q * lay['line'] + lines * te) % 32 // te  # column b = line
        assert len(set(rows)) == len(set(cols)) == 32 // te, (k, te, q)
  # The path shapes: the heated cavity's order 7 narrow, 64^2 order 8 wide.
  assert cuda_stiffness2d.general2d_layout(8, 4, 8)['threads'] == 64
  assert cuda_stiffness2d.general2d_layout(9, 4, 32)['threads'] == 288


@pytest.mark.parametrize('num_sms,blocks_per_sm', [(132, 2), (7, 1)])
def test_general2d_walk_covers_every_unit_once(num_sms, blocks_per_sm):
  """Each (component, element) in exactly one block's contiguous range at
  E = 144 (the heated cavity), 4096 (the datagen shape) and ragged E, for
  C = 1-4, tile-major (a block's units of one tile follow one another),
  whole tiles a block where the units outnumber the blocks; wide tiles only
  where their units reach half the SMs."""
  for num_e, num_c, itemsize in itertools.product((1, 37, 144, 1001, 4096),
                                                  (1, 2, 3, 4), (4, 8)):
    te = cuda_stiffness2d.general2d_tile(num_e, num_c, itemsize, num_sms)
    tiles = -(-num_e // te)
    units = num_c * tiles
    if te == cuda_stiffness2d.WIDE_TILE:
      assert itemsize == 4 and 2 * units >= num_sms
    else:
      assert itemsize == 8 or 2 * num_c * -(-num_e // 32) < num_sms
    grid, span = cuda_stiffness2d.general2d_grid(num_e, num_c, te, num_sms,
                                                 blocks_per_sm)
    if units <= num_sms * blocks_per_sm:
      assert (grid, span) == (units, 1)
    else:
      assert (grid, span) == (min(tiles, num_sms * blocks_per_sm), num_c)
    seen = np.zeros((num_c, tiles * te), dtype=np.int64)
    walks = cuda_stiffness2d.general2d_walk(num_e, num_c, te, grid, span)
    assert len(walks) == grid and all(walks)
    for walk in walks:
      assert walk == sorted(walk) and len(walk) % span == 0
      assert walk[0][1] == 0 or span == 1  # whole tiles
      for tile, comp in walk:
        seen[comp, tile * te:(tile + 1) * te] += 1
    assert (seen == 1).all(), (num_e, num_c, itemsize)
  if num_sms == 132:
    # The heated cavity (E = 144, C = 2): 36 narrow units, one a block; the
    # datagen shape: 128 wide tiles, one a block with its two components at
    # C = 2, one component at C = 1.
    assert cuda_stiffness2d.general2d_tile(144, 2, 4, 132) == 8
    assert cuda_stiffness2d.general2d_grid(144, 2, 8, 132, 6) == (36, 1)
    assert cuda_stiffness2d.general2d_tile(4096, 2, 4, 132) == 32
    assert cuda_stiffness2d.general2d_grid(4096, 2, 32, 132, 1) == (128, 2)
    assert cuda_stiffness2d.general2d_tile(4096, 1, 4, 132) == 32
    assert cuda_stiffness2d.general2d_grid(4096, 1, 32, 132, 1) == (128, 1)

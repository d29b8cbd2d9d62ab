"""Distributed two-level Schwarz pressure preconditioner (partitioned meshes).

Counterpart of ``swirlfem_tpu/ops/schwarz_distributed.py``: the exact
probed local blocks and the probed or assembled coarse solve of
`ops.schwarz`, applied on each rank of a partitioned solver with
communication sized by the partition interface.

The host does the set-up once: probing on the UNPARTITIONED twin solver in
float64, exactly as `ops.schwarz` does, then every partition's tables
(`DistributedSchwarzTables`, numpy, stacked over partitions as the JAX
package stacks its leaves).  Each rank is shipped its row
(`DistributedSchwarzTables.row`, a picklable `DistributedSchwarzRow`) and
builds its `DistributedSchwarz` on its device (`DistributedSchwarzRow.
on_rank`); no rank builds another rank's tables.

Communication a apply (`parallel.spmd.Axis`):

* one `all_gather` of the interface pressure dofs (the one-layer halo that
  the overlapping locals and the block-sparse E read from other ranks);
* with overlap 1, one `psum` of the interface-sized overlap contributions,
  summed back to their owners;
* the coarse space: ``'p1dg'`` one `all_gather` of each element's coarse
  residual; ``'vertex'`` one psum of the nv-sized vertex residual and this
  rank's rows of the dense inverse; ``'vertex-cheb'`` the same psum and a
  replicated `ops.coarse_cheb` solve on every rank.

`DistributedSchwarz.fast_matvec` is the assembled block-sparse ``E`` with
one halo `all_gather`.

The rank layout.  The JAX package pads each partition to the largest
with SENTINEL element rows (an identity block, dead indices, a zero
``valid_el``).  A rank of the port keeps its padded pressure node slots
(every rank's nodal vector has the padded length ``E_max * m^d``, its
elements' dofs first) but drops the padded element rows, so a rank's
tables are the JAX tables' rows of its real elements: every buffer index
(``[local r | all-gathered interface | zero]``) is the JAX package's, and
the padded slots of the result are zero there as here.  The p1dg coarse
residual is padded back to ``E_max`` elements before its all_gather (the
JAX column layout).

Every scatter-add of the apply (the local and the interface contributions,
the vertex restriction) sums its copies in a fixed order
(`core.topology.ScatterTable`), so the card's apply repeats bitwise.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from swirlfem_tpu_torch.core import topology
from swirlfem_tpu_torch.ops import schwarz as _schwarz

COARSE_KINDS = ('auto', 'p1dg', 'vertex', 'vertex-cheb')


@dataclasses.dataclass(frozen=True)
class DistributedSchwarzRow:
  """One rank's tables (numpy, picklable): the rows of its real elements.

  Index tables point into the rank's buffer ``[r (n_loc) | all-gathered
  interface (P * I) | zero (1)]``; SENTINEL marks a dead slot of a scatter.
  """

  rank: int
  num_partitions: int
  n_loc: int                  # padded pressure dofs a rank (E_max * mloc)
  mloc: int
  e_max: int
  binv: np.ndarray            # (E, next, next) inverted (extended) blocks
  ext_buf_idx: np.ndarray     # (E, next) gather index into the buffer
  w_ext: np.ndarray           # (E, next) count weights (0 at dead slots)
  ext_local_idx: np.ndarray   # (E, next) local dof or SENTINEL
  ext_contrib_idx: np.ndarray  # (E, next) interface slot or SENTINEL
  iface_idx: np.ndarray       # (I,) local dof of each interface slot
  iface_valid: np.ndarray     # (I,) 1.0 where the slot is real
  stencil: np.ndarray         # (mloc, nc) coarse prolongation
  inv_c_rows: np.ndarray | None  # p1dg / vertex inverse rows
  rb: np.ndarray              # (E, mloc, width * mloc) row blocks of E
  nbr_buf_idx: np.ndarray     # (E, width * mloc) gather into the buffer
  cvid_scatter: np.ndarray | None  # (E, nc) global vertex id
  cvid_gather: np.ndarray | None   # (E, nc) row of this rank's inverse
  cheb: dict | None           # the `ChebCoarse` fields, numpy
  overlap: int
  has_nullspace: bool
  coarse_kind: str
  coarse_nv: int
  iface_size: int

  @property
  def nbytes(self) -> int:
    """The host bytes of this rank's tables."""
    total = 0
    for f in dataclasses.fields(self):
      v = getattr(self, f.name)
      if isinstance(v, np.ndarray):
        total += v.nbytes
      elif isinstance(v, dict):
        total += sum(a.nbytes for a in v.values()
                     if isinstance(a, np.ndarray))
    return total

  def on_rank(self, ax, *, device, dtype: torch.dtype) -> 'DistributedSchwarz':
    """This rank's preconditioner on `device`, its floating tables in
    `dtype` (whatever dtype the host built them in); `ax` is the rank's
    `parallel.spmd.Axis`."""
    if (ax.size, ax.index) != (self.num_partitions, self.rank):
      raise ValueError(f'row {self.rank} of {self.num_partitions} '
                       f'partitions on rank {ax.index} of {ax.size}')
    tensors = {f.name: _tensor(getattr(self, f.name), device, dtype)
               for f in dataclasses.fields(self)
               if isinstance(getattr(self, f.name), np.ndarray)}
    valid = self.iface_valid > 0
    cvid = self.cvid_scatter is not None
    return DistributedSchwarz(
        ax=ax, t=dataclasses.replace(self, **tensors),
        ext_local_sum=topology.ScatterTable.build(
            self.ext_local_idx, self.n_loc, device=device),
        ext_contrib_sum=(topology.ScatterTable.build(
            self.ext_contrib_idx, self.num_partitions * self.iface_size,
            device=device) if self.overlap else None),
        iface_dofs=_tensor(self.iface_idx[valid], device, dtype),
        iface_slots=_tensor(np.nonzero(valid)[0], device, dtype),
        cvid_sum=(topology.ScatterTable.build(
            self.cvid_scatter, self.coarse_nv, device=device)
                  if cvid else None),
        cheb=(None if self.cheb is None
              else _cheb_on(self.cheb, device, dtype)))


def _tensor(a: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
  """A host table on `device`: floating ones in `dtype`, indices int64."""
  return torch.as_tensor(a, device=device,
                         dtype=dtype if a.dtype.kind == 'f' else torch.int64)


def _cheb_fields(cheb) -> dict:
  """A `ChebCoarse` as numpy fields (its aggregate sum as its table)."""
  out = {}
  for f in dataclasses.fields(cheb):
    v = getattr(cheb, f.name)
    if isinstance(v, torch.Tensor):
      out[f.name] = v.cpu().numpy()
    elif isinstance(v, topology.ScatterTable):
      out[f.name] = (v.index.cpu().numpy(), v.mask.cpu().numpy())
    else:
      out[f.name] = v
  return out


def _cheb_on(fields: dict, device, dtype: torch.dtype):
  """The `ChebCoarse` of `_cheb_fields` on `device` in `dtype`, its bounds
  and scale rounded through `dtype` as `build_cheb_vertex_coarse` rounds
  them."""
  from swirlfem_tpu_torch.ops.coarse_cheb import ChebCoarse
  kw = {}
  for name, v in fields.items():
    if isinstance(v, np.ndarray):
      kw[name] = _tensor(v, device, dtype)
    elif isinstance(v, tuple):
      kw[name] = topology.ScatterTable(index=torch.as_tensor(v[0],
                                                             device=device),
                                       mask=torch.as_tensor(v[1],
                                                            device=device))
    elif name in ('lam_min', 'lam_max', 'scale'):
      kw[name] = float(torch.tensor(v, dtype=dtype))
    else:
      kw[name] = v
  return ChebCoarse(**kw)


@dataclasses.dataclass(frozen=True)
class DistributedSchwarzTables:
  """Every partition's tables, built once on the host.

  `rows` holds one `DistributedSchwarzRow` a partition; `row(rank)` is
  what rank `rank` is shipped.  `element_rows` is the JAX package's
  ``(P, E_max)`` element layout (global ids, SENTINEL padded), whose real
  entries are the rows' elements in order.  Set-up figures:
  `setup_seconds`, `colors` (distance-2 colours), `probe_applies` (float64
  E applies), `coarse_dofs`, `cheb_degree`.
  """

  rows: tuple
  element_rows: np.ndarray
  setup_seconds: float
  colors: int
  probe_applies: int
  coarse: str
  coarse_dofs: int
  cheb_degree: int | None
  overlap: int
  has_nullspace: bool

  @property
  def num_partitions(self) -> int:
    return len(self.rows)

  def row(self, rank: int) -> DistributedSchwarzRow:
    return self.rows[rank]


@dataclasses.dataclass(frozen=True, eq=False)
class DistributedSchwarz:
  """A rank's Schwarz apply ``M(r)`` on its nodal pressure vector (the
  padded ``n_loc`` dofs), with `fast_matvec` (the assembled block-sparse
  E) and `has_nullspace`, the single-device preconditioner's protocol.

  `t` is the rank's `DistributedSchwarzRow` with its arrays as tensors on
  the rank's device; the rest is derived from it there."""

  ax: object
  t: DistributedSchwarzRow
  ext_local_sum: topology.ScatterTable
  ext_contrib_sum: topology.ScatterTable | None
  iface_dofs: torch.Tensor      # local dof of each real interface slot
  iface_slots: torch.Tensor     # its slot
  cvid_sum: topology.ScatterTable | None
  cheb: object

  @property
  def has_nullspace(self) -> bool:
    return self.t.has_nullspace

  def _pad(self, y_el: torch.Tensor) -> torch.Tensor:
    """``(E, mloc)`` element values as the padded nodal vector."""
    y = y_el.reshape(-1)
    pad = self.t.n_loc - y.shape[0]
    return torch.cat([y, y.new_zeros(pad)]) if pad else y

  def _halo_buffer(self, r: torch.Tensor) -> torch.Tensor:
    iface = r[self.t.iface_idx] * self.t.iface_valid
    allif = self.ax.all_gather(iface)                      # (P, I)
    return torch.cat([r, allif.reshape(-1), r.new_zeros(1)])

  def _coarse_apply(self, r_el: torch.Tensor) -> torch.Tensor:
    t = self.t
    rc_el = r_el @ t.stencil                               # (E, nc)
    if t.coarse_kind in ('vertex', 'vertex-cheb'):
      # Assembled Q1 restriction into the nv-sized vertex vector, one
      # psum, then the replicated Chebyshev solve or this rank's rows.
      rc = self.ax.psum(self.cvid_sum.sum(rc_el.reshape(-1)))
      if t.coarse_kind == 'vertex-cheb':
        yc_el = self.cheb.solve(rc).to(rc.dtype)[t.cvid_scatter]
      else:
        yc_el = (t.inv_c_rows @ rc)[t.cvid_gather]
    else:
      pad = t.e_max - rc_el.shape[0]
      if pad:
        rc_el_p = torch.cat([rc_el, rc_el.new_zeros((pad, rc_el.shape[1]))])
      else:
        rc_el_p = rc_el
      all_rc = self.ax.all_gather(rc_el_p)                 # (P, E_max, nc)
      yc_el = (t.inv_c_rows @ all_rc.reshape(-1)).reshape(
          rc_el.shape[0], -1)
    return yc_el @ t.stencil.T                             # (E, mloc)

  def __call__(self, r: torch.Tensor) -> torch.Tensor:
    t = self.t
    num_e = t.binv.shape[0]
    r_el = r[:num_e * t.mloc].reshape(num_e, t.mloc)
    cy = self._coarse_apply(r_el.to(t.binv.dtype))
    buf = self._halo_buffer(r).to(t.binv.dtype)
    r_ext = buf[t.ext_buf_idx] * t.w_ext
    y_ext = torch.bmm(t.binv, r_ext[..., None])[..., 0] * t.w_ext
    # Contributions to this rank's dofs land directly; those of other
    # ranks' dofs go back to their owners' interface slots by one psum.
    y = self.ext_local_sum.sum(y_ext.reshape(-1))
    if t.overlap:
      contrib = self.ext_contrib_sum.sum(y_ext.reshape(-1))
      total = self.ax.psum(contrib)
      me = self.ax.index
      mine = total[me * t.iface_size:(me + 1) * t.iface_size]
      y = y.index_add(0, self.iface_dofs, mine[self.iface_slots])
    return (y + self._pad(cy)).to(r.dtype)

  def fast_matvec(self, p: torch.Tensor) -> torch.Tensor:
    """The assembled block-sparse ``E p`` (one halo all_gather)."""
    buf = self._halo_buffer(p).to(self.t.rb.dtype)
    pn = buf[self.t.nbr_buf_idx]                           # (E, width*mloc)
    y = torch.bmm(self.t.rb, pn[..., None])[..., 0]
    return self._pad(y).to(p.dtype)


def build_distributed_schwarz(sem_u, premesh, boundary_conditions,
                              dt: float, time_order: int,
                              coarse: str = 'auto',
                              max_coarse_dofs: int = 16000,
                              overlap='auto') -> DistributedSchwarzTables:
  """Every partition's Schwarz tables for a partitioned pressure solve.

  Args:
    sem_u: the UNPARTITIONED twin `StokesSEM` (the same premesh with
      ``partitions=None``, the same order, boundary conditions and
      coordinates): its float64 host copy is probed, exactly as the
      single-device set-up does; its dtype is the tables' (`on_rank`
      casts them to the rank's).
    premesh: the order-1 premesh WITH ``partitions``.
    boundary_conditions: as given to ``StokesSEM.create``.
    coarse: ``'p1dg'`` | ``'vertex'`` | ``'vertex-cheb'`` | ``'auto'`` (p1dg
      while its dimension fits `max_coarse_dofs`, else vertex; a vertex
      coarse above it takes the Chebyshev solve).
    overlap: 0 | 1 | 'auto' (1 in 2D, 0 in 3D).

  Returns:
    The `DistributedSchwarzTables`; ship ``tables.row(rank)`` to each rank
    and build its apply there with ``row.on_rank(ax, device=, dtype=)``.
  """
  t0 = time.perf_counter()
  if not premesh.is_partitioned():
    raise ValueError('premesh must be partitioned')
  if getattr(sem_u, 'axis', None) is not None:
    raise ValueError(
        'partitioned premesh requires the UNPARTITIONED twin StokesSEM '
        '(create it from premesh.replace(partitions=None)); got the solver '
        'of a rank of a partitioned mesh')
  if coarse not in COARSE_KINDS:
    raise ValueError(f'unknown coarse space {coarse!r}')
  pmesh = sem_u.pressure.pspace.mesh
  d = premesh.ndim
  m = pmesh.order + 1
  mloc = m ** d
  num_e = premesh.num_elements
  npn = pmesh.num_nodes
  elements = pmesh.elements.cpu().numpy()
  if not np.array_equal(elements.reshape(-1), np.arange(npn)):
    raise NotImplementedError('expected element-contiguous DG pressure dofs')

  uid = _schwarz._vertex_unique_ids(premesh)  # pylint: disable=protected-access
  el_uid = uid[np.asarray(premesh.elements)]
  adj = _schwarz._element_adjacency(el_uid)  # pylint: disable=protected-access
  if overlap == 'auto':
    overlap = 1 if d == 2 else 0

  # -- probing on the unpartitioned twin (identical to ops.schwarz) ---------
  probes = [0]
  matvec64 = _schwarz._matvec64(sem_u, dt, time_order)  # pylint: disable=protected-access

  def matvec_batch(ps):
    probes[0] += len(ps)
    return matvec64(ps)

  colors2 = _schwarz._distance2_coloring(adj)  # pylint: disable=protected-access
  diag_blocks, pairs = _schwarz._probe_element_blocks(  # pylint: disable=protected-access
      matvec_batch, elements, colors2, npn, adj=adj)
  if overlap:
    if overlap != 1:
      raise NotImplementedError('only overlap=1 extended locals')
    ext_nodes, ext_owner, ext_local = _schwarz._extended_tables(  # pylint: disable=protected-access
        el_uid, elements, m, d)
    blocks = _schwarz._extended_blocks(pairs, adj, ext_owner, ext_local)  # pylint: disable=protected-access
    count = np.zeros(npn)
    np.add.at(count, ext_nodes[ext_nodes >= 0], 1.0)
    wglob = 1.0 / np.sqrt(np.maximum(count, 1.0))
    w_ext = np.where(ext_nodes >= 0, wglob[np.clip(ext_nodes, 0, None)], 0.0)
  else:
    ext_nodes = elements.copy()
    blocks = diag_blocks
    w_ext = np.ones((num_e, mloc))
  binv = np.linalg.inv(blocks)
  binv = 0.5 * (binv + np.swapaxes(binv, 1, 2))
  next_loc = binv.shape[1]
  has_nullspace = not _schwarz._has_outflow(  # pylint: disable=protected-access
      premesh, boundary_conditions, uid)

  # -- coarse (as in ops.schwarz) --------------------------------------------
  nv = int(uid.max()) + 1
  if coarse == 'auto':
    coarse = 'p1dg' if (2 ** d) * num_e <= max_coarse_dofs else 'vertex'
  cheb = None
  inv_c = None
  unpart = premesh.replace(partitions=None)
  if coarse == 'p1dg':
    stencil, inv_c = _schwarz._p1dg_coarse(  # pylint: disable=protected-access
        matvec_batch, elements, adj, colors2, pmesh, d, npn, has_nullspace)
  else:
    stencil = _schwarz._vertex_stencil(pmesh, d)  # pylint: disable=protected-access
    if coarse == 'vertex-cheb' or nv > max_coarse_dofs:
      from swirlfem_tpu_torch.ops.coarse_cheb import build_cheb_vertex_coarse
      cheb = build_cheb_vertex_coarse(
          unpart, boundary_conditions, uid, el_uid, nv, dt, time_order,
          has_nullspace, dtype=sem_u.dtype, device='cpu')
      coarse = 'vertex-cheb'
    else:
      inv_c = _schwarz._vertex_coarse_inverse(  # pylint: disable=protected-access
          unpart, boundary_conditions, uid, el_uid, nv, dt, time_order,
          has_nullspace)
  nc = stencil.shape[1]

  # -- partition layout (the JAX package's) ----------------------------------
  rows = topology.group_by_partitions(premesh.partitions)   # (P, E_max)
  num_p, e_max = rows.shape
  n_loc = e_max * mloc
  valid_el = rows != topology.SENTINEL
  part_of = np.asarray(premesh.partitions).reshape(-1)
  pos_in_part = np.zeros(num_e, dtype=np.int64)
  for q in range(num_p):
    sel = rows[q][valid_el[q]]
    pos_in_part[sel] = np.arange(len(sel))

  # Interface sets: q-local dofs any other partition reads (the halo of
  # the extended locals, and whole vertex-neighbor elements for E).
  live = ext_nodes >= 0
  g_of = np.broadcast_to(np.arange(num_e)[:, None], ext_nodes.shape)
  gd = np.clip(ext_nodes, 0, None)
  owner_el = gd // mloc
  q_of = part_of[owner_el]
  lf_of = pos_in_part[owner_el] * mloc + gd % mloc
  remote = live & (q_of != part_of[g_of])
  pairs_q = [q_of[remote]]
  pairs_lf = [lf_of[remote]]
  adj_g = np.asarray([g for g in range(num_e) for _ in adj[g]], np.int64)
  adj_n = np.asarray([n for g in range(num_e) for n in adj[g]], np.int64)
  cross = part_of[adj_n] != part_of[adj_g]
  nb = adj_n[cross]
  pairs_q.append(np.repeat(part_of[nb], mloc))
  pairs_lf.append((pos_in_part[nb][:, None] * mloc
                   + np.arange(mloc)[None, :]).reshape(-1))
  all_q = np.concatenate(pairs_q)
  all_lf = np.concatenate(pairs_lf)
  iface_lists = [np.unique(all_lf[all_q == q]) for q in range(num_p)]
  iface_n = max(1, max((len(s) for s in iface_lists), default=0))
  iface_idx = np.zeros((num_p, iface_n), dtype=np.int64)
  iface_valid = np.zeros((num_p, iface_n))
  for q in range(num_p):
    iface_idx[q, :len(iface_lists[q])] = iface_lists[q]
    iface_valid[q, :len(iface_lists[q])] = 1.0

  def iface_slot(q, lf):
    """Position of dof `lf` of partition `q` in q's interface list."""
    out = np.zeros(q.shape, dtype=np.int64)
    for p in range(num_p):
      sel = q == p
      if sel.any():
        out[sel] = np.searchsorted(iface_lists[p], lf[sel])
    return out

  # Buffer layout per partition p: [local (n_loc) | iface (P * I) | zero].
  dead_buf = n_loc + num_p * iface_n
  p_of_el = part_of
  local = live & (q_of == p_of_el[:, None])
  far = live & ~local
  slot_far = np.zeros(ext_nodes.shape, dtype=np.int64)
  slot_far[far] = iface_slot(q_of[far], lf_of[far])
  el_buf = np.where(local, lf_of, np.where(
      far, n_loc + q_of * iface_n + slot_far, dead_buf))
  el_local = np.where(local, lf_of, n_loc)
  el_contrib = np.where(far, q_of * iface_n + slot_far, num_p * iface_n)
  el_w = np.where(live, w_ext, 0.0)

  # -- assembled block-sparse E ------------------------------------------------
  nbrs_sorted = [sorted(adj[e]) for e in range(num_e)]
  width = 1 + max((len(x) for x in nbrs_sorted), default=0)
  el_rb = np.zeros((num_e, mloc, width * mloc))
  cols = np.full((num_e, width), -1, dtype=np.int64)
  for g in range(num_e):
    for k, n in enumerate([g] + nbrs_sorted[g]):
      el_rb[g, :, k * mloc:(k + 1) * mloc] = pairs[(g, n)]
      cols[g, k] = n
  has = cols >= 0
  cn = np.clip(cols, 0, None)
  base = pos_in_part[cn][..., None] * mloc + np.arange(mloc)  # (E, W, mloc)
  qn = part_of[cn][..., None] + np.zeros(mloc, np.int64)
  same = qn == p_of_el[:, None, None]
  nslot = np.zeros(base.shape, dtype=np.int64)
  other = ~same & has[..., None]
  nslot[other] = iface_slot(qn[other], base[other])
  el_nbr = np.where(same, base, n_loc + qn * iface_n + nslot)
  el_nbr = np.where(has[..., None], el_nbr, dead_buf).reshape(num_e, -1)

  # -- coarse inverse rows ----------------------------------------------------
  el_cvid_gather = None
  part_rows = {}
  if coarse == 'p1dg':
    # Column order of the all_gathered (q, l, i) layout; padded element
    # slots get zero columns.
    perm_cols = np.full(num_p * e_max * nc, -1, dtype=np.int64)
    for q in range(num_p):
      sel = rows[q][valid_el[q]]
      for i in range(nc):
        perm_cols[(q * e_max + np.arange(len(sel))) * nc + i] = sel * nc + i
    col_valid = perm_cols >= 0
    for p in range(num_p):
      sel = rows[p][valid_el[p]]
      r_ = np.zeros((len(sel) * nc, num_p * e_max * nc))
      src = inv_c[(sel[:, None] * nc + np.arange(nc)).reshape(-1)]
      r_[:, col_valid] = src[:, perm_cols[col_valid]]
      part_rows[p] = r_
  elif coarse == 'vertex':
    el_cvid_gather = np.zeros((num_e, nc), dtype=np.int64)
    for p in range(num_p):
      sel = rows[p][valid_el[p]]
      vids = (np.unique(el_uid[sel]) if len(sel)
              else np.zeros(0, dtype=el_uid.dtype))
      part_rows[p] = inv_c[vids]
      el_cvid_gather[sel] = np.searchsorted(vids, el_uid[sel])
  nv_max = (max(1, max(len(v) for v in part_rows.values()))
            if coarse == 'vertex' else None)

  rdtype = np.float32 if sem_u.dtype == torch.float32 else np.float64
  cheb_np = None if cheb is None else _cheb_fields(cheb)
  out_rows = []
  for p in range(num_p):
    sel = rows[p][valid_el[p]]
    inv_rows = None
    if coarse == 'p1dg':
      inv_rows = part_rows[p].astype(rdtype)
    elif coarse == 'vertex':
      inv_rows = np.zeros((nv_max, nv), rdtype)
      inv_rows[:len(part_rows[p])] = part_rows[p]
    out_rows.append(DistributedSchwarzRow(
        rank=p, num_partitions=num_p, n_loc=n_loc, mloc=mloc, e_max=e_max,
        binv=binv[sel].astype(rdtype), ext_buf_idx=el_buf[sel],
        w_ext=el_w[sel].astype(rdtype),
        ext_local_idx=np.where(el_local[sel] == n_loc, topology.SENTINEL,
                               el_local[sel]),
        ext_contrib_idx=np.where(el_contrib[sel] == num_p * iface_n,
                                 topology.SENTINEL, el_contrib[sel]),
        iface_idx=iface_idx[p], iface_valid=iface_valid[p].astype(rdtype),
        stencil=stencil.astype(rdtype), inv_c_rows=inv_rows,
        rb=el_rb[sel].astype(rdtype), nbr_buf_idx=el_nbr[sel],
        cvid_scatter=(None if coarse == 'p1dg' else el_uid[sel].astype(
            np.int64)),
        cvid_gather=(None if el_cvid_gather is None
                     else el_cvid_gather[sel]),
        cheb=cheb_np, overlap=int(overlap), has_nullspace=has_nullspace,
        coarse_kind=coarse, coarse_nv=nv, iface_size=iface_n))

  return DistributedSchwarzTables(
      rows=tuple(out_rows), element_rows=rows,
      setup_seconds=time.perf_counter() - t0,
      colors=int(colors2.max()) + 1, probe_applies=probes[0], coarse=coarse,
      coarse_dofs=(num_e * nc if coarse == 'p1dg' else nv),
      cheb_degree=None if cheb is None else int(cheb.degree),
      overlap=int(overlap), has_nullspace=has_nullspace)

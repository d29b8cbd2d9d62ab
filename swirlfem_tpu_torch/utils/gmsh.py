"""Native Gmsh MSH reader (4.1 and 2.2, ASCII and binary) producing a
`Premesh`.

The port's own copy of ``swirlfem_tpu/utils/gmsh.py`` (pure numpy).

Parity target: reference ``swirl_fem/common/mesh_reader.py`` (read :78-114):
line/quad/hexahedron cells reordered from Gmsh corner conventions to
lexicographic tensor order, and ``$Periodic`` node correspondences converted
to facet-pair periodic links.  The reference delegates parsing to `meshio`
(which also handles binary files); this package does not need it: both
the ASCII and the binary MSH 4.1 encodings are parsed directly — which also
lets us surface ``$PhysicalNames`` as Premesh physical groups (the
reference reader drops them).
"""

from __future__ import annotations

import numpy as np

from swirlfem_tpu_torch.core.premesh import Premesh

# Gmsh corner ordering -> lexicographic tensor ordering, per element dim.
# (Same tables as reference mesh_reader.py:40-44.)
_GMSH_TO_LEX = {
    1: [0, 1],
    2: [0, 3, 1, 2],
    3: [0, 4, 3, 7, 1, 5, 2, 6],
}

# Gmsh element type code -> (dimension, number of corner nodes).
_ELEM_TYPES = {1: (1, 2), 3: (2, 4), 5: (3, 8), 15: (0, 1)}


class _Tokens:
  """Sequential token reader over the section body lines."""

  def __init__(self, lines):
    self._tokens = ' '.join(lines).split()
    self._pos = 0

  def take(self, n=1):
    out = self._tokens[self._pos:self._pos + n]
    self._pos += n
    return out

  def int(self):
    return int(self.take()[0])

  def ints(self, n):
    return [int(t) for t in self.take(n)]

  def floats(self, n):
    return [float(t) for t in self.take(n)]


def _sections(text: str) -> dict[str, list[str]]:
  out = {}
  lines = text.splitlines()
  i = 0
  while i < len(lines):
    line = lines[i].strip()
    if line.startswith('$') and not line.startswith('$End'):
      name = line[1:]
      j = i + 1
      body = []
      while j < len(lines) and lines[j].strip() != f'$End{name}':
        body.append(lines[j])
        j += 1
      out[name] = body
      i = j + 1
    else:
      i += 1
  return out


def _parse_entities(body):
  """entity (dim, tag) -> list of physical tags."""
  tok = _Tokens(body)
  counts = tok.ints(4)  # points, curves, surfaces, volumes
  phys = {}
  for dim, count in enumerate(counts):
    for _ in range(count):
      tag = tok.int()
      # Points carry xyz; higher-dim entities carry a bounding box.
      tok.floats(3 if dim == 0 else 6)
      num_phys = tok.int()
      phys[(dim, tag)] = tok.ints(num_phys)
      if dim > 0:
        num_bounding = tok.int()
        tok.ints(num_bounding)
  return phys


def _parse_nodes(body):
  tok = _Tokens(body)
  num_blocks, total, _, _ = tok.ints(4)
  tags = np.empty(total, dtype=np.int64)
  coords = np.empty((total, 3), dtype=np.float64)
  filled = 0
  for _ in range(num_blocks):
    _, _, parametric, count = tok.ints(4)
    if parametric:
      raise NotImplementedError('parametric nodes are not supported')
    block_tags = tok.ints(count)
    tags[filled:filled + count] = block_tags
    for k in range(count):
      coords[filled + k] = tok.floats(3)
    filled += count
  return tags, coords


def _parse_elements(body):
  """Yields (entity_dim, entity_tag, elem_type, node_tag_rows)."""
  tok = _Tokens(body)
  num_blocks, _, _, _ = tok.ints(4)
  blocks = []
  for _ in range(num_blocks):
    entity_dim, entity_tag, etype, count = tok.ints(4)
    if etype not in _ELEM_TYPES:
      raise NotImplementedError(
          f'unsupported Gmsh element type {etype}; only points, 2-node '
          'lines, 4-node quads and 8-node hexahedra are supported')
    _, nper = _ELEM_TYPES[etype]
    rows = np.empty((count, nper), dtype=np.int64)
    for k in range(count):
      vals = tok.ints(1 + nper)  # elementTag + node tags
      rows[k] = vals[1:]
    blocks.append((entity_dim, entity_tag, etype, rows))
  return blocks


def _parse_periodic(body):
  """Per-record ``(entity_dim, {slave tag: master tag})`` correspondences.

  Records stay separate: a corner node on two slave surfaces of a multiply
  periodic box appears in both surface tables with DIFFERENT images (one
  per periodic direction); merging the tables would pair some facets with
  a mix of transforms, producing "master facets" that are not element
  facets at all.
  """
  tok = _Tokens(body)
  num_links = tok.int()
  records: list[tuple[int, dict[int, int]]] = []
  for _ in range(num_links):
    entity_dim, _, _ = tok.ints(3)
    num_affine = tok.int()
    tok.floats(num_affine)
    count = tok.int()
    table = {}
    for _ in range(count):
      slave, master = tok.ints(2)
      table[slave] = master
    records.append((entity_dim, table))
  return records


# ---------------------------------------------------------------------------
# Binary MSH 4.1
# ---------------------------------------------------------------------------


class _BinReader:
  """Sequential reader over binary MSH bytes (spec: gmsh.info MSH 4.1)."""

  def __init__(self, data: bytes, pos: int, size_t_bytes: int,
               byteorder: str):
    self._data = data
    self._pos = pos
    self._i4 = np.dtype(byteorder + 'i4')
    self._szt = np.dtype(byteorder + ('i8' if size_t_bytes == 8 else 'i4'))
    self._f8 = np.dtype(byteorder + 'f8')

  def line(self) -> str:
    end = self._data.find(b'\n', self._pos)
    if end < 0:
      raise ValueError('malformed binary MSH: unterminated line at byte '
                       f'{self._pos}')
    out = self._data[self._pos:end].decode('utf-8').strip()
    self._pos = end + 1
    return out

  def skip_newline(self):
    while self._pos < len(self._data) and self._data[self._pos:
                                                     self._pos + 1] == b'\n':
      self._pos += 1

  def _array(self, dtype, n):
    if self._pos + n * dtype.itemsize > len(self._data):
      raise ValueError(
          f'malformed/truncated binary MSH: wanted {n} x {dtype} at byte '
          f'{self._pos}, file has {len(self._data)} bytes')
    out = np.frombuffer(self._data, dtype=dtype, count=n, offset=self._pos)
    self._pos += n * dtype.itemsize
    return out

  def i4(self, n):
    return self._array(self._i4, n).astype(np.int64)

  def size_t(self, n):
    return self._array(self._szt, n).astype(np.int64)

  def f8(self, n):
    return self._array(self._f8, n)


def _bin_nodes(r: _BinReader):
  num_blocks, total, _, _ = r.size_t(4)
  tags = np.empty(total, dtype=np.int64)
  coords = np.empty((total, 3), dtype=np.float64)
  filled = 0
  for _ in range(num_blocks):
    _, _, parametric = r.i4(3)
    if parametric:
      raise NotImplementedError('parametric nodes are not supported')
    (count,) = r.size_t(1)
    tags[filled:filled + count] = r.size_t(count)
    coords[filled:filled + count] = r.f8(3 * count).reshape(count, 3)
    filled += count
  return tags, coords


def _bin_elements(r: _BinReader):
  num_blocks, _, _, _ = r.size_t(4)
  blocks = []
  for _ in range(num_blocks):
    entity_dim, entity_tag, etype = r.i4(3)
    (count,) = r.size_t(1)
    if etype not in _ELEM_TYPES:
      raise NotImplementedError(
          f'unsupported Gmsh element type {etype}; only points, 2-node '
          'lines, 4-node quads and 8-node hexahedra are supported')
    _, nper = _ELEM_TYPES[int(etype)]
    rows = r.size_t(count * (1 + nper)).reshape(count, 1 + nper)[:, 1:]
    blocks.append((int(entity_dim), int(entity_tag), int(etype),
                   np.ascontiguousarray(rows)))
  return blocks


def _bin_entities(r: _BinReader):
  counts = r.size_t(4)
  phys = {}
  for dim, count in enumerate(counts):
    for _ in range(count):
      (tag,) = r.i4(1)
      r.f8(3 if dim == 0 else 6)
      (num_phys,) = r.size_t(1)
      phys[(dim, int(tag))] = [int(t) for t in r.i4(num_phys)]
      if dim > 0:
        (num_bounding,) = r.size_t(1)
        r.i4(num_bounding)
  return phys


def _bin_periodic(r: _BinReader):
  """Binary twin of `_parse_periodic`: per-record tables, kept separate."""
  (num_links,) = r.size_t(1)
  records: list[tuple[int, dict[int, int]]] = []
  for _ in range(num_links):
    entity_dim, _, _ = r.i4(3)
    (num_affine,) = r.size_t(1)
    r.f8(num_affine)
    (count,) = r.size_t(1)
    pairs = r.size_t(2 * count).reshape(count, 2)
    records.append((int(entity_dim),
                    {int(s): int(m) for s, m in pairs}))
  return records


def _parse_binary(data: bytes, size_t_bytes: int, byteorder: str):
  """Sequentially parses a binary MSH 4.1 byte stream.

  Sections are read in file order: binary bodies are self-describing (the
  counts give the exact byte extent), so no marker scanning happens inside
  them — binary payloads may legitimately contain bytes resembling ``$``
  markers.  PhysicalNames stays ASCII even in binary files.
  """
  r = _BinReader(data, data.index(b'$EndMeshFormat'), size_t_bytes,
                 byteorder)
  r.line()  # $EndMeshFormat
  tags = coords3 = None
  blocks = []
  names = {}
  entity_phys = {}
  periodic_records = []
  while True:
    r.skip_newline()
    if r._pos >= len(data):
      break
    header = r.line()
    if not header.startswith('$'):
      continue
    name = header[1:]
    if name == 'Nodes':
      tags, coords3 = _bin_nodes(r)
    elif name == 'Elements':
      blocks = _bin_elements(r)
    elif name == 'Entities':
      entity_phys = _bin_entities(r)
    elif name == 'Periodic':
      periodic_records = _bin_periodic(r)
    elif name == 'PhysicalNames':
      num_names = int(r.line())
      for _ in range(num_names):
        parts = r.line().split()
        names[(int(parts[0]), int(parts[1]))] = ' '.join(
            parts[2:]).strip('"')
    elif name.startswith('End'):
      continue
    else:
      # Unknown section ($NodeData etc. — binary payloads in binary
      # files): skip to its end marker.  A payload could in principle
      # contain marker-resembling bytes; supported sections are parsed by
      # their self-describing counts and never hit this scan.
      marker = f'$End{name}'.encode('ascii')
      end = data.find(marker, r._pos)
      if end < 0:
        raise ValueError(f'malformed binary MSH: unterminated ${name} '
                         'section')
      r._pos = end + len(marker)
      continue
    r.skip_newline()
    end_line = r.line()
    if end_line != f'$End{name}':
      raise ValueError(f'malformed binary MSH: expected $End{name}, '
                       f'got {end_line!r}')
  if tags is None:
    raise ValueError('binary MSH file has no $Nodes section')
  return tags, coords3, blocks, names, entity_phys, periodic_records


def _require_section(sections, name: str, fmt: str):
  """Fetch a mandatory $-section or raise a descriptive parse error
  (a malformed file must not surface as a bare KeyError)."""
  if name not in sections:
    raise ValueError(
        f'malformed {fmt} MSH file: missing required ${name} section '
        f'(found: {sorted(sections) or "none"})')
  return sections[name]


def _parse_ascii(text: str):
  sections = _sections(text)
  tags, coords3 = _parse_nodes(_require_section(sections, 'Nodes', '4.1'))
  blocks = _parse_elements(_require_section(sections, 'Elements', '4.1'))
  names = {}
  if 'PhysicalNames' in sections:
    # Line-wise (like the binary path): quoted names may contain spaces.
    lines = [l.strip() for l in sections['PhysicalNames'] if l.strip()]
    for line in lines[1:1 + int(lines[0])]:
      parts = line.split()
      names[(int(parts[0]), int(parts[1]))] = ' '.join(parts[2:]).strip('"')
  entity_phys = (_parse_entities(sections['Entities'])
                 if 'Entities' in sections else {})
  periodic_records = (_parse_periodic(sections['Periodic'])
                      if 'Periodic' in sections else [])
  return tags, coords3, blocks, names, entity_phys, periodic_records


def _parse_ascii22(text: str):
  """Legacy ASCII MSH 2.2 parser, normalized to the 4.1 internal layout.

  The reference reads 2.2 files through meshio
  (``swirl_fem/common/mesh_reader.py:78``); still the most common format
  in the wild.  Elements carry ``(physical, elementary)`` tag pairs
  inline, so entity->physical maps are reconstructed per elementary
  entity; ``$Periodic`` (2.x flavor: optional same-line ``Affine`` row)
  is normalized to per-record node tables.
  """
  sections = _sections(text)

  tok = _Tokens(_require_section(sections, 'Nodes', '2.2'))
  total = tok.int()
  tags = np.empty(total, dtype=np.int64)
  coords3 = np.empty((total, 3), dtype=np.float64)
  for k in range(total):
    tags[k] = tok.int()
    coords3[k] = tok.floats(3)

  tok = _Tokens(_require_section(sections, 'Elements', '2.2'))
  count = tok.int()
  grouped: dict[tuple[int, int, int], list[np.ndarray]] = {}
  entity_phys: dict[tuple[int, int], list[int]] = {}
  for _ in range(count):
    _, etype, ntags = tok.int(), tok.int(), tok.int()
    etags = tok.ints(ntags)
    if etype not in _ELEM_TYPES:
      raise NotImplementedError(
          f'unsupported Gmsh element type {etype}; only points, 2-node '
          'lines, 4-node quads and 8-node hexahedra are supported')
    dim, nper = _ELEM_TYPES[etype]
    row = np.asarray(tok.ints(nper), dtype=np.int64)
    phys = etags[0] if ntags >= 1 else 0
    entity = etags[1] if ntags >= 2 else 0
    grouped.setdefault((dim, entity, etype), []).append(row)
    if phys:
      known = entity_phys.setdefault((dim, entity), [])
      if phys not in known:
        known.append(phys)
  blocks = [(dim, entity, etype, np.stack(rows))
            for (dim, entity, etype), rows in grouped.items()]

  names = {}
  if 'PhysicalNames' in sections:
    lines = [l.strip() for l in sections['PhysicalNames'] if l.strip()]
    for line in lines[1:1 + int(lines[0])]:
      parts = line.split()
      names[(int(parts[0]), int(parts[1]))] = ' '.join(parts[2:]).strip('"')

  periodic_records = []
  if 'Periodic' in sections:
    tok = _Tokens(sections['Periodic'])
    num_links = tok.int()
    for _ in range(num_links):
      entity_dim, _, _ = tok.ints(3)
      nxt = tok.take()[0]
      if nxt == 'Affine':
        tok.floats(16)
        count = tok.int()
      else:
        count = int(nxt)
      table = {}
      for _ in range(count):
        slave, master = tok.ints(2)
        table[slave] = master
      periodic_records.append((entity_dim, table))

  return tags, coords3, blocks, names, entity_phys, periodic_records


def _parse_binary22(data: bytes, byteorder: str):
  """Legacy BINARY MSH 2.2 parser, normalized to the 4.1 internal layout.

  Spec (gmsh.info, legacy file format): ``$Nodes`` holds one i4 tag +
  3 f8 coordinates per node (count on an ASCII line); ``$Elements`` holds
  blocks headed by 3 i4 (etype, block count, tag count) followed by
  ``count x (1 + ntags + nper)`` i4 records.  ``$PhysicalNames`` and
  ``$Periodic`` stay ASCII even in binary 2.x files.  Tag conventions
  ((physical, elementary) pairs -> per-entity physical lists) mirror
  `_parse_ascii22`.
  """
  r = _BinReader(data, data.index(b'$EndMeshFormat'), 8, byteorder)
  r.line()  # $EndMeshFormat
  node_rec = np.dtype([('tag', byteorder + 'i4'),
                       ('xyz', byteorder + 'f8', (3,))])
  tags = coords3 = None
  grouped: dict[tuple[int, int, int], list[np.ndarray]] = {}
  entity_phys: dict[tuple[int, int], list[int]] = {}
  names = {}
  periodic_records = []
  while True:
    r.skip_newline()
    if r._pos >= len(data):  # pylint: disable=protected-access
      break
    header = r.line()
    if not header.startswith('$'):
      continue
    name = header[1:]
    if name == 'Nodes':
      total = int(r.line())
      raw = r._array(node_rec, total)  # pylint: disable=protected-access
      tags = raw['tag'].astype(np.int64)
      coords3 = np.ascontiguousarray(raw['xyz'], dtype=np.float64)
    elif name == 'Elements':
      total = int(r.line())
      done = 0
      while done < total:
        etype, nblock, ntags = (int(v) for v in r.i4(3))
        if etype not in _ELEM_TYPES:
          raise NotImplementedError(
              f'unsupported Gmsh element type {etype}; only points, '
              '2-node lines, 4-node quads and 8-node hexahedra are '
              'supported')
        dim, nper = _ELEM_TYPES[etype]
        rec = r.i4(nblock * (1 + ntags + nper)).reshape(
            nblock, 1 + ntags + nper)
        phys = rec[:, 1] if ntags >= 1 else np.zeros(nblock, np.int64)
        entity = rec[:, 2] if ntags >= 2 else np.zeros(nblock, np.int64)
        nodes = rec[:, 1 + ntags:]
        for ent in np.unique(entity):
          sel = entity == ent
          grouped.setdefault((dim, int(ent), etype), []).append(
              np.ascontiguousarray(nodes[sel]))
          for ph in np.unique(phys[sel]):
            if ph:
              known = entity_phys.setdefault((dim, int(ent)), [])
              if int(ph) not in known:
                known.append(int(ph))
        done += nblock
    elif name == 'PhysicalNames':
      num_names = int(r.line())
      for _ in range(num_names):
        parts = r.line().split()
        names[(int(parts[0]), int(parts[1]))] = ' '.join(
            parts[2:]).strip('"')
    elif name == 'Periodic':
      # ASCII in 2.x binary files; delimit by the end marker.
      end = data.find(b'$EndPeriodic', r._pos)  # pylint: disable=protected-access
      if end < 0:
        raise ValueError('malformed binary MSH 2.x: unterminated '
                         '$Periodic section')
      text = data[r._pos:end].decode('utf-8')  # pylint: disable=protected-access
      tok = _Tokens(text.splitlines())
      num_links = tok.int()
      for _ in range(num_links):
        entity_dim, _, _ = tok.ints(3)
        nxt = tok.take()[0]
        if nxt == 'Affine':
          tok.floats(16)
          count = tok.int()
        else:
          count = int(nxt)
        table = {}
        for _ in range(count):
          slave, master = tok.ints(2)
          table[slave] = master
        periodic_records.append((entity_dim, table))
      r._pos = end  # pylint: disable=protected-access
    elif name.startswith('End'):
      continue
    else:
      marker = f'$End{name}'.encode('ascii')
      end = data.find(marker, r._pos)  # pylint: disable=protected-access
      if end < 0:
        raise ValueError(f'malformed binary MSH 2.x: unterminated '
                         f'${name} section')
      r._pos = end + len(marker)  # pylint: disable=protected-access
      continue
    r.skip_newline()
    end_line = r.line()
    if end_line != f'$End{name}':
      raise ValueError(f'malformed binary MSH 2.x: expected $End{name}, '
                       f'got {end_line!r}')
  if tags is None:
    raise ValueError(
        'malformed 2.2 MSH file: missing required $Nodes section')
  if not grouped:
    raise ValueError(
        'malformed 2.2 MSH file: missing required $Elements section')
  blocks = [(dim, entity, etype, np.concatenate(rows).astype(np.int64))
            for (dim, entity, etype), rows in grouped.items()]
  return tags, coords3, blocks, names, entity_phys, periodic_records


def read(path, ndim: int) -> Premesh:
  """Parses an MSH 4.1 (ASCII/binary) or legacy 2.2 (ASCII/binary) file
  into an order-1 `Premesh`."""
  if ndim not in (1, 2, 3):
    raise ValueError(f'invalid ndim {ndim}; expected 1, 2 or 3')
  with open(path, 'rb') as f:
    data = f.read()
  if not data.startswith(b'$MeshFormat'):
    raise ValueError(f'{path} is not a Gmsh MSH file')
  fmt_line = data[len(b'$MeshFormat'):data.index(b'$EndMeshFormat')]
  version = fmt_line.split(b'\n')[1].split()
  file_type = int(version[1])
  if version[0].startswith(b'2'):
    if file_type != 0:
      # Legacy binary 2.x: the binary int 1 after the version line probes
      # byte order (same convention as 4.x binary).
      head = data[:data.index(b'$EndMeshFormat')]
      nl = head.index(b'\n', head.index(b'\n') + 1)
      one = int.from_bytes(data[nl + 1:nl + 5], 'little', signed=True)
      parsed = _parse_binary22(data, '<' if one == 1 else '>')
    else:
      parsed = _parse_ascii22(data.decode('utf-8'))
  elif not version[0].startswith(b'4'):
    raise NotImplementedError(
        f'only MSH formats 2.x (ASCII) and 4.x are supported, '
        f'got {version[0].decode()}')
  elif file_type == 0:
    parsed = _parse_ascii(data.decode('utf-8'))
  else:
    size_t_bytes = int(version[2])
    # The binary int 1 written right after the version line probes byte
    # order.
    head = data[:data.index(b'$EndMeshFormat')]
    nl = head.index(b'\n', head.index(b'\n') + 1)  # end of the version line
    one = int.from_bytes(data[nl + 1:nl + 5], 'little', signed=True)
    byteorder = '<' if one == 1 else '>'
    parsed = _parse_binary(data, size_t_bytes, byteorder)
  tags, coords3, blocks, names, entity_phys, periodic_records = parsed

  tag_to_idx = {int(t): i for i, t in enumerate(tags)}
  node_coords = coords3[:, :ndim]

  def to_indices(rows, dim):
    idx = np.vectorize(tag_to_idx.__getitem__)(rows)
    return np.asarray(idx, dtype=np.int32)[:, _GMSH_TO_LEX[dim]]

  cell_blocks = [(d, t, to_indices(rows, d))
                 for d, t, etype, rows in blocks
                 if _ELEM_TYPES[etype][0] == ndim]
  if not cell_blocks:
    raise ValueError(f'no {ndim}-dimensional cells found in {path}')
  elements = np.concatenate([rows for _, _, rows in cell_blocks], axis=0)

  # Physical groups: facet-dimension entities carrying physical tags.
  physical_groups = {}
  if names and entity_phys:
    facet_dim = ndim - 1
    facets_by_name: dict[str, list[np.ndarray]] = {}
    for d, t, etype, rows in blocks:
      if _ELEM_TYPES[etype][0] != facet_dim:
        continue
      for ptag in entity_phys.get((d, t), []):
        name = names.get((facet_dim, ptag))
        if name is not None:
          facets_by_name.setdefault(name, []).append(
              to_indices(rows, facet_dim) if facet_dim else
              np.vectorize(tag_to_idx.__getitem__)(rows).astype(np.int32))
    physical_groups = {name: np.concatenate(parts, axis=0)
                       for name, parts in facets_by_name.items()}

  # Periodic links: node correspondences on (ndim-1)-dim entities, turned
  # into facet pairs over the facet cells present in the file.
  periodic_links = None
  if periodic_records:
    # One mapping PER record (per periodic direction): a corner node on
    # two slave surfaces of a multiply periodic box has a different image
    # in each surface's table, and a merged dict would pair some facets
    # with a mix of transforms — "master facets" that are not element
    # facets.  Each (ndim-1)-dim record's table covers the closure of its
    # surface, so every slave facet matches exactly one coherent table.
    mappings = []
    for dim, table in periodic_records:
      if dim != ndim - 1:
        continue
      mappings.append({tag_to_idx[s]: tag_to_idx[m]
                       for s, m in table.items()
                       if s in tag_to_idx and m in tag_to_idx})
    facet_nper = {1: 1, 2: 2, 3: 4}[ndim]
    links = []
    for d, t, etype, rows in blocks:
      if _ELEM_TYPES[etype][0] != ndim - 1:
        continue
      # Same lexicographic corner reorder as elements/physical groups:
      # without it 3D periodic links arrive in Gmsh cyclic order and the
      # refiner's tensor-grid facet matching rejects them.
      facets = (to_indices(rows, ndim - 1) if ndim - 1 >= 1 else
                np.vectorize(tag_to_idx.__getitem__)(rows).astype(np.int32))
      for facet in facets:
        for mapping in mappings:
          if all(int(n) in mapping for n in facet):
            target = np.asarray([mapping[int(n)] for n in facet],
                                dtype=np.int32)
            links.append(np.stack([facet, target]))
            break
    if links:
      periodic_links = np.stack(links).astype(np.int32)
      assert periodic_links.shape[1:] == (2, facet_nper), periodic_links.shape

  return Premesh.create(
      node_coords=node_coords,
      elements=elements,
      physical_groups=physical_groups,
      periodic_links=periodic_links,
  )

"""An HDF5 reader in numpy, struct and zlib, so that the benchmark
needs neither h5py nor libhdf5 to read the program's output files.

    with hdf5.File("model.h5") as f:
        p = f["cell_fields/fluid_pressure"][-1]

It offers the part of h5py's reading interface that the check uses.
The layout follows the HDF5 File Format Specification, version 3.0.

The reader reads:
- superblocks of versions 0-3 at the start of the file, with 8-byte
  addresses and lengths;
- object headers of versions 1 and 2 (checksums verified), with
  continuation blocks;
- groups as symbol tables (a v1 B-tree of symbol nodes and a local
  heap, h5py's default), as link messages in the object header, or as
  dense link storage (a fractal heap indexed by a v2 B-tree, which the
  netCDF-4 library writes once a group holds more than 8 links);
- datasets that are compact, contiguous or chunked with a v1 B-tree
  chunk index (data layout message version 3), through the deflate
  and shuffle filters; missing chunks and unallocated storage read as
  the fill value;
- fixed-point and IEEE floating-point numbers of either byte order,
  fixed-length strings, and variable-length strings in the global heap;
- attributes in the object header or in dense attribute storage.
Everything else (the chunk indices of data layout version 4, other
filters, shared or committed datatypes, huge fractal-heap objects,
compound, enum, array and reference types, soft and external links)
raises NotImplementedError naming it; nothing reads as zeros instead.
"""

from __future__ import annotations

import os
import struct
import zlib
import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address
SIGNATURE = b"\x89HDF\r\n\x1a\n"
_LOCAL_HEAP_FREE_NULL = 1  # a local heap's empty free list

# message types of an object header
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x00, 0x01, 0x02, 0x03
_FILL_OLD, _FILL, _LINK, _LAYOUT = 0x04, 0x05, 0x06, 0x08
_FILTERS, _ATTRIBUTE, _CONTINUATION = 0x0B, 0x0C, 0x10
_SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x11, 0x15

_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
                 5: "nbit", 6: "scaleoffset"}
_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enum", 10: "array"}
_CHUNK_INDEX_NAMES = {1: "single chunk", 2: "implicit", 3: "fixed array",
                      4: "extensible array", 5: "version 2 B-tree"}


def File(path, mode: str = "r"):
    """An HDF5 file, read (FileNotFoundError where there is none)."""
    if mode != "r":
        raise ValueError(f"HDF5 file mode {mode!r}: only 'r'")
    return ReadFile(path)


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _u(data, pos: int, size: int) -> int:
    return int.from_bytes(data[pos:pos + size], "little")


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & 0xFFFFFFFF


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 hashlittle, the checksum of HDF5's version 2
    metadata (H5_checksum_lookup3)."""
    m = 0xFFFFFFFF
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & m
    if n == 0:
        return c
    pos = 0
    while n - pos > 12:
        x, y, z = struct.unpack_from("<III", data, pos)
        a, b, c = (a + x) & m, (b + y) & m, (c + z) & m
        a = (a - c) & m; a ^= _rot(c, 4); c = (c + b) & m  # noqa: E702
        b = (b - a) & m; b ^= _rot(a, 6); a = (a + c) & m  # noqa: E702
        c = (c - b) & m; c ^= _rot(b, 8); b = (b + a) & m  # noqa: E702
        a = (a - c) & m; a ^= _rot(c, 16); c = (c + b) & m  # noqa: E702
        b = (b - a) & m; b ^= _rot(a, 19); a = (a + c) & m  # noqa: E702
        c = (c - b) & m; c ^= _rot(b, 4); b = (b + a) & m  # noqa: E702
        pos += 12
    x, y, z = struct.unpack("<III", bytes(data[pos:]).ljust(12, b"\0"))
    a, b, c = (a + x) & m, (b + y) & m, (c + z) & m
    c ^= b; c = (c - _rot(b, 14)) & m  # noqa: E702
    a ^= c; a = (a - _rot(c, 11)) & m  # noqa: E702
    b ^= a; b = (b - _rot(a, 25)) & m  # noqa: E702
    c ^= b; c = (c - _rot(b, 16)) & m  # noqa: E702
    a ^= c; a = (a - _rot(c, 4)) & m  # noqa: E702
    b ^= a; b = (b - _rot(a, 14)) & m  # noqa: E702
    c ^= b; c = (c - _rot(b, 24)) & m  # noqa: E702
    return c


# ---------------------------------------------------------------- reader


class _Type:
    """A decoded datatype: kind "int", "float", "string" (fixed length)
    or "vlen_string", its size in the file and its numpy dtype."""

    def __init__(self, kind, size, dtype):
        self.kind, self.size, self.dtype = kind, size, dtype


def _datatype(data, pos: int = 0):
    """(_Type, offset after it) of a datatype message at data[pos:]."""
    cls = data[pos] & 0x0F
    bits = _u(data, pos + 1, 3)
    size = _u(data, pos + 4, 4)
    pos += 8
    if cls == 0:  # fixed-point
        offset, precision = struct.unpack_from("<HH", data, pos)
        if offset != 0 or precision != 8 * size or size not in (1, 2, 4, 8):
            raise NotImplementedError(
                f"HDF5 fixed-point type of {precision} bits at bit {offset} "
                f"in {size} bytes")
        order = ">" if bits & 1 else "<"
        sign = "i" if bits & 8 else "u"
        return _Type("int", size, np.dtype(f"{order}{sign}{size}")), pos + 4
    if cls == 1:  # floating point
        props = struct.unpack_from("<HHBBBBI", data, pos)
        ieee = {2: (0, 16, 10, 5, 0, 10, 15), 4: (0, 32, 23, 8, 0, 23, 127),
                8: (0, 64, 52, 11, 0, 52, 1023)}
        if bits & 0x40 or ieee.get(size) != props:
            raise NotImplementedError(
                f"HDF5 floating-point type of {size} bytes that is not IEEE "
                f"754 in little- or big-endian order (properties {props})")
        order = ">" if bits & 1 else "<"
        return _Type("float", size, np.dtype(f"{order}f{size}")), pos + 12
    if cls == 3:  # fixed-length string
        return _Type("string", size, np.dtype(f"S{size}")), pos
    if cls == 9:  # variable length
        _, pos = _datatype(data, pos)
        if bits & 0x0F != 1:
            raise NotImplementedError("HDF5 variable-length sequence type")
        return _Type("vlen_string", size, np.dtype(object)), pos
    raise NotImplementedError(
        f"HDF5 {_CLASS_NAMES.get(cls, f'class {cls}')} datatype")


def _dataspace(data):
    """(shape, maxshape) of a dataspace message; shape None for a null
    dataspace, () for a scalar."""
    version, rank, flags = data[0], data[1], data[2]
    if version == 1:
        pos = 8
    elif version == 2:
        if data[3] == 2:
            return None, None
        pos = 4
    else:
        raise NotImplementedError(f"HDF5 dataspace message version {version}")
    shape = struct.unpack_from(f"<{rank}Q", data, pos)
    maxshape = shape
    if flags & 1:
        maxshape = tuple(None if m == UNDEF else m for m in
                         struct.unpack_from(f"<{rank}Q", data, pos + 8 * rank))
    return tuple(shape), tuple(maxshape)


def _link(data):
    """(name, object header address or None, link type) of a link
    message."""
    flags, pos, ltype = data[1], 2, 0
    if flags & 0x08:
        ltype = data[pos]
        pos += 1
    if flags & 0x04:
        pos += 8  # creation order
    if flags & 0x10:
        pos += 1  # character set
    nsize = 1 << (flags & 3)
    nlen = _u(data, pos, nsize)
    pos += nsize
    name = bytes(data[pos:pos + nlen]).decode("utf-8")
    addr = _u(data, pos + nlen, 8) if ltype == 0 else None
    return name, addr, ltype


def _attribute(data):
    """(name, datatype bytes, dataspace bytes, raw value) of an attribute
    message."""
    version, flags = data[0], data[1]
    nname, ntype, nspace = struct.unpack_from("<HHH", data, 2)
    if version == 1:
        pos, pad = 8, _pad8
    elif version in (2, 3):
        pos, pad = (8 if version == 2 else 9), (lambda n: n)
    else:
        raise NotImplementedError(f"HDF5 attribute message version {version}")
    if flags & 3:
        raise NotImplementedError(
            "HDF5 attribute with a shared datatype or dataspace")
    name = bytes(data[pos:pos + nname]).split(b"\0", 1)[0].decode("utf-8")
    pos += pad(nname)
    dtype = data[pos:pos + ntype]
    pos += pad(ntype)
    space = data[pos:pos + nspace]
    pos += pad(nspace)
    return name, dtype, space, data[pos:]


def _filters(data):
    """[(filter id, flags, client values)] of a filter pipeline
    message."""
    version, count = data[0], data[1]
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(count):
        fid = _u(data, pos, 2)
        if version == 1 or fid >= 256:
            nname = _u(data, pos + 2, 2)
            flags, nvals = struct.unpack_from("<HH", data, pos + 4)
            pos += 8
        else:
            nname = 0
            flags, nvals = struct.unpack_from("<HH", data, pos + 2)
            pos += 6
        pos += _pad8(nname) if version == 1 else nname
        vals = struct.unpack_from(f"<{nvals}I", data, pos)
        pos += 4 * nvals
        if version == 1 and nvals % 2:
            pos += 4
        out.append((fid, flags, vals))
    return out


def _unfilter(raw: bytes, filters, mask: int, itemsize: int) -> bytes:
    """A chunk as stored, through its filter pipeline in reverse, each
    filter skipped whose bit is set in the chunk's filter mask."""
    for k in range(len(filters) - 1, -1, -1):
        fid = filters[k][0]
        if mask & (1 << k):
            continue
        if fid == 1:
            raw = zlib.decompress(raw)
        elif fid == 2:
            a = np.frombuffer(raw, np.uint8)
            n = len(a) // itemsize
            body = a[: n * itemsize].reshape(itemsize, n).T.reshape(-1)
            raw = body.tobytes() + bytes(a[n * itemsize:])
        else:
            raise NotImplementedError(
                f"HDF5 {_FILTER_NAMES.get(fid, f'filter {fid}')} filter")
    return raw


def _enc_size(n: int) -> int:
    """Bytes that encode counts up to n (H5VM_limit_enc_size)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


class _Source:
    """Reads of an open file at addresses relative to its base
    address."""

    def __init__(self, fh, base: int = 0):
        self.fh, self.base = fh, base

    def read(self, addr: int, n: int) -> bytes:
        if addr == UNDEF:
            raise ValueError("HDF5 structure at the undefined address")
        self.fh.seek(self.base + addr)
        data = self.fh.read(n)
        if len(data) != n:
            raise ValueError(f"HDF5 file ends before byte {addr + n} "
                             f"(at {self.base + addr + len(data)})")
        return data

    def checked(self, addr: int, n: int, what: str) -> bytes:
        """n bytes at addr whose last 4 are the lookup3 checksum of the
        rest."""
        data = self.read(addr, n)
        if lookup3(data[:-4]) != _u(data, n - 4, 4):
            raise ValueError(f"HDF5 {what} at {addr} fails its checksum")
        return data


class _FractalHeap:
    """The managed and tiny objects of a fractal heap (dense link and
    attribute storage)."""

    def __init__(self, src: _Source, addr: int):
        self.src = src
        fixed = 4 + 1 + 2 + 2 + 1 + 4 + 12 * 8 + 2 + 8 + 8 + 2 + 2 + 8 + 2
        hdr = src.read(addr, fixed)
        if hdr[:4] != b"FRHP":
            raise ValueError(f"HDF5 fractal heap expected at {addr}")
        self.id_len, io_len = struct.unpack_from("<HH", hdr, 5)
        max_man = _u(hdr, 10, 4)
        (self.width, self.start, max_direct, max_bits, _, root,
         root_rows) = struct.unpack_from("<HQQHHQH", hdr, 110)
        if io_len:
            raise NotImplementedError("HDF5 fractal heap with I/O filters")
        src.checked(addr, fixed + 4, "fractal heap header")
        self.off_size = (max_bits + 7) // 8
        self.len_size = min(((max_direct.bit_length() - 1) + 7) // 8,
                            _enc_size(max_man))
        self.max_direct_rows = ((max_direct.bit_length() - 1)
                                - (self.start.bit_length() - 1) + 2)
        self.blocks = []  # (heap offset, address, size) of direct blocks
        if root != UNDEF and root_rows == 0:
            self.blocks.append((0, root, self.start))
        elif root != UNDEF:
            self._indirect(root, root_rows)

    def _row_size(self, row: int) -> int:
        return self.start if row == 0 else self.start << (row - 1)

    def _indirect(self, addr: int, nrows: int):
        ndirect = min(nrows, self.max_direct_rows) * self.width
        nindirect = max(nrows - self.max_direct_rows, 0) * self.width
        n = 5 + 8 + self.off_size + 8 * (ndirect + nindirect) + 4
        data = self.src.checked(addr, n, "fractal heap indirect block")
        if data[:4] != b"FHIB":
            raise ValueError(f"HDF5 fractal heap indirect block expected at "
                             f"{addr}")
        offset = _u(data, 13, self.off_size)
        pos = 13 + self.off_size
        for row in range(nrows):
            size = self._row_size(row)
            for _ in range(self.width):
                child = _u(data, pos, 8)
                pos += 8
                if child != UNDEF:
                    if row < self.max_direct_rows:
                        self.blocks.append((offset, child, size))
                    else:
                        rows = ((size.bit_length() - 1)
                                - (self.start.bit_length() - 1)
                                - (self.width.bit_length() - 1) + 1)
                        self._indirect(child, rows)
                offset += size

    def get(self, heap_id: bytes) -> bytes:
        kind = (heap_id[0] >> 4) & 3
        if heap_id[0] >> 6:
            raise NotImplementedError(
                f"HDF5 fractal heap ID version {heap_id[0] >> 6}")
        if kind == 2:  # tiny: the object is in the ID
            if self.id_len <= 18:
                n = (heap_id[0] & 0x0F) + 1
                return bytes(heap_id[1:1 + n])
            n = ((heap_id[0] & 0x0F) << 8 | heap_id[1]) + 1
            return bytes(heap_id[2:2 + n])
        if kind != 0:
            raise NotImplementedError("HDF5 huge fractal heap object")
        off = _u(heap_id, 1, self.off_size)
        n = _u(heap_id, 1 + self.off_size, self.len_size)
        for start, addr, size in self.blocks:
            if start <= off < start + size:
                return self.src.read(addr + off - start, n)
        raise ValueError(f"HDF5 fractal heap offset {off} in no block")


def _btree_v2(src: _Source, addr: int):
    """The records of a version 2 B-tree, in order."""
    hdr = src.checked(addr, 4 + 1 + 1 + 4 + 2 + 2 + 1 + 1 + 8 + 2 + 8 + 4,
                      "v2 B-tree header")
    if hdr[:4] != b"BTHD":
        raise ValueError(f"HDF5 v2 B-tree header expected at {addr}")
    node_size, rec_size, depth = struct.unpack_from("<IHH", hdr, 6)
    root, root_nrec = struct.unpack_from("<QH", hdr, 16)
    leaf_max = (node_size - 10) // rec_size
    nrec_size = _enc_size(leaf_max)
    cum, cum_size = [leaf_max], [0]
    for d in range(1, depth + 1):
        ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        most = (node_size - (10 + ptr)) // (rec_size + ptr)
        cum.append((most + 1) * cum[d - 1] + most)
        cum_size.append(_enc_size(cum[d]))
    out = []

    def walk(node, nrec, d):
        if node == UNDEF or nrec == 0 and d == 0:
            return
        if d == 0:
            data = src.checked(node, 6 + nrec * rec_size + 4, "v2 B-tree leaf")
            out.extend(data[6 + k * rec_size:6 + (k + 1) * rec_size]
                       for k in range(nrec))
            return
        ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        data = src.checked(node, 6 + nrec * rec_size + (nrec + 1) * ptr + 4,
                           "v2 B-tree internal node")
        pos = 6 + nrec * rec_size
        for k in range(nrec + 1):
            child = _u(data, pos, 8)
            walk(child, _u(data, pos + 8, nrec_size), d - 1)
            pos += ptr
            if k < nrec:
                out.append(data[6 + k * rec_size:6 + (k + 1) * rec_size])

    walk(root, root_nrec, depth)
    return out


class ReadFile:
    """An HDF5 file open for reading; its root group's interface."""

    def __init__(self, path):
        self.filename = os.fspath(path)
        self._fh = open(self.filename, "rb")
        try:
            self._src, root = self._superblock()
            self._headers = {}
            self._heaps = {}
            self._root = Group(self, root, "/")
        except BaseException:
            self._fh.close()
            raise

    def _superblock(self):
        if self._fh.read(8) != SIGNATURE:
            raise ValueError(f"{self.filename}: not an HDF5 file (or one "
                             "with a user block)")
        src = _Source(self._fh)
        head = src.read(0, 24)
        version = head[8]
        if version in (0, 1):
            if head[13:15] != b"\x08\x08":
                raise NotImplementedError(
                    f"HDF5 addresses of {head[13]} and lengths of {head[14]} "
                    "bytes")
            pos = 24 + (4 if version == 1 else 0)
            base, _, _, _ = struct.unpack("<QQQQ", src.read(pos, 32))
            entry = src.read(pos + 32, 40)
            root = _u(entry, 8, 8)
        elif version in (2, 3):
            if head[9:11] != b"\x08\x08":
                raise NotImplementedError(
                    f"HDF5 addresses of {head[9]} and lengths of {head[10]} "
                    "bytes")
            data = src.checked(0, 12 + 32 + 4, "superblock")
            base, _, _, root = struct.unpack_from("<QQQQ", data, 12)
        else:
            raise NotImplementedError(f"HDF5 superblock version {version}")
        return _Source(self._fh, base), root

    def _messages(self, addr: int):
        """[(type, flags, data)] of the object header at addr, its
        continuation blocks included."""
        if addr in self._headers:
            return self._headers[addr]
        src = self._src
        out = []
        if src.read(addr, 4) == b"OHDR":
            head = src.read(addr, 6)
            if head[4] != 2:
                raise NotImplementedError(
                    f"HDF5 object header version {head[4]}")
            flags = head[5]
            pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            nsize = 1 << (flags & 3)
            n = _u(src.read(addr + pos, nsize), 0, nsize)
            start = pos + nsize
            data = src.checked(addr, start + n + 4, "object header")
            chunks = [(data, start, start + n)]
            order = 2 if flags & 0x04 else 0
            while chunks:
                data, pos, end = chunks.pop(0)
                while pos + 4 + order <= end:
                    mtype = data[pos]
                    size, mflags = struct.unpack_from("<HB", data, pos + 1)
                    pos += 4 + order
                    body = data[pos:pos + size]
                    pos += size
                    if mtype == _CONTINUATION:
                        caddr, clen = struct.unpack_from("<QQ", body)
                        cont = src.checked(caddr, clen,
                                           "object header continuation")
                        if cont[:4] != b"OCHK":
                            raise ValueError("HDF5 object header "
                                             f"continuation expected at "
                                             f"{caddr}")
                        chunks.append((cont, 4, clen - 4))
                    elif mtype != _NIL:
                        out.append((mtype, mflags, body))
        else:
            head = src.read(addr, 16)
            if head[0] != 1:
                raise NotImplementedError(
                    f"HDF5 object header version {head[0]}")
            n = _u(head, 8, 4)
            chunks = [(addr + 16, n)]
            while chunks:
                caddr, clen = chunks.pop(0)
                data = src.read(caddr, clen)
                pos = 0
                while pos + 8 <= clen:
                    mtype, size, mflags = struct.unpack_from("<HHB", data, pos)
                    body = data[pos + 8:pos + 8 + size]
                    pos += 8 + size
                    if mtype == _CONTINUATION:
                        chunks.append(struct.unpack_from("<QQ", body))
                    elif mtype != _NIL:
                        out.append((mtype, mflags, body))
        self._headers[addr] = out
        return out

    def _local_heap(self, addr: int) -> bytes:
        if addr not in self._heaps:
            head = self._src.read(addr, 32)
            if head[:4] != b"HEAP":
                raise ValueError(f"HDF5 local heap expected at {addr}")
            size, _, data = struct.unpack_from("<QQQ", head, 8)
            self._heaps[addr] = self._src.read(data, size)
        return self._heaps[addr]

    def _global_heap_object(self, addr: int, index: int) -> bytes:
        key = ("global", addr)
        if key not in self._heaps:
            head = self._src.read(addr, 16)
            if head[:4] != b"GCOL":
                raise ValueError(f"HDF5 global heap expected at {addr}")
            coll = self._src.read(addr, _u(head, 8, 8))
            objs, pos = {}, 16
            while pos + 16 <= len(coll):
                idx = _u(coll, pos, 2)
                size = _u(coll, pos + 8, 8)
                if idx == 0:
                    break
                objs[idx] = coll[pos + 16:pos + 16 + size]
                pos += 16 + _pad8(size)
            self._heaps[key] = objs
        return self._heaps[key][index]

    def _btree_v1(self, addr: int, ndims: int = 0):
        """[(key, child)] of a v1 B-tree's leaf level, in order, each key
        the child's left key: a heap offset (group nodes) or (chunk
        bytes, filter mask, chunk offsets) (chunk nodes, ndims offsets
        with the element dimension)."""
        out = []
        if addr == UNDEF:
            return out
        head = self._src.read(addr, 24)
        if head[:4] != b"TREE":
            raise ValueError(f"HDF5 v1 B-tree node expected at {addr}")
        ntype, level, n = struct.unpack_from("<BBH", head, 4)
        ksize = 8 if ntype == 0 else 8 + 8 * ndims
        data = self._src.read(addr + 24, n * (ksize + 8) + ksize)
        for k in range(n):
            pos = k * (ksize + 8)
            if ntype == 0:
                key = _u(data, pos, 8)
            else:
                nbytes, mask = struct.unpack_from("<II", data, pos)
                key = (nbytes, mask,
                       struct.unpack_from(f"<{ndims}Q", data, pos + 8))
            child = _u(data, pos + ksize, 8)
            if level:
                out.extend(self._btree_v1(child, ndims))
            else:
                out.append((key, child))
        return out

    def _object(self, addr: int, name: str):
        types = {m[0] for m in self._messages(addr)}
        if _LAYOUT in types:
            return Dataset(self, addr, name)
        if types & {_SYMBOL_TABLE, _LINK_INFO, _LINK}:
            return Group(self, addr, name)
        raise NotImplementedError(
            f"HDF5 object {name!r} that is neither a group nor a dataset "
            f"(messages {sorted(types)})")

    # the root group's interface
    def __getitem__(self, path):
        return self._root[path]

    def __contains__(self, path):
        return path in self._root

    def keys(self):
        return self._root.keys()

    def __iter__(self):
        return iter(self._root)

    def __len__(self):
        return len(self._root)

    @property
    def attrs(self):
        return self._root.attrs

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Attributes:
    """The attributes of a group or dataset, decoded when read."""

    def __init__(self, file: ReadFile, messages):
        self._file = file
        self._raw = {}
        for mtype, mflags, body in messages:
            if mtype == _ATTRIBUTE:
                self._add(mflags, body)
            elif mtype == _ATTRIBUTE_INFO:
                flags = body[1]
                pos = 2 + (2 if flags & 1 else 0)
                heap_addr, name_tree = struct.unpack_from("<QQ", body, pos)
                if heap_addr != UNDEF:
                    heap = _FractalHeap(file._src, heap_addr)
                    for rec in _btree_v2(file._src, name_tree):
                        self._add(rec[len(rec) - 9], heap.get(
                            rec[:len(rec) - 9]))

    def _add(self, mflags, body):
        if mflags & 2:
            raise NotImplementedError("HDF5 shared attribute message")
        name, dtype, space, raw = _attribute(body)
        self._raw[name] = (dtype, space, raw)

    def keys(self):
        return list(self._raw)

    def __iter__(self):
        return iter(self._raw)

    def __len__(self):
        return len(self._raw)

    def __contains__(self, name):
        return name in self._raw

    def __getitem__(self, name):
        dtype, space, raw = self._raw[name]
        shape, _ = _dataspace(space)
        if shape is None:
            return None
        value = _decode(self._file, _datatype(dtype)[0], raw, shape)
        return value[()] if value.ndim == 0 else value

    def get(self, name, default=None):
        return self[name] if name in self._raw else default


def _decode(file: ReadFile, t: _Type, raw, shape) -> np.ndarray:
    """The array of `shape` that raw bytes of type t hold: numbers in
    the file's byte order (as h5py gives them), fixed-length strings as
    bytes, variable-length strings (global heap references) as str."""
    count = int(np.prod(shape, dtype=np.int64))
    if t.kind == "vlen_string":
        out = np.empty(count, object)
        for k in range(count):
            n, addr, index = struct.unpack_from("<IQI", raw, 16 * k)
            out[k] = file._global_heap_object(addr, index)[:n].decode(
                "utf-8")
        return out.reshape(shape)
    return np.frombuffer(raw, t.dtype, count=count).reshape(shape).copy()


class Group:
    """A group of an HDF5 file open for reading."""

    def __init__(self, file: ReadFile, addr: int, name: str):
        self.file, self._addr, self.name = file, addr, name
        self._links = None

    def _table(self):
        """{name: (object header address or None, link type)}."""
        if self._links is not None:
            return self._links
        f = self.file
        links = {}
        for mtype, _, body in f._messages(self._addr):
            if mtype == _SYMBOL_TABLE:
                tree, heap_addr = struct.unpack_from("<QQ", body)
                heap = f._local_heap(heap_addr)
                for _, snod in f._btree_v1(tree):
                    head = f._src.read(snod, 8)
                    if head[:4] != b"SNOD":
                        raise ValueError(f"HDF5 symbol node expected at "
                                         f"{snod}")
                    n = _u(head, 6, 2)
                    data = f._src.read(snod + 8, 40 * n)
                    for k in range(n):
                        off, addr, cache = struct.unpack_from(
                            "<QQI", data, 40 * k)
                        name = heap[off:heap.index(b"\0", off)].decode(
                            "utf-8")
                        links[name] = (addr, 1 if cache == 2 else 0)
            elif mtype == _LINK:
                name, addr, ltype = _link(body)
                links[name] = (addr, ltype)
            elif mtype == _LINK_INFO:
                flags = body[1]
                pos = 2 + (8 if flags & 1 else 0)
                heap_addr, name_tree = struct.unpack_from("<QQ", body, pos)
                if heap_addr != UNDEF:
                    heap = _FractalHeap(f._src, heap_addr)
                    found = [_link(heap.get(rec[4:]))
                             for rec in _btree_v2(f._src, name_tree)]
                    for name, addr, ltype in sorted(found):
                        links[name] = (addr, ltype)
        self._links = links
        return links

    def _get(self, name: str):
        addr, ltype = self._table()[name]
        if ltype != 0:
            kind = "soft" if ltype == 1 else "external"
            raise NotImplementedError(f"HDF5 {kind} link {name!r}")
        path = self.name.rstrip("/") + "/" + name
        return self.file._object(addr, path)

    def __getitem__(self, path: str):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group):
                raise KeyError(f"{node.name} is not a group")
            if part not in node._table():
                raise KeyError(f"no object {path!r} in {self.name}")
            node = node._get(part)
        return node

    def __contains__(self, path: str):
        try:
            self[path]
        except KeyError:
            return False
        return True

    def keys(self):
        return list(self._table())

    def __iter__(self):
        return iter(self._table())

    def __len__(self):
        return len(self._table())

    @property
    def attrs(self) -> Attributes:
        return Attributes(self.file, self.file._messages(self._addr))


class Dataset:
    """A dataset of an HDF5 file open for reading: its shape, dtype and
    attributes, and the rows that an index selects (only the chunks or
    bytes of those rows are read)."""

    def __init__(self, file: ReadFile, addr: int, name: str):
        self.file, self._addr, self.name = file, addr, name
        msgs = {}
        for mtype, mflags, body in file._messages(addr):
            if mflags & 2 and mtype in (_DATASPACE, _DATATYPE, _LAYOUT,
                                        _FILTERS, _FILL):
                raise NotImplementedError(
                    f"HDF5 shared message (type {mtype}) in {name!r}")
            msgs.setdefault(mtype, body)
        self._msgs = msgs
        self.shape, self.maxshape = _dataspace(msgs[_DATASPACE])
        if self.shape is None:
            raise NotImplementedError(f"HDF5 null dataspace of {name!r}")
        self._type = _datatype(msgs[_DATATYPE])[0]
        self.dtype = self._type.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def __len__(self):
        if not self.shape:
            raise TypeError("a scalar dataset has no length")
        return self.shape[0]

    @property
    def attrs(self) -> Attributes:
        return Attributes(self.file, self.file._messages(self._addr))

    def _fill(self) -> bytes:
        """One element of the fill value, as stored."""
        size = self._type.size
        body = self._msgs.get(_FILL)
        if body is not None:
            version = body[0]
            if version in (1, 2) and body[3] and len(body) >= 8:
                n = _u(body, 4, 4)
                if n == size:
                    return bytes(body[8:8 + n])
            elif version == 3 and body[1] & 0x20:
                n = _u(body, 2, 4)
                if n == size:
                    return bytes(body[6:6 + n])
        elif _FILL_OLD in self._msgs:
            body = self._msgs[_FILL_OLD]
            if _u(body, 0, 4) == size:
                return bytes(body[4:4 + size])
        return bytes(size)

    def _layout(self):
        body = self._msgs[_LAYOUT]
        version, cls = body[0], body[1]
        if version not in (3, 4):
            raise NotImplementedError(
                f"HDF5 data layout message version {version} in "
                f"{self.name!r}")
        if cls == 0:
            n = _u(body, 2, 2)
            return "compact", bytes(body[4:4 + n])
        if cls == 1:
            return "contiguous", struct.unpack_from("<QQ", body, 2)
        if cls == 2 and version == 3:
            ndims = body[2]
            return "chunked", (_u(body, 3, 8),
                               struct.unpack_from(f"<{ndims}I", body, 11))
        if cls == 2:
            ndims, enc = body[3], body[4]
            index = body[5 + ndims * enc]
            raise NotImplementedError(
                "HDF5 data layout version 4 chunk index "
                f"({_CHUNK_INDEX_NAMES.get(index, index)}) in {self.name!r}")
        raise NotImplementedError(f"HDF5 data layout class {cls} in "
                                  f"{self.name!r}")

    def _rows(self, lo: int, hi: int) -> np.ndarray:
        """Rows lo:hi of the dataset (all of a scalar's)."""
        t, shape = self._type, self.shape
        kind, info = self._layout()
        part = shape[1:]
        sub = (hi - lo,) + part if shape else ()
        count = int(np.prod(sub, dtype=np.int64))
        row_bytes = int(np.prod(part, dtype=np.int64)) * t.size
        start = lo * row_bytes if shape else 0
        if kind == "compact":
            raw = info[start:start + count * t.size]
        elif kind == "contiguous":
            addr, _ = info
            if addr == UNDEF:
                raw = self._fill() * count
            else:
                raw = self.file._src.read(addr + start, count * t.size)
        else:
            raw = self._chunked(info, lo, hi)
        return _decode(self.file, t, raw, sub)

    def _chunked(self, info, lo: int, hi: int) -> bytes:
        tree, dims = info
        chunk = dims[:-1]
        t = self._type
        sub = (hi - lo,) + self.shape[1:]
        fill = np.frombuffer(self._fill(), np.uint8)
        out = np.empty(sub + (t.size,), np.uint8)
        out[...] = fill
        filters = (_filters(self._msgs[_FILTERS]) if _FILTERS in self._msgs
                   else [])
        for (nbytes, mask, offs), addr in self.file._btree_v1(
                tree, len(dims)):
            offs = offs[:-1]
            if offs[0] >= hi or offs[0] + chunk[0] <= lo:
                continue
            raw = _unfilter(self.file._src.read(addr, nbytes), filters, mask,
                            t.size)
            need = int(np.prod(chunk, dtype=np.int64)) * t.size
            if len(raw) != need:
                raise ValueError(f"HDF5 chunk at {addr} of {self.name!r} "
                                 f"holds {len(raw)} bytes, not {need}")
            block = np.frombuffer(raw, np.uint8).reshape(chunk + (t.size,))
            src, dst = [], []
            for d, (o, c, n) in enumerate(zip(offs, chunk, self.shape)):
                a, b = (max(o, lo), min(o + c, hi)) if d == 0 else (
                    o, min(o + c, n))
                if a >= b:
                    break
                src.append(slice(a - o, b - o))
                dst.append(slice(a - lo, b - lo) if d == 0 else slice(a, b))
            else:
                out[tuple(dst)] = block[tuple(src)]
        return out.tobytes()

    def __getitem__(self, key):
        if not self.shape:
            if key not in ((), Ellipsis):
                raise IndexError("a scalar dataset takes () or ...")
            return self._rows(0, 0)[()]
        key = key if isinstance(key, tuple) else (key,)
        first, rest = (key[0], key[1:]) if key else (slice(None), ())
        n = self.shape[0]
        if isinstance(first, (int, np.integer)):
            i = int(first) + (n if first < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"row {first} of {n} in {self.name!r}")
            return self._rows(i, i + 1)[(0,) + rest]
        if isinstance(first, slice):
            rows = range(*first.indices(n))
            if not rows:
                return self._rows(0, 0)[(slice(None),) + rest]
            lo, hi = min(rows), max(rows) + 1
            arr = self._rows(lo, hi)
            if rows.step != 1:
                arr = arr[np.asarray(rows) - lo]
            return arr[(slice(None),) + rest]
        return self._rows(0, n)[key]

    def __array__(self, dtype=None, copy=None):
        arr = self[...]
        return arr if dtype is None else arr.astype(dtype)


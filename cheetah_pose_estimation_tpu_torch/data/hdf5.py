"""HDF5 files in HDF5's default ("earliest") file format, read and written
with numpy, ``struct`` and ``zlib`` alone (the port runs without h5py,
PyTables and pandas).

The reader takes what HDF5 writes unless told to use a later format, which
is what PyTables (DeepLabCut's and pandas' ``.h5`` tables) and h5py write
by default:

* superblock versions 0 and 1, any offset and length sizes, a user block;
* version-1 object headers, their continuation blocks and NIL messages;
* groups with a symbol table: B-tree v1 group nodes, symbol table nodes
  and the local heap of names;
* simple and scalar dataspaces;
* datatypes: fixed-point, IEEE floating point in either byte order,
  fixed-length strings, arrays (class 10, versions 2-3) and compounds
  (versions 1-3) with member offsets and padding;
* data layout version 3: compact, contiguous, and chunked with a B-tree v1
  chunk index, partial edge chunks and unallocated chunks (which read as
  the fill value);
* the deflate (1), shuffle (2) and fletcher32 (3, verified) filters;
* attribute messages versions 1-3.

Anything else raises ``NotImplementedError`` naming the feature and its
version, class or filter id (superblocks 2 and 3, version-2 object
headers, link-message groups, dense attribute storage, other chunk indexes,
other datatype classes, other filters): a silent wrong read would be worse.
Attributes are decoded when read, so one of an unsupported type raises only
when it is asked for.

The writer (:func:`write`) writes superblock 0, groups with a symbol table
(at most eight members each), contiguous datasets with a fill value
message, and attributes: the layout of pandas' PyTables "table" format as
the JAX package writes it with h5py (``data/io._write_pandas_h5_table``,
``pipeline/grf_io.save_force_plate_df``), which h5py and the JAX readers
read back exactly.

Reading and writing are host work: set-up and trial IO, no device.
"""
from __future__ import annotations

import math
import struct
import zlib
from typing import Dict, Iterator, List, NamedTuple, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0, 1, 2, 3, 4, 5
_LINK, _EXTERNAL, _LAYOUT, _FILTERS, _ATTRIBUTE = 6, 7, 8, 11, 12
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 16, 17, 21

_CLASS_NAMES = {0: "fixed-point", 1: "floating-point", 2: "time",
                3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enumerated", 9: "variable-length",
                10: "array"}
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
                 5: "nbit", 6: "scale-offset"}
# IEEE layouts: (bit offset, precision, exponent location, exponent size,
# mantissa location, mantissa size, exponent bias), sign bit location
_IEEE = {2: ((0, 16, 10, 5, 0, 10, 15), 15),
         4: ((0, 32, 23, 8, 0, 23, 127), 31),
         8: ((0, 64, 52, 11, 0, 52, 1023), 63)}


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class File:
    """An HDF5 file read whole into memory. ``f["a/b"]`` is a
    :class:`Group` or a :class:`Dataset`; ``f.keys()`` and ``f.attrs`` are
    the root group's. Usable as a context manager (nothing stays open)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._buf = f.read()
        self.path = path
        sb = self._find_superblock()
        b = self._buf
        version = b[sb + 8]
        if version not in (0, 1):
            raise NotImplementedError(
                f"{path}: superblock version {version} (only versions 0 "
                "and 1, HDF5's default file format, are read)")
        self._so, self._sl = b[sb + 13], b[sb + 14]
        if self._so not in (2, 4, 8) or self._sl not in (2, 4, 8):
            raise NotImplementedError(
                f"{path}: offset size {self._so}, length size {self._sl}")
        # addresses count from the superblock, wherever the file says its
        # base is (HDF5 itself does so when a file was moved)
        self._base = sb
        p = sb + 24 + (4 if version == 1 else 0) + 4 * self._so
        # the root group's symbol table entry
        root = self._u(p + self._so, self._so)
        self.root = Group(self, "/", root)

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __getitem__(self, path: str):
        return self.root[path]

    def keys(self) -> List[str]:
        return self.root.keys()

    @property
    def attrs(self) -> "Attributes":
        return self.root.attrs

    # -- byte access --------------------------------------------------------
    def _u(self, p: int, n: int) -> int:
        return int.from_bytes(self._buf[p:p + n], "little")

    def _addr(self, p: int) -> int:
        """The address at byte p, or -1 where it is undefined."""
        a = self._u(p, self._so)
        return -1 if a == (1 << (8 * self._so)) - 1 else a

    def _at(self, addr: int) -> int:
        return self._base + addr

    def _find_superblock(self) -> int:
        p = 0
        while p + 8 <= len(self._buf):
            if self._buf[p:p + 8] == SIGNATURE:
                return p
            p = 512 if p == 0 else 2 * p
        raise ValueError(f"{self.path}: not an HDF5 file (no signature)")

    # -- object headers -----------------------------------------------------
    def _messages(self, addr: int) -> List[Tuple[int, int, int, int]]:
        """(type, flags, data position, size) of every message of the
        object header at ``addr``, continuation blocks followed, NIL
        messages dropped."""
        p = self._at(addr)
        b = self._buf
        if b[p:p + 4] == b"OHDR":
            raise NotImplementedError(
                f"{self.path}: version-2 object header at {addr}")
        if b[p] != 1:
            raise NotImplementedError(
                f"{self.path}: object header version {b[p]} at {addr}")
        blocks = [(p + 16, self._u(p + 8, 4))]
        out = []
        while blocks:
            start, size = blocks.pop(0)
            q, end = start, start + size
            while q + 8 <= end:
                mtype, msize, mflags = struct.unpack_from("<HHB", b, q)
                data = q + 8
                if mtype == _CONTINUATION:
                    blocks.append((self._at(self._addr(data)),
                                   self._u(data + self._so, self._sl)))
                elif mtype != _NIL:
                    out.append((mtype, mflags, data, msize))
                q = data + msize
        return out

    # -- groups -------------------------------------------------------------
    def _heap_data(self, heap: int) -> int:
        p = self._at(heap)
        if self._buf[p:p + 4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {heap}")
        return self._at(self._addr(p + 8 + 2 * self._sl))

    def _name(self, heap_data: int, offset: int) -> str:
        p = heap_data + offset
        return self._buf[p:self._buf.index(b"\0", p)].decode("utf-8")

    def _symbols(self, btree: int, heap_data: int
                 ) -> Iterator[Tuple[str, int, int]]:
        """(name, object header address, cache type) of every entry under a
        group's B-tree node, in name order."""
        p = self._at(btree)
        b, so, sl = self._buf, self._so, self._sl
        if b[p:p + 4] != b"TREE" or b[p + 4] != 0:
            raise ValueError(f"{self.path}: no group B-tree node at {btree}")
        level, used = b[p + 5], self._u(p + 6, 2)
        q = p + 8 + 2 * so + sl              # past the header and key 0
        for _ in range(used):
            child = self._addr(q)
            q += so + sl
            if level > 0:
                yield from self._symbols(child, heap_data)
                continue
            s = self._at(child)
            if b[s:s + 4] != b"SNOD":
                raise ValueError(f"{self.path}: no symbol node at {child}")
            e = s + 8
            for _ in range(self._u(s + 6, 2)):
                yield (self._name(heap_data, self._u(e, sl)),
                       self._addr(e + so), self._u(e + 2 * so, 4))
                e += 2 * so + 24

    # -- datatypes and dataspaces --------------------------------------------
    def _datatype(self, p: int) -> Tuple[np.dtype, int]:
        """The datatype encoded at p as a numpy dtype, and the position
        after it."""
        b = self._buf
        cls, ver = b[p] & 0x0F, b[p] >> 4
        bits = b[p + 1] | (b[p + 2] << 8) | (b[p + 3] << 16)
        size = self._u(p + 4, 4)
        q = p + 8
        if cls == 0:
            offset, prec = struct.unpack_from("<HH", b, q)
            q += 4
            if offset or prec != 8 * size or size not in (1, 2, 4, 8):
                raise NotImplementedError(
                    f"{self.path}: fixed-point datatype of {prec} bits at "
                    f"bit {offset} of {size} bytes")
            dt = np.dtype("<>"[bits & 1] + "ui"[(bits >> 3) & 1] + str(size))
        elif cls == 1:
            if bits & 0x40:
                raise NotImplementedError(
                    f"{self.path}: VAX-order floating-point datatype")
            layout = struct.unpack_from("<HHBBBBI", b, q)
            q += 12
            if size not in _IEEE or (layout, (bits >> 8) & 0xFF) \
                    != _IEEE[size]:
                raise NotImplementedError(
                    f"{self.path}: floating-point datatype of {size} bytes "
                    f"laid out {layout} (not IEEE)")
            dt = np.dtype("<>"[bits & 1] + "f" + str(size))
        elif cls == 3:
            dt = np.dtype(f"S{size}")
        elif cls == 10:
            if ver not in (2, 3):
                raise NotImplementedError(
                    f"{self.path}: array datatype version {ver}")
            nd = b[q]
            q += 4 if ver == 2 else 1
            dims = struct.unpack_from(f"<{nd}I", b, q)
            q += 4 * nd * (2 if ver == 2 else 1)   # v2 adds a permutation
            base, q = self._datatype(q)
            dt = np.dtype((base, dims))
        elif cls == 6:
            if ver not in (1, 2, 3):
                raise NotImplementedError(
                    f"{self.path}: compound datatype version {ver}")
            names, formats, offsets = [], [], []
            off_size = int(math.log2(size)) // 8 + 1 if size else 1
            for _ in range(bits & 0xFFFF):
                end = b.index(b"\0", q)
                names.append(b[q:end].decode("utf-8"))
                q = end + 1 if ver == 3 else q + _pad8(end - q + 1)
                if ver == 3:
                    offsets.append(self._u(q, off_size))
                    q += off_size
                else:
                    offsets.append(self._u(q, 4))
                    q += 4
                dims = ()
                if ver == 1:
                    nd = b[q]
                    dims = struct.unpack_from("<4I", b, q + 12)[:nd]
                    q += 28
                mdt, q = self._datatype(q)
                formats.append(np.dtype((mdt, dims)) if dims else mdt)
            dt = np.dtype({"names": names, "formats": formats,
                           "offsets": offsets, "itemsize": size})
        else:
            raise NotImplementedError(
                f"{self.path}: {_CLASS_NAMES.get(cls, 'unknown')} datatype "
                f"(class {cls})")
        if dt.itemsize != size:
            raise ValueError(f"{self.path}: datatype of {size} bytes read as "
                             f"{dt} ({dt.itemsize} bytes)")
        return dt, q

    def _dataspace(self, p: int) -> Tuple[int, ...]:
        b = self._buf
        ver, nd = b[p], b[p + 1]
        if ver == 1:
            q = p + 8
        elif ver == 2:
            if b[p + 3] == 2:
                raise NotImplementedError(f"{self.path}: null dataspace")
            q = p + 4
        else:
            raise NotImplementedError(
                f"{self.path}: dataspace message version {ver}")
        return tuple(self._u(q + i * self._sl, self._sl) for i in range(nd))


def _message(obj, mtype: int, required: bool = True):
    """(data position, size) of the object's first message of ``mtype``
    (None when it has none and it is not required)."""
    for t, flags, p, n in obj._msgs:
        if t == mtype:
            if flags & 2:
                raise NotImplementedError(
                    f"{obj.file.path}: shared message of type {mtype} in "
                    f"{obj.name}")
            return p, n
    if required:
        raise ValueError(f"{obj.file.path}: {obj.name} has no message of "
                         f"type {mtype}")
    return None


class Attributes:
    """The attributes of an object, decoded when read: ``attrs[name]`` is a
    numpy scalar (scalar dataspace) or array."""

    def __init__(self, obj):
        self._obj = obj
        self._raw = {}
        f = obj.file
        b = f._buf
        for t, flags, p, _ in obj._msgs:
            if t == _ATTRIBUTE_INFO:
                pos = p + 2 + (2 if b[p + 1] & 1 else 0)
                if f._addr(pos) != -1:
                    raise NotImplementedError(
                        f"{f.path}: dense attribute storage in {obj.name}")
            if t != _ATTRIBUTE:
                continue
            ver = b[p]
            if ver not in (1, 2, 3):
                raise NotImplementedError(
                    f"{f.path}: attribute message version {ver} in "
                    f"{obj.name}")
            nlen, tlen, slen = struct.unpack_from("<HHH", b, p + 2)
            if ver > 1 and b[p + 1] & 3:
                raise NotImplementedError(
                    f"{f.path}: attribute with a shared datatype or "
                    f"dataspace in {obj.name}")
            q = p + (9 if ver == 3 else 8)
            name = b[q:q + nlen].split(b"\0", 1)[0].decode("utf-8")
            pad = _pad8 if ver == 1 else (lambda n: n)
            q += pad(nlen)
            self._raw[name] = (q, q + pad(tlen), q + pad(tlen) + pad(slen))

    def keys(self) -> List[str]:
        return list(self._raw)

    def __contains__(self, name: str) -> bool:
        return name in self._raw

    def __getitem__(self, name: str):
        f = self._obj.file
        tp, sp, dp = self._raw[name]
        dt, _ = f._datatype(tp)
        shape = f._dataspace(sp)
        n = int(np.prod(shape, dtype=np.int64))
        arr = np.frombuffer(f._buf, dt, count=n, offset=dp).reshape(shape)
        return arr[()] if shape == () else arr.copy()


class _Object:
    def __init__(self, file: File, name: str, addr: int):
        self.file, self.name, self.addr = file, name, addr
        self._msgs = file._messages(addr)
        self._attrs = None

    @property
    def attrs(self) -> Attributes:
        if self._attrs is None:
            self._attrs = Attributes(self)
        return self._attrs


class Group(_Object):
    """A group with a symbol table; ``g["a/b"]``, ``keys()`` (name
    order), ``in``."""

    def __init__(self, file: File, name: str, addr: int):
        super().__init__(file, name, addr)
        for t, *_ in self._msgs:
            if t in (_LINK_INFO, _LINK):
                raise NotImplementedError(
                    f"{file.path}: group {name} stores its links in link "
                    "messages (HDF5 1.8's format), not a symbol table")
        p, _ = _message(self, _SYMBOL_TABLE)
        self._entries = {
            n: (a, c) for n, a, c in file._symbols(
                file._addr(p), file._heap_data(file._addr(p + file._so)))}

    def keys(self) -> List[str]:
        return list(self._entries)

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str) -> Union["Group", "Dataset"]:
        head, _, rest = path.strip("/").partition("/")
        if head not in self._entries:
            raise KeyError(f"{self.file.path}: no {head!r} in {self.name}")
        addr, cache = self._entries[head]
        name = self.name.rstrip("/") + "/" + head
        if cache == 2 or addr == -1:
            raise NotImplementedError(f"{self.file.path}: soft link {name}")
        types = {t for t, *_ in self.file._messages(addr)}
        obj = (Dataset if _LAYOUT in types else Group)(self.file, name, addr)
        return obj[rest] if rest else obj


class Dataset(_Object):
    """A dataset: ``shape``, ``dtype``, ``chunks``, ``filters``;
    ``ds[...]`` (or any numpy index) reads it."""

    def __init__(self, file: File, name: str, addr: int):
        super().__init__(file, name, addr)
        self.shape = file._dataspace(_message(self, _DATASPACE)[0])
        self.dtype, _ = file._datatype(_message(self, _DATATYPE)[0])
        if _message(self, _EXTERNAL, required=False):
            raise NotImplementedError(
                f"{file.path}: {name} keeps its data in external files")
        p, _ = _message(self, _LAYOUT)
        b = file._buf
        if b[p] != 3:
            raise NotImplementedError(
                f"{file.path}: data layout message version {b[p]} in {name}")
        self.layout = b[p + 1]
        self.chunks = None
        if self.layout == 0:
            self._raw = (p + 4, file._u(p + 2, 2))
        elif self.layout == 1:
            self._raw = (file._addr(p + 2), file._u(p + 2 + file._so,
                                                    file._sl))
        elif self.layout == 2:
            nd = b[p + 2]
            self._btree = file._addr(p + 3)
            dims = struct.unpack_from(f"<{nd}I", b, p + 3 + file._so)
            self.chunks = tuple(dims[:-1])
        else:
            raise NotImplementedError(
                f"{file.path}: data layout class {self.layout} in {name}")
        self.filters = self._filters()

    def _filters(self) -> List[Tuple[int, Tuple[int, ...]]]:
        """(filter id, client data) of the filter pipeline, in the order
        they were applied on write."""
        m = _message(self, _FILTERS, required=False)
        if m is None:
            return []
        f, b = self.file, self.file._buf
        p = m[0]
        ver, n = b[p], b[p + 1]
        if ver not in (1, 2):
            raise NotImplementedError(
                f"{f.path}: filter pipeline message version {ver} in "
                f"{self.name}")
        q = p + (8 if ver == 1 else 2)
        out = []
        for _ in range(n):
            fid = f._u(q, 2)
            q += 2
            nlen = 0
            if ver == 1 or fid >= 256:
                nlen = f._u(q, 2)
                q += 2
            ncd = f._u(q + 2, 2)
            q += 4 + (_pad8(nlen) if ver == 1 else nlen)
            cd = struct.unpack_from(f"<{ncd}I", b, q)
            q += 4 * ncd + (4 if ver == 1 and ncd % 2 else 0)
            if fid not in (1, 2, 3):
                raise NotImplementedError(
                    f"{f.path}: filter {fid} "
                    f"({_FILTER_NAMES.get(fid, 'unregistered')}) in "
                    f"{self.name}")
            out.append((fid, cd))
        return out

    def fill_value(self) -> np.ndarray:
        """The fill value as a 0-d array of the dataset's dtype (zeros
        where the file defines none)."""
        f, b = self.file, self.file._buf
        value = None
        m = _message(self, _FILL, required=False)
        if m is not None:
            p = m[0]
            ver = b[p]
            if ver in (1, 2):
                if ver == 1 or b[p + 3]:
                    value = (p + 8, f._u(p + 4, 4))
            elif ver == 3:
                if b[p + 1] & 0x20:
                    value = (p + 6, f._u(p + 2, 4))
            else:
                raise NotImplementedError(
                    f"{f.path}: fill value message version {ver} in "
                    f"{self.name}")
        else:
            m = _message(self, _FILL_OLD, required=False)
            if m is not None:
                value = (m[0] + 4, f._u(m[0], 4))
        out = np.zeros((), self.dtype)
        if value is not None and value[1] == self.dtype.itemsize:
            out[()] = np.frombuffer(b, self.dtype, 1, value[0])[0]
        return out

    def _unfilter(self, data: bytes, mask: int) -> bytes:
        for i in reversed(range(len(self.filters))):
            if mask >> i & 1:
                continue
            fid, cd = self.filters[i]
            if fid == 1:
                data = zlib.decompress(data)
            elif fid == 2:
                data = _unshuffle(data, cd[0])
            else:
                data = _check_fletcher32(data, self.file.path, self.name)
        return data

    def _chunk_index(self, addr: int
                     ) -> Iterator[Tuple[int, int, Tuple[int, ...], int]]:
        """(stored size, filter mask, element offsets, address) of every
        allocated chunk under a chunk B-tree node."""
        f, b = self.file, self.file._buf
        p = f._at(addr)
        if b[p:p + 4] != b"TREE" or b[p + 4] != 1:
            raise ValueError(f"{f.path}: no chunk B-tree node at {addr} in "
                             f"{self.name}")
        level, used = b[p + 5], f._u(p + 6, 2)
        rank = len(self.shape)
        key = 8 + 8 * (rank + 1)
        q = p + 8 + 2 * f._so
        for _ in range(used):
            size, mask = struct.unpack_from("<II", b, q)
            offsets = struct.unpack_from(f"<{rank}Q", b, q + 8)
            child = f._addr(q + key)
            q += key + f._so
            if level > 0:
                yield from self._chunk_index(child)
            else:
                yield size, mask, offsets, child

    def read(self) -> np.ndarray:
        f = self.file
        n = int(np.prod(self.shape, dtype=np.int64))
        if self.layout == 0 or (self.layout == 1 and self._raw[0] != -1):
            if self._raw[1] < n * self.dtype.itemsize:
                raise ValueError(f"{f.path}: {self.name} stores "
                                 f"{self._raw[1]} bytes for {n} elements")
            pos = self._raw[0] if self.layout == 0 else f._at(self._raw[0])
            return np.frombuffer(f._buf, self.dtype, n, pos) \
                .reshape(self.shape).copy()
        out = np.empty(self.shape, self.dtype)
        out[...] = self.fill_value()
        if self.layout == 1 or self._btree == -1:
            return out
        chunk_n = int(np.prod(self.chunks, dtype=np.int64))
        for size, mask, offsets, addr in self._chunk_index(self._btree):
            p = f._at(addr)
            data = self._unfilter(f._buf[p:p + size], mask)
            if len(data) != chunk_n * self.dtype.itemsize:
                raise ValueError(f"{f.path}: chunk at {offsets} of "
                                 f"{self.name} holds {len(data)} bytes")
            chunk = np.frombuffer(data, self.dtype).reshape(self.chunks)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in
                        zip(offsets, self.chunks, self.shape))
            out[dst] = chunk[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    def __getitem__(self, key):
        return self.read()[key]


def _unshuffle(data: bytes, size: int) -> bytes:
    """Undo the shuffle filter: byte planes back into elements of ``size``
    bytes (a tail shorter than one element stays as stored)."""
    n = len(data) // size
    if size <= 1 or n <= 1:
        return data
    body = np.frombuffer(data, np.uint8, n * size).reshape(size, n)
    return body.T.tobytes() + data[n * size:]


def _fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 checksum (``H5_checksum_fletcher32``): 16-bit
    big-endian words summed in blocks of 360, each sum folded to 16 bits
    after each block and once more at the end."""
    words = np.frombuffer(data, ">u2", len(data) // 2).astype(np.int64)
    if len(data) % 2:
        words = np.append(words, np.int64(data[-1]) << 8)
    sum1 = sum2 = 0
    for a in range(0, len(words), 360):
        w = words[a:a + 360]
        sum2 = (sum2 + len(w) * sum1 + int(np.cumsum(w).sum())) & 0xFFFFFFFF
        sum1 = (sum1 + int(w.sum())) & 0xFFFFFFFF
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return (sum2 << 16) | sum1


def _check_fletcher32(data: bytes, path: str, name: str) -> bytes:
    body, stored = data[:-4], int.from_bytes(data[-4:], "little")
    c = _fletcher32(body)
    # before HDF5 1.6.3 the stored checksum had its bytes swapped in pairs
    swapped = ((c & 0xFF) << 8 | (c >> 8 & 0xFF)) << 16 \
        | (c >> 16 & 0xFF) << 8 | c >> 24
    if stored not in (c, swapped):
        raise ValueError(f"{path}: fletcher32 checksum of a chunk of {name} "
                         f"is {stored:#010x}, computed {c:#010x}")
    return body


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class H5Dataset(NamedTuple):
    """A dataset to write: ``data`` (any numpy array of fixed-size
    fields), stored contiguously, and its attributes."""
    data: np.ndarray
    attrs: Dict[str, object] = {}


class H5Group(NamedTuple):
    """A group to write: its members (at most eight) and attributes."""
    members: Dict[str, Union["H5Group", H5Dataset]]
    attrs: Dict[str, object] = {}


_UNDEF = b"\xff" * 8
_GROUP_LEAF_K, _GROUP_NODE_K = 4, 16        # HDF5's defaults
_BTREE_SIZE = 24 + (2 * _GROUP_NODE_K + 1) * 8 + 2 * _GROUP_NODE_K * 8
_SNOD_SIZE = 8 + 2 * _GROUP_LEAF_K * 40


def _encode_dtype(dt: np.dtype) -> bytes:
    """The datatype message of a numpy dtype (version 1; an array member
    as an array datatype, version 2, inside a version-2 compound)."""
    if dt.subdtype is not None:
        base, dims = dt.subdtype
        props = struct.pack("<B3x", len(dims)) \
            + struct.pack(f"<{len(dims)}I", *dims) \
            + struct.pack(f"<{len(dims)}I", *range(len(dims)))
        return struct.pack("<B3sI", 0x2A, b"\0\0\0", dt.itemsize) + props \
            + _encode_dtype(base)
    big = int(dt.byteorder == ">"
              or (dt.byteorder == "=" and struct.pack("=H", 1)[0] == 0))
    if dt.kind in "iu":
        return struct.pack("<BBHIHH", 0x10, big | (dt.kind == "i") << 3, 0,
                           dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in _IEEE:
        layout, sign = _IEEE[dt.itemsize]
        return struct.pack("<BBBBI", 0x11, big | 0x20, sign, 0,
                           dt.itemsize) + struct.pack("<HHBBBBI", *layout)
    if dt.kind == "S":
        # null-padded ASCII, as h5py writes numpy byte strings
        return struct.pack("<BBHI", 0x13, 1, 0, dt.itemsize)
    if dt.names:
        fields = [(n,) + dt.fields[n][:2] for n in dt.names]
        ver = 2 if any(f.subdtype is not None for _, f, _ in fields) else 1
        members = b""
        for name, fdt, off in fields:
            raw = name.encode("utf-8") + b"\0"
            members += raw.ljust(_pad8(len(raw)), b"\0") \
                + struct.pack("<I", off) \
                + (b"\0" * 28 if ver == 1 else b"") + _encode_dtype(fdt)
        return struct.pack("<BHxI", 0x06 | ver << 4, len(fields),
                           dt.itemsize) + members
    raise TypeError(f"no HDF5 datatype is written for {dt}")


def _encode_space(shape: Tuple[int, ...]) -> bytes:
    return struct.pack("<BBB5x", 1, len(shape), 0) \
        + b"".join(struct.pack("<Q", d) for d in shape)


def _message_bytes(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = data.ljust(_pad8(len(data)), b"\0")
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _attr_value(name: str, value) -> np.ndarray:
    if isinstance(value, (bytes, np.bytes_)):
        return np.array(value, dtype=f"S{max(len(value), 1)}")
    if isinstance(value, (np.ndarray, np.generic, int, float)):
        arr = np.asarray(value)
        if arr.dtype.kind in "OUV" and not arr.dtype.names:
            raise TypeError(f"attribute {name}: {arr.dtype} is not written "
                            "(pass byte strings)")
        return arr
    raise TypeError(f"attribute {name}: {type(value).__name__} is not "
                    "written (pass numpy values or bytes)")


def _attribute_message(name: str, value) -> bytes:
    arr = _attr_value(name, value)
    raw = name.encode("utf-8") + b"\0"
    dt, sp = _encode_dtype(arr.dtype), _encode_space(arr.shape)
    body = struct.pack("<BxHHH", 1, len(raw), len(dt), len(sp)) \
        + raw.ljust(_pad8(len(raw)), b"\0") + dt.ljust(_pad8(len(dt)), b"\0") \
        + sp.ljust(_pad8(len(sp)), b"\0") + arr.tobytes()
    return _message_bytes(_ATTRIBUTE, body)


def _header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BxHII4x", 1, len(messages), 1, len(body)) + body


class _Writer:
    def __init__(self):
        self.buf = bytearray(96)             # the superblock, filled last

    def alloc(self, n: int) -> int:
        addr = len(self.buf)
        self.buf += b"\0" * _pad8(n)
        return addr

    def put(self, addr: int, data: bytes) -> None:
        self.buf[addr:addr + len(data)] = data

    def dataset(self, ds: H5Dataset) -> int:
        data = np.asarray(ds.data)
        raw = data.tobytes()
        # fill value version 2: allocated late, written if set, the default
        fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)
        attrs = [_attribute_message(k, v) for k, v in ds.attrs.items()]

        def header(data_addr: int) -> bytes:
            layout = struct.pack("<BB", 3, 1) + (
                struct.pack("<Q", data_addr) if data_addr >= 0 else _UNDEF) \
                + struct.pack("<Q", len(raw))
            return _header([
                _message_bytes(_DATASPACE, _encode_space(data.shape)),
                _message_bytes(_DATATYPE, _encode_dtype(data.dtype), 1),
                _message_bytes(_FILL, fill, 1),
                _message_bytes(_LAYOUT, layout)] + attrs)

        addr = self.alloc(len(header(-1)))
        data_addr = self.alloc(len(raw)) if raw else -1
        self.put(addr, header(data_addr))
        if raw:
            self.put(data_addr, raw)
        return addr

    def group(self, g: H5Group) -> Tuple[int, int, int]:
        """Write a group; returns (object header, B-tree, local heap)
        addresses."""
        names = sorted(g.members, key=lambda n: n.encode("utf-8"))
        if len(names) > 2 * _GROUP_LEAF_K:
            raise ValueError(f"a group of {len(names)} members: at most "
                             f"{2 * _GROUP_LEAF_K} are written")
        heap, offsets = bytearray(8), []
        for n in names:
            offsets.append(len(heap))
            raw = n.encode("utf-8") + b"\0"
            heap += raw.ljust(_pad8(len(raw)), b"\0")
        attrs = [_attribute_message(k, v) for k, v in g.attrs.items()]

        def header(btree: int, heap: int) -> bytes:
            return _header([_message_bytes(
                _SYMBOL_TABLE, struct.pack("<QQ", btree, heap))] + attrs)

        addr = self.alloc(len(header(0, 0)))
        btree, heap_hdr = self.alloc(_BTREE_SIZE), self.alloc(32)
        heap_data = self.alloc(len(heap))
        snod = self.alloc(_SNOD_SIZE)
        self.put(addr, header(btree, heap_hdr))
        # no free block in the heap: HDF5's on-disk end of the free list
        self.put(heap_hdr, b"HEAP\0\0\0\0" + struct.pack(
            "<QQQ", len(heap), 1, heap_data))
        self.put(heap_data, bytes(heap))
        self.put(btree, b"TREE" + struct.pack("<BBH", 0, 0, 1) + _UNDEF
                 + _UNDEF + struct.pack("<QQQ", 0, snod,
                                        offsets[-1] if names else 0))
        entries = b""
        for n, off in zip(names, offsets):
            m = g.members[n]
            if isinstance(m, H5Group):
                a, bt, hp = self.group(m)
                entries += struct.pack("<QQI4xQQ", off, a, 1, bt, hp)
            else:
                entries += struct.pack("<QQI4x16x", off, self.dataset(m), 0)
        self.put(snod, b"SNOD" + struct.pack("<BxH", 1, len(names))
                 + entries)
        return addr, btree, heap_hdr


def write(path: str, root: H5Group) -> None:
    """Write ``root`` (its members and attributes) as an HDF5 file:
    superblock 0, 8-byte offsets and lengths, symbol-table groups,
    contiguous datasets."""
    w = _Writer()
    addr, btree, heap = w.group(root)
    w.put(0, SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
          + struct.pack("<HHI", _GROUP_LEAF_K, _GROUP_NODE_K, 0)
          + struct.pack("<Q", 0) + _UNDEF + struct.pack("<Q", len(w.buf))
          + _UNDEF + struct.pack("<QQI4xQQ", 0, addr, 1, btree, heap))
    with open(path, "wb") as f:
        f.write(bytes(w.buf))

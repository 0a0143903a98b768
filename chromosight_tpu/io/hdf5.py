"""Reader and writer for the subset of HDF5 that .cool files use.

Built on numpy and zlib alone, so the IO layer needs no HDF5 library.

Reads:
  * superblocks v0-v3 and object headers v1-v2;
  * groups held in a symbol table (what HDF5 writes by default) or in
    compact link messages;
  * contiguous, compact and chunked datasets (v1 B-tree index), with
    the deflate, shuffle and fletcher32 filters;
  * integer, float, fixed-length string, enum and variable-length string
    types, in datasets and in attributes stored in the object header.

Writes: a superblock v0 file of symbol-table groups, contiguous datasets
and attributes (numbers, arrays of numbers, fixed-length byte strings,
variable-length UTF-8 strings): the layout HDF5 itself writes by default,
which h5py and cooler read.

Edits: adds or replaces one dataset of a symbol-table group in place,
appending it and patching the group (:func:`store_dataset`).

Anything outside that subset raises ``NotImplementedError`` naming it.
The on-disk format is described in the HDF5 File Format Specification,
version 3.0.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF
SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_MSG_DATASPACE = 0x01
_MSG_LINK_INFO = 0x02
_MSG_DATATYPE = 0x03
_MSG_FILL = 0x05
_MSG_LINK = 0x06
_MSG_LAYOUT = 0x08
_MSG_FILTERS = 0x0B
_MSG_ATTRIBUTE = 0x0C
_MSG_CONTINUATION = 0x10
_MSG_SYMBOL_TABLE = 0x11
_MSG_ATTRIBUTE_INFO = 0x15

_FILTER_DEFLATE, _FILTER_SHUFFLE, _FILTER_FLETCHER32 = 1, 2, 3


class _VLenStr:
    """Marker for the variable-length string datatype (16 bytes on disk:
    length, global heap collection address, object index)."""

    itemsize = 16


VLEN_STR = _VLenStr()


def _pad8(b):
    return b + b"\0" * (-len(b) % 8)


# --------------------------------------------------------------------- #
# Reading
# --------------------------------------------------------------------- #
def _parse_dtype(b):
    """numpy dtype (or VLEN_STR) of a datatype message."""
    cls = b[0] & 0x0F
    bits = b[1] | (b[2] << 8)
    size = struct.unpack_from("<I", b, 4)[0]
    order = ">" if bits & 1 else "<"
    if cls == 0:
        return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1:
        return np.dtype(f"{order}f{size}")
    if cls == 3:
        return np.dtype(f"S{size}")
    if cls == 8:  # enum: the values are stored as its base integer type
        return _parse_dtype(b[8:])
    if cls == 9 and bits & 0x0F == 1:
        return VLEN_STR
    raise NotImplementedError(f"HDF5 datatype class {cls}")


def _parse_dataspace(b):
    """Shape tuple of a dataspace message; None for a null dataspace."""
    version, rank = b[0], b[1]
    if version == 1:
        pos = 8
    elif version == 2:
        if b[3] == 2:
            return None
        pos = 4
    else:
        raise NotImplementedError(f"HDF5 dataspace message v{version}")
    return tuple(struct.unpack_from(f"<{rank}Q", b, pos))


class _Layout:
    """Where a dataset's elements live: ``kind`` is "compact" (``data``),
    "contiguous" (``addr``) or "chunked" (``addr`` of the v1 B-tree,
    ``chunk`` shape)."""

    def __init__(self, b):
        version = b[0]
        if version in (1, 2):
            ndims, cls = b[1], b[2]
            pos = 8
            if cls != 0:
                self.addr = struct.unpack_from("<Q", b, pos)[0]
                pos += 8
            dims = struct.unpack_from(f"<{ndims}I", b, pos)
            pos += 4 * ndims
            if cls == 0:
                n = struct.unpack_from("<I", b, pos)[0]
                self.data = bytes(b[pos + 4 : pos + 4 + n])
            elif cls == 2:
                self.chunk = dims
        elif version in (3, 4):
            cls = b[1]
            if cls == 0:
                n = struct.unpack_from("<H", b, 2)[0]
                self.data = bytes(b[4 : 4 + n])
            elif cls == 1:
                self.addr = struct.unpack_from("<Q", b, 2)[0]
            elif cls == 2 and version == 3:
                ndims = b[2]
                self.addr = struct.unpack_from("<Q", b, 3)[0]
                # the last dimension is the element size
                self.chunk = struct.unpack_from(f"<{ndims}I", b, 11)[:-1]
            else:
                raise NotImplementedError(
                    f"HDF5 layout message v{version} class {cls} (chunk "
                    "indexes of files written with libver='latest')"
                )
        else:
            raise NotImplementedError(f"HDF5 layout message v{version}")
        self.kind = ("compact", "contiguous", "chunked")[cls]


def _parse_filters(b):
    """[(filter id, client data)] of a filter pipeline message."""
    version, nfilters = b[0], b[1]
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(nfilters):
        fid = struct.unpack_from("<H", b, pos)[0]
        pos += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len = struct.unpack_from("<H", b, pos)[0]
            pos += 2
        _flags, nvals = struct.unpack_from("<HH", b, pos)
        pos += 4
        pos += (name_len + 7) // 8 * 8 if version == 1 else name_len
        vals = struct.unpack_from(f"<{nvals}I", b, pos)
        pos += 4 * nvals
        if version == 1 and nvals % 2:
            pos += 4
        if fid not in (_FILTER_DEFLATE, _FILTER_SHUFFLE, _FILTER_FLETCHER32):
            raise NotImplementedError(f"HDF5 filter id {fid}")
        out.append((fid, vals))
    return out


def _unfilter(raw, filters, mask, itemsize):
    """Undo a chunk's filter pipeline (applied in order when written)."""
    for i in reversed(range(len(filters))):
        if mask & (1 << i):
            continue
        fid, _vals = filters[i]
        if fid == _FILTER_DEFLATE:
            raw = zlib.decompress(raw)
        elif fid == _FILTER_FLETCHER32:
            raw = raw[:-4]
        elif fid == _FILTER_SHUFFLE and itemsize > 1:
            n = len(raw) // itemsize
            head = np.frombuffer(raw, np.uint8, n * itemsize)
            raw = head.reshape(itemsize, n).T.tobytes() + raw[n * itemsize :]
    return raw


class File:
    """Read-only handle on an HDF5 file; ``f["a/b"]`` returns a
    :class:`Group` or :class:`Dataset`.  Reads use ``os.pread``, so one
    handle may be shared by threads."""

    def __init__(self, path):
        self.path = str(path)
        self._fd = os.open(self.path, os.O_RDONLY)
        self._gheaps = {}
        try:
            self._read_superblock()
        except BaseException:
            os.close(self._fd)
            raise

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getitem__(self, path):
        return self.root[path]

    @property
    def attrs(self):
        return self.root.attrs

    def read_into(self, addr, buf):
        """Fill the writable uint8 array ``buf`` from ``addr``."""
        view, pos = memoryview(buf), 0
        while pos < len(view):
            got = os.preadv(self._fd, [view[pos:]], self._base + addr + pos)
            if got <= 0:
                raise OSError(f"{self.path}: truncated HDF5 file")
            pos += got

    def read(self, addr, n):
        b = os.pread(self._fd, n, self._base + addr)
        if len(b) != n:
            raise OSError(f"{self.path}: truncated HDF5 file")
        return b

    def _read_superblock(self):
        size = os.fstat(self._fd).st_size
        sb_pos = 0
        while os.pread(self._fd, 8, sb_pos) != SIGNATURE:
            sb_pos = 512 if sb_pos == 0 else sb_pos * 2
            if sb_pos >= size:
                raise OSError(f"{self.path}: not an HDF5 file")
        self._base = 0
        head = self.read(sb_pos, 96)
        version = head[8]
        if version in (0, 1):
            offsets, lengths = head[13], head[14]
            pos = 24 if version == 0 else 28
        elif version in (2, 3):
            offsets, lengths = head[9], head[10]
            pos = 12
        else:
            raise NotImplementedError(f"HDF5 superblock v{version}")
        if (offsets, lengths) != (8, 8):
            raise NotImplementedError("HDF5 offsets or lengths not 8 bytes")
        self._base = struct.unpack_from("<Q", head, pos)[0]
        self.superblock = {
            "version": version,
            "eof_at": sb_pos + pos + 16,  # file offset of the EOF address
            "eof": struct.unpack_from("<Q", head, pos + 16)[0],
            "leaf_k": struct.unpack_from("<H", head, 16)[0],
            "node_k": struct.unpack_from("<H", head, 18)[0],
        }
        if version in (0, 1):
            # base, free space, EOF, driver, then the root symbol table
            # entry: link name offset, object header address
            root = struct.unpack_from("<Q", head, pos + 32 + 8)[0]
        else:
            # base, superblock extension, EOF, root object header address
            root = struct.unpack_from("<Q", head, pos + 24)[0]
        self.root = Group(self, root, "/")

    # ---- object headers ---- #
    def messages(self, addr):
        """[(type, body)] of the object header at ``addr``."""
        if self.read(addr, 4) == b"OHDR":
            return self._messages_v2(addr)
        version, _, nmsgs, _, size = struct.unpack("<BBHII", self.read(addr, 12))
        if version != 1:
            raise NotImplementedError(f"HDF5 object header v{version}")
        blocks, out = [(addr + 16, size)], []
        while blocks:
            start, length = blocks.pop(0)
            data = self.read(start, length)
            pos = 0
            while pos + 8 <= length:
                mtype, msize, mflags = struct.unpack_from("<HHB", data, pos)
                body = data[pos + 8 : pos + 8 + msize]
                pos += 8 + msize
                self._collect(mtype, mflags, body, blocks, out, v2=False)
        return out

    def _messages_v2(self, addr):
        head = self.read(addr, 34)
        flags = head[5]
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        size = int.from_bytes(head[pos : pos + width], "little")
        pos += width
        blocks, out = [(addr + pos, size)], []
        hdr = 6 if flags & 0x04 else 4
        while blocks:
            start, length = blocks.pop(0)
            data = self.read(start, length)
            pos = 4 if data[:4] == b"OCHK" else 0
            end = length - 4 if pos else length
            while pos + hdr <= end:
                mtype, msize, mflags = struct.unpack_from("<BHB", data, pos)
                body = data[pos + hdr : pos + hdr + msize]
                pos += hdr + msize
                self._collect(mtype, mflags, body, blocks, out, v2=True)
        return out

    @staticmethod
    def _collect(mtype, mflags, body, blocks, out, v2):
        if mtype == _MSG_CONTINUATION:
            off, ln = struct.unpack_from("<QQ", body)
            # a v2 continuation block's length counts its "OCHK" signature
            # and checksum, which _messages_v2 skips
            blocks.append((off, ln))
        elif mtype:
            if mflags & 0x02:
                raise NotImplementedError("HDF5 shared (committed) messages")
            out.append((mtype, body))

    # ---- global heap (variable-length data) ---- #
    def gheap_object(self, addr, index):
        objs = self._gheaps.get(addr)
        if objs is None:
            head = self.read(addr, 16)
            if head[:4] != b"GCOL":
                raise OSError(f"{self.path}: bad global heap at {addr}")
            size = struct.unpack_from("<Q", head, 8)[0]
            data = self.read(addr, size)
            objs, pos = {}, 16
            while pos + 16 <= size:
                idx, _ref, osize = struct.unpack_from("<HH4xQ", data, pos)
                if idx == 0:
                    break
                objs[idx] = data[pos + 16 : pos + 16 + osize]
                pos += 16 + (osize + 7) // 8 * 8
            self._gheaps[addr] = objs
        return objs[index]

    def decode_vlen_str(self, raw, shape):
        n = len(raw) // 16
        vals = []
        for k in range(n):
            length, addr, idx = struct.unpack_from("<IQI", raw, 16 * k)
            s = self.gheap_object(addr, idx)[:length] if length else b""
            vals.append(s.decode("utf-8"))
        if shape == ():
            return vals[0]
        arr = np.empty(n, dtype=object)
        arr[:] = vals
        return arr.reshape(shape)


def _attributes(f, msgs):
    attrs = {}
    for mtype, b in msgs:
        if mtype == _MSG_ATTRIBUTE_INFO:
            flags = b[1]
            heap = struct.unpack_from("<Q", b, 2 + (2 if flags & 1 else 0))[0]
            if heap != UNDEF:
                raise NotImplementedError("HDF5 dense attribute storage")
        if mtype != _MSG_ATTRIBUTE:
            continue
        version = b[0]
        name_len, dt_len, ds_len = struct.unpack_from("<HHH", b, 2)
        pos = 8 if version < 3 else 9

        def take(n):
            nonlocal pos
            start = pos
            pos += (n + 7) // 8 * 8 if version == 1 else n
            return b[start : start + n]

        name = take(name_len).rstrip(b"\0").decode("utf-8")
        dtype = _parse_dtype(take(dt_len))
        shape = _parse_dataspace(take(ds_len))
        if shape is None:
            attrs[name] = None
            continue
        count = int(np.prod(shape))
        raw = b[pos : pos + count * dtype.itemsize]
        if dtype is VLEN_STR:
            attrs[name] = f.decode_vlen_str(raw, shape)
            continue
        val = np.frombuffer(raw, dtype).reshape(shape)
        if dtype.kind == "S":
            val = np.char.decode(val.astype(f"S{dtype.itemsize}"), "utf-8")
        attrs[name] = val[()] if shape == () else val.copy()
    return attrs




def _btree_leaves(f, root, key_size):
    """[(key bytes, child address)] of the leaf entries of a v1 B-tree;
    each entry's key is the one preceding its child."""
    out, stack = [], [root]
    while stack:
        addr = stack.pop()
        node = f.read(addr, 24)
        if node[:4] != b"TREE":
            raise OSError(f"{f.path}: bad B-tree node at {addr}")
        level, used = node[5], struct.unpack_from("<H", node, 6)[0]
        step = key_size + 8
        body = f.read(addr + 24, used * step + key_size)
        for k in range(used):
            key = body[k * step : k * step + key_size]
            child = struct.unpack_from("<Q", body, k * step + key_size)[0]
            if level:
                stack.append(child)
            else:
                out.append((key, child))
    return out


class Group:
    """A group: ``g["a/b"]``, ``name in g``, ``g.keys()``, ``g.attrs``."""

    def __init__(self, f, addr, name, msgs=None):
        self.file = f
        self.name = name
        msgs = f.messages(addr) if msgs is None else msgs
        self.attrs = _attributes(f, msgs)
        self._links = {}
        self.symbol_table = None  # (B-tree, local heap) addresses
        for mtype, b in msgs:
            if mtype == _MSG_SYMBOL_TABLE:
                self.symbol_table = struct.unpack_from("<QQ", b)
                self._symbol_table(*self.symbol_table)
            elif mtype == _MSG_LINK:
                self._link_message(b)
            elif mtype == _MSG_LINK_INFO:
                flags = b[1]
                heap = struct.unpack_from("<Q", b, 2 + (8 if flags & 1 else 0))
                if heap[0] != UNDEF:
                    raise NotImplementedError("HDF5 dense link storage")

    def _symbol_table(self, btree, heap):
        f = self.file
        hh = f.read(heap, 32)
        if hh[:4] != b"HEAP":
            raise OSError(f"{f.path}: bad local heap at {heap}")
        seg_size, _free, seg_addr = struct.unpack_from("<QQQ", hh, 8)
        names = f.read(seg_addr, seg_size)
        for _key, snod in _btree_leaves(f, btree, 8):
            head = f.read(snod, 8)
            if head[:4] != b"SNOD":
                raise OSError(f"{f.path}: bad symbol table node at {snod}")
            nsym = struct.unpack_from("<H", head, 6)[0]
            data = f.read(snod + 8, 40 * nsym)
            for k in range(nsym):
                off, ohdr = struct.unpack_from("<QQ", data, 40 * k)
                end = names.index(b"\0", off)
                self._links[names[off:end].decode("utf-8")] = ohdr

    def _link_message(self, b):
        flags, pos, ltype = b[1], 2, 0
        if flags & 0x08:
            ltype = b[pos]
            pos += 1
        pos += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        n = int.from_bytes(b[pos : pos + width], "little")
        pos += width
        name = bytes(b[pos : pos + n]).decode("utf-8")
        if ltype == 0:  # hard link; soft and external links are skipped
            self._links[name] = struct.unpack_from("<Q", b, pos + n)[0]

    def keys(self):
        return list(self._links)

    def __iter__(self):
        return iter(self._links)

    def __contains__(self, path):
        head, _, rest = path.strip("/").partition("/")
        if head not in self._links:
            return False
        if not rest:
            return True
        child = self[head]
        return isinstance(child, Group) and rest in child

    def __getitem__(self, path):
        path = path.strip("/")
        if not path:
            return self
        head, _, rest = path.partition("/")
        if head not in self._links:
            raise KeyError(f"{head!r} not in group {self.name!r}")
        name = self.name.rstrip("/") + "/" + head
        addr = self._links[head]
        msgs = self.file.messages(addr)
        if any(t == _MSG_LAYOUT for t, _ in msgs):
            if rest:
                raise KeyError(f"{name!r} is a dataset")
            return Dataset(self.file, msgs, name)
        return Group(self.file, addr, name, msgs)[rest]


class Dataset:
    """A dataset: ``shape``, ``dtype``, ``attrs``; ``ds[()]`` or ``ds[:]``
    reads it whole, ``ds[lo:hi]`` reads rows ``lo:hi`` (reading only the
    chunks they touch)."""

    def __init__(self, f, msgs, name):
        self.file = f
        self.name = name
        self.attrs = _attributes(f, msgs)
        self._filters = []
        for mtype, b in msgs:
            if mtype == _MSG_DATASPACE:
                self.shape = _parse_dataspace(b) or ()
            elif mtype == _MSG_DATATYPE:
                self._dtype = _parse_dtype(b)
            elif mtype == _MSG_LAYOUT:
                self._layout = _Layout(b)
            elif mtype == _MSG_FILTERS:
                self._filters = _parse_filters(b)

    @property
    def dtype(self):
        if self._dtype is VLEN_STR:
            return np.dtype(object)
        return self._dtype.newbyteorder("=")

    def __getitem__(self, key):
        if key is Ellipsis or (isinstance(key, tuple) and not key):
            key = slice(None)
        if not isinstance(key, slice):
            raise TypeError("only slices along the first axis are supported")
        if not self.shape:  # scalar
            return self._read(0, 1).reshape(())[()]
        lo, hi, step = key.indices(self.shape[0])
        if step < 0:
            raise TypeError("negative steps are not supported")
        out = self._read(lo, max(hi, lo))
        return out if step == 1 else out[::step]

    def _read(self, lo, hi):
        """Rows [lo, hi) as a writable native-order array."""
        dt = self._dtype
        inner = tuple(self.shape[1:])
        row = int(np.prod(inner, dtype=np.int64)) * dt.itemsize
        lay = self._layout
        n = max(hi - lo, 0)
        if lay.kind == "chunked":
            raw = self._read_chunked(lo, hi, dt, inner)
        else:
            raw = np.zeros(n * row, np.uint8)
            if lay.kind == "compact":
                raw[:] = np.frombuffer(lay.data, np.uint8)[lo * row : hi * row]
            elif n and lay.addr != UNDEF:
                self.file.read_into(lay.addr + lo * row, raw)
        if dt is VLEN_STR:
            return self.file.decode_vlen_str(raw.tobytes(), (n,) + inner)
        arr = raw.view(dt).reshape((n,) + inner)
        return arr if dt.isnative else arr.astype(dt.newbyteorder("="))

    def _read_chunked(self, lo, hi, dt, inner):
        """Rows [lo, hi) of a chunked dataset as raw bytes (uint8)."""
        chunk = tuple(self._layout.chunk)
        rank = len(self.shape)
        out = np.zeros((max(hi - lo, 0),) + inner + (dt.itemsize,), np.uint8)
        key_size = 8 + 8 * (rank + 1)
        for key, addr in _btree_leaves(self.file, self._layout.addr, key_size):
            size, mask = struct.unpack_from("<II", key)
            offs = struct.unpack_from(f"<{rank}Q", key, 8)
            a, b = max(lo, offs[0]), min(hi, offs[0] + chunk[0])
            if a >= b:
                continue
            raw = _unfilter(
                self.file.read(addr, size), self._filters, mask, dt.itemsize
            )
            block = np.frombuffer(raw, np.uint8).reshape(chunk + (dt.itemsize,))
            src = [slice(a - offs[0], b - offs[0])]
            dst = [slice(a - lo, b - lo)]
            for ax in range(1, rank):
                m = min(self.shape[ax], offs[ax] + chunk[ax]) - offs[ax]
                src.append(slice(0, m))
                dst.append(slice(offs[ax], offs[ax] + m))
            out[tuple(dst)] = block[tuple(src)]
        return out.reshape(-1)


# --------------------------------------------------------------------- #
# Writing
# --------------------------------------------------------------------- #
class Tree(dict):
    """A group to write: names map to nested Trees, arrays, or
    ``(array, attrs)`` pairs; ``attrs`` holds the group's attributes."""

    def __init__(self, *args, attrs=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.attrs = dict(attrs or {})


# Symbol-table nodes are written at their full allocated size, which
# readers compute from these (superblock-recorded) constants.
_LEAF_K = 32
_NODE_K = 16
_SNOD_SIZE = 8 + 2 * _LEAF_K * 40
_TREE_SIZE = 24 + (2 * _NODE_K + 1) * 8 + 2 * _NODE_K * 8
_GCOL_MIN = 4096


def _dtype_message(dt):
    if dt is VLEN_STR:
        # class 9, string, null-terminated UTF-8, over unsigned bytes
        return struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + _dtype_message(
            np.dtype("u1")
        )
    dt = np.dtype(dt)
    if dt.kind in "iu":
        return struct.pack(
            "<BBBBIHH", 0x10, 0x08 if dt.kind == "i" else 0, 0, 0,
            dt.itemsize, 0, 8 * dt.itemsize,
        )
    if dt.kind == "f" and dt.itemsize in (4, 8):
        exp_loc, exp_size, mant, bias = (
            (23, 8, 23, 127) if dt.itemsize == 4 else (52, 11, 52, 1023)
        )
        return struct.pack(
            "<BBBBIHHBBBBI", 0x11, 0x20, 8 * dt.itemsize - 1, 0, dt.itemsize,
            0, 8 * dt.itemsize, exp_loc, exp_size, 0, mant, bias,
        )
    if dt.kind == "S":
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, dt.itemsize)
    raise NotImplementedError(f"writing dtype {dt}")


def _dataspace_message(shape):
    if not shape:  # version 2 says "scalar" outright; a v1 rank of 0 may not
        return struct.pack("<BBBB", 2, 0, 0, 0)
    return struct.pack(f"<BBB5x{len(shape)}Q", 1, len(shape), 0, *shape)


def _object_header(msgs):
    body = b"".join(
        struct.pack("<HHB3x", t, len(_pad8(b)), flags) + _pad8(b)
        for t, b, flags in msgs
    )
    return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body


def _as_array(value):
    if isinstance(value, str):
        return value
    arr = np.asarray(value)
    if arr.dtype.kind == "U":
        arr = np.char.encode(arr, "utf-8")
    elif arr.dtype.kind == "b":
        arr = arr.astype(np.int8)
    return arr


class _Writer:
    """Appends objects at the file position of ``fh``; addresses are
    relative to the file's ``base``."""

    def __init__(self, fh, base=0):
        self.fh = fh
        self.base = base
        self.strings = {}  # str -> global heap object index
        self.gcol = UNDEF

    def put(self, data):
        """Write ``data`` 8-byte aligned; return its address."""
        pad = -self.fh.tell() % 8
        if pad:
            self.fh.write(b"\0" * pad)
        addr = self.fh.tell() - self.base
        self.fh.write(data)
        return addr

    def collect_strings(self, tree):
        for v in tree.attrs.values():
            if isinstance(v, str):
                self.strings.setdefault(v, len(self.strings) + 1)
        for child in tree.values():
            if isinstance(child, Tree):
                self.collect_strings(child)
            elif isinstance(child, tuple):
                self.collect_strings(Tree(attrs=child[1]))

    def write_gcol(self):
        if not self.strings:
            return
        objs = b"".join(
            struct.pack("<HHIQ", idx, 1, 0, len(s.encode()))
            + _pad8(s.encode())
            for s, idx in self.strings.items()
        )
        size = max(_GCOL_MIN, 16 + len(objs) + 16)
        free = size - 16 - len(objs)
        body = objs + struct.pack("<HHIQ", 0, 0, 0, free) + b"\0" * (free - 16)
        self.gcol = self.put(b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size) + body)

    def attr_messages(self, attrs):
        msgs = []
        for name, value in attrs.items():
            value = _as_array(value)
            if isinstance(value, str):
                dt, shape = VLEN_STR, ()
                s = value.encode()
                data = struct.pack("<IQI", len(s), self.gcol, self.strings[value])
            else:
                dt, shape = value.dtype, value.shape
                data = value.astype(dt.newbyteorder("<")).tobytes()
            nb = name.encode() + b"\0"
            dtm, dsm = _dtype_message(dt), _dataspace_message(shape)
            body = (
                struct.pack("<BBHHH", 1, 0, len(nb), len(dtm), len(dsm))
                + _pad8(nb) + _pad8(dtm) + _pad8(dsm) + data
            )
            msgs.append((_MSG_ATTRIBUTE, body, 0))
        return msgs

    def dataset(self, value):
        attrs = {}
        if isinstance(value, tuple):
            value, attrs = value
        arr = _as_array(value)
        if arr.dtype.kind not in "iufS":
            raise NotImplementedError(f"writing dataset of dtype {arr.dtype}")
        arr = np.asarray(arr, arr.dtype.newbyteorder("<"), order="C")
        addr = self.put(memoryview(arr.reshape(-1)).cast("B")) if arr.size else UNDEF
        msgs = [
            (_MSG_DATASPACE, _dataspace_message(arr.shape), 0),
            (_MSG_DATATYPE, _dtype_message(arr.dtype), 1),
            (_MSG_FILL, struct.pack("<BBBB", 2, 2, 2, 0), 1),
            (_MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, addr, arr.nbytes), 0),
        ]
        return self.put(_object_header(msgs + self.attr_messages(attrs)))

    def group(self, tree):
        """Write ``tree``; return (object header, B-tree, local heap)."""
        children = {}
        for name, child in tree.items():
            if isinstance(child, Tree):
                children[name] = self.group(child)[0]
            else:
                children[name] = self.dataset(child)
        names = sorted(children, key=lambda s: s.encode())
        if len(names) > 2 * _LEAF_K:
            raise NotImplementedError(f"groups of more than {2 * _LEAF_K} members")
        heap, offsets = bytearray(8), {}
        for name in names:
            offsets[name] = len(heap)
            heap += _pad8(name.encode() + b"\0")
        heap_data = self.put(bytes(heap))
        heap_addr = self.put(
            b"HEAP" + bytes(4) + struct.pack("<QQQ", len(heap), 1, heap_data)
        )
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + b"".join(
            struct.pack("<QQII16x", offsets[n], children[n], 0, 0) for n in names
        )
        snod_addr = self.put(snod.ljust(_SNOD_SIZE, b"\0"))
        last = offsets[names[-1]] if names else 0
        node = b"TREE" + struct.pack(
            "<BBHQQQQQ", 0, 0, 1, UNDEF, UNDEF, 0, snod_addr, last
        )
        btree_addr = self.put(node.ljust(_TREE_SIZE, b"\0"))
        msgs = [(_MSG_SYMBOL_TABLE, struct.pack("<QQ", btree_addr, heap_addr), 0)]
        ohdr = self.put(_object_header(msgs + self.attr_messages(tree.attrs)))
        return ohdr, btree_addr, heap_addr


def write_file(path, tree):
    """Write ``tree`` (a :class:`Tree`) as a new HDF5 file at ``path``."""
    with open(path, "wb") as fh:
        w = _Writer(fh)
        fh.write(b"\0" * 96)  # superblock, written last
        w.collect_strings(tree)
        w.write_gcol()
        root, btree, heap = w.group(tree)
        eof = fh.tell()
        fh.seek(0)
        fh.write(
            SIGNATURE
            + bytes([0, 0, 0, 0, 0, 8, 8, 0])
            + struct.pack("<HHI", _LEAF_K, _NODE_K, 0)
            + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
            + struct.pack("<QQII", 0, root, 1, 0)
            + struct.pack("<QQ", btree, heap)
        )


def store_dataset(path, group, name, value):
    """Link ``value`` (an array, or an ``(array, attrs)`` pair) as the
    dataset ``name`` of ``group`` in the HDF5 file at ``path``, replacing
    any member of that name.

    The file is edited in place.  The new data and object header (and a
    global heap for string attributes) are appended; the group's local
    heap gets the name through a copy of its name segment at the end of
    the file; the symbol-table node and its B-tree take the new entry,
    a full node splitting in two.  Nothing else is read or moved: other
    datasets keep their chunks and filters byte for byte.  A replaced
    member's space stays unused, as HDF5 itself leaves it.

    Needs a superblock v0 or v1 and a symbol-table group whose B-tree is
    one node: the layout HDF5 writes by default, and cooler with it.
    """
    with File(path) as f:
        sb = f.superblock
        if sb["version"] > 1:
            raise NotImplementedError(f"editing an HDF5 superblock v{sb['version']}")
        g = f[group]
        if not isinstance(g, Group) or g.symbol_table is None:
            raise NotImplementedError(f"editing {group!r}: not a symbol-table group")
        btree, heap = g.symbol_table
        base = f._base
    key = name.encode("utf-8")
    with open(path, "r+b") as fh:

        def read(addr, n):
            fh.seek(base + addr)
            b = fh.read(n)
            if len(b) != n:
                raise OSError(f"{path}: truncated HDF5 file")
            return b

        def write(addr, data):
            fh.seek(base + addr)
            fh.write(data)

        node = read(btree, 24)
        if node[:4] != b"TREE" or node[4] != 0:
            raise OSError(f"{path}: bad group B-tree at {btree}")
        if node[5]:
            raise NotImplementedError("editing a group B-tree of more than one node")
        used = struct.unpack_from("<H", node, 6)[0]
        body = read(btree + 24, 16 * used + 8)
        keys = [struct.unpack_from("<Q", body, 16 * i)[0] for i in range(used + 1)]
        children = [struct.unpack_from("<Q", body, 16 * i + 8)[0] for i in range(used)]
        seg_size, _free, seg_addr = struct.unpack_from("<QQQ", read(heap, 32), 8)
        names = read(seg_addr, seg_size)

        def name_at(off):
            return names[off : names.index(b"\0", off)]

        def name_of(entry):
            return name_at(struct.unpack_from("<Q", entry)[0])

        # the child whose key range holds the name (names sort as bytes)
        i = next((i for i in range(used) if key <= name_at(keys[i + 1])), used - 1)
        snod = children[i]
        head = read(snod, 8)
        if head[:4] != b"SNOD":
            raise OSError(f"{path}: bad symbol table node at {snod}")
        nsym = struct.unpack_from("<H", head, 6)[0]
        entries = [read(snod + 8 + 40 * k, 40) for k in range(nsym)]
        k = next((k for k, e in enumerate(entries) if name_of(e) == key), None)
        cap = 2 * sb["leaf_k"]
        if k is None and nsym >= cap and used >= 2 * sb["node_k"]:
            raise NotImplementedError("splitting a full group B-tree node")

        fh.seek(max(fh.seek(0, os.SEEK_END), base + sb["eof"]))
        w = _Writer(fh, base)
        w.collect_strings(Tree(attrs=value[1] if isinstance(value, tuple) else {}))
        w.write_gcol()
        ohdr = w.dataset(value)
        if k is not None:
            off = struct.unpack_from("<Q", entries[k])[0]
            entries[k] = struct.pack("<QQII16x", off, ohdr, 0, 0)
            nodes = {snod: entries}
        else:
            off = len(names) + -len(names) % 8
            names = names.ljust(off, b"\0") + _pad8(key + b"\0")
            seg_addr = w.put(names)
            entries.append(struct.pack("<QQII16x", off, ohdr, 0, 0))
            entries.sort(key=name_of)
            nodes = {snod: entries}
            if len(entries) > cap:
                half = len(entries) // 2
                right = b"SNOD" + struct.pack("<BBH", 1, 0, len(entries) - half)
                right = w.put((right + b"".join(entries[half:])).ljust(8 + 40 * cap, b"\0"))
                nodes[snod] = entries[:half]
                children.insert(i + 1, right)
                keys.insert(i + 1, struct.unpack_from("<Q", entries[half - 1])[0])
                i += 1
            # the last child's right key bounds every name in the group
            if name_of(entries[-1]) > name_at(keys[i + 1]):
                keys[i + 1] = off
        eof = fh.seek(0, os.SEEK_END) - base
        # the appended objects are inside the file before anything links them
        fh.seek(sb["eof_at"])
        fh.write(struct.pack("<Q", eof))
        write(heap + 8, struct.pack("<Q", len(names)))
        write(heap + 24, struct.pack("<Q", seg_addr))
        for addr, ents in nodes.items():
            snod_bytes = b"SNOD" + struct.pack("<BBH", 1, 0, len(ents)) + b"".join(ents)
            write(addr, snod_bytes.ljust(8 + 40 * cap, b"\0"))
        write(btree + 6, struct.pack("<H", len(children)))
        write(btree + 24, b"".join(
            struct.pack("<QQ", keys[j], children[j]) for j in range(len(children))
        ) + struct.pack("<Q", keys[-1]))

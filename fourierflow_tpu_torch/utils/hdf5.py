"""A small HDF5 writer and reader in numpy, for hosts without ``h5py``.

It covers what the dataset generators write and the builders read: a file
of groups holding contiguous, little-endian datasets (float32, float64,
int32 and int64), and scalar attributes of the root group (``dt`` and
``inner_steps`` of the Kolmogorov files). The files are
in the format HDF5's own library writes by default (superblock version 0,
version-1 object headers, groups as symbol tables), so ``h5py`` and every
HDF5 tool read them, and ``read_dataset`` reads such files written by
``h5py`` (datasets stored contiguously, or never written, which reads as
zeros). Chunked, compressed, string and compound datasets are refused.

``H5Writer`` lays the whole file out up front (every dataset's shape is
known) and then writes rows of a dataset in place, so a dataset larger
than memory is filled a batch at a time; space never written reads as 0,
HDF5's default fill value. With ``atomic`` it writes ``path + ".tmp"`` and
renames it to ``path`` when it is closed without an error, so that an
unfinished file never stands under the final name.
"""

import os
import struct
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["H5Writer", "read_dataset"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_LEAF_K, _INTERNAL_K = 4, 16  # the library's defaults: 2K symbols a node, 2K children a B-tree node
_HEAP_FREE_NULL = 1  # the on-disk end of a local heap's free list

# Object header message types.
_DATASPACE, _DATATYPE, _FILL, _LAYOUT, _ATTRIBUTE, _CONTINUATION, _SYMBOL_TABLE = (
    1, 3, 5, 8, 12, 16, 17)


def _pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def _message(kind: int, body: bytes) -> bytes:
    body = body.ljust(_pad8(len(body)), b"\0")
    return struct.pack("<HHB3x", kind, len(body), 0) + body


def _object_header(messages: Sequence[bytes]) -> bytes:
    data = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(data)) + data


def _datatype(dtype: np.dtype) -> bytes:
    dtype = np.dtype(dtype)
    if dtype.kind in "iu" and dtype.itemsize in (4, 8):
        # class 0 (fixed point), version 1; little-endian, signed or not.
        return (struct.pack("<B3BI", 0x10, 0x08 if dtype.kind == "i" else 0, 0, 0, dtype.itemsize)
                + struct.pack("<HH", 0, dtype.itemsize * 8))
    if dtype.kind != "f" or dtype.itemsize not in (4, 8):
        raise TypeError(f"HDF5 writer: unsupported dtype {dtype}")
    bits = dtype.itemsize * 8
    exp, mant, bias = {32: (8, 23, 127), 64: (11, 52, 1023)}[bits]
    # class 1 (float), version 1; little-endian, implied msb, sign bit last.
    return (struct.pack("<B3BI", 0x11, 0x20, bits - 1, 0, dtype.itemsize)
            + struct.pack("<HHBBBBI", 0, bits, mant, exp, 0, mant, bias))


def _attribute(name: str, value) -> bytes:
    """A version-1 attribute message body: a scalar of ``value``'s type
    (a Python float is float64, an int int64)."""
    value = np.asarray(value)
    if value.ndim != 0:
        raise ValueError(f"HDF5 writer: attribute {name!r} must be a scalar")
    if value.dtype.kind == "i":
        value = value.astype(np.int64)
    raw_name = name.encode() + b"\0"
    dtype, space = _datatype(value.dtype), struct.pack("<BBBx4x", 1, 0, 0)  # scalar dataspace
    pad = lambda b: b.ljust(_pad8(len(b)), b"\0")
    return (struct.pack("<BxHHH", 1, len(raw_name), len(dtype), len(space)) + pad(raw_name)
            + pad(dtype) + pad(space) + value.astype(value.dtype.newbyteorder("<")).tobytes())


class H5Writer:
    """Create ``path`` (which must not exist) with one contiguous dataset
    for each entry of ``datasets`` (``"group/name" -> (shape, dtype)``) and
    the scalar root attributes ``attrs``, then fill rows with ``write``. Use
    as a context manager. With ``atomic`` the file is written as ``path +
    ".tmp"`` (replaced if it is there) and renamed to ``path`` (replacing
    it) by ``close``; leaving the context with an error deletes it."""

    def __init__(self, path: str, datasets: Dict[str, Tuple[Tuple[int, ...], np.dtype]],
                 attrs: Optional[Dict[str, object]] = None, atomic: bool = False):
        self.final_path = path
        if atomic:
            path = path + ".tmp"
            if os.path.exists(path):
                os.remove(path)
        elif os.path.exists(path):
            raise FileExistsError(f"{path} exists; the HDF5 writer makes new files only")
        self.path = path
        self._attrs = [_attribute(k, v) for k, v in (attrs or {}).items()]
        self._layout: Dict[str, Tuple[int, Tuple[int, ...], np.dtype]] = {}
        # The tree of groups: a dict per group, a (shape, dtype) tuple per dataset.
        root: dict = {}
        for name, (shape, dtype) in datasets.items():
            *groups, leaf = name.strip("/").split("/")
            node = root
            for g in groups:
                node = node.setdefault(g, {})
            node[leaf] = (tuple(int(s) for s in shape), np.dtype(dtype), name)
        self._blocks: list = []  # (address, bytes) of the metadata
        self._end = 96  # after the superblock
        root_header, root_cache = self._group(root, self._attrs)
        superblock = (_SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K,
                                                _INTERNAL_K, 0)
                      + struct.pack("<QQQQ", 0, _UNDEF, self._end, _UNDEF)
                      + self._entry(0, root_header, root_cache))
        with open(path, "wb") as f:
            f.write(superblock)
            for address, block in self._blocks:
                f.seek(address)
                f.write(block)
            f.truncate(self._end)
        self._file = open(path, "r+b")

    # --- layout ------------------------------------------------------------------
    def _alloc(self, nbytes: int) -> int:
        address = self._end
        self._end = _pad8(self._end + nbytes)
        return address

    def _put(self, block: bytes) -> int:
        address = self._alloc(len(block))
        self._blocks.append((address, block))
        return address

    @staticmethod
    def _entry(name_offset: int, header: int, group_cache=None) -> bytes:
        """A symbol table entry; a group's caches its B-tree and heap addresses."""
        if group_cache is None:
            return struct.pack("<QQII16x", name_offset, header, 0, 0)
        return struct.pack("<QQIIQQ", name_offset, header, 1, 0, *group_cache)

    def _group(self, members: dict, attrs=()):
        """Write a group and everything in it, with the attribute messages
        ``attrs``; returns the address of its object header and the
        (B-tree, heap) addresses."""
        names = sorted(members)
        if len(names) > 2 * _LEAF_K:
            raise ValueError(f"HDF5 writer: at most {2 * _LEAF_K} members a group")
        heap = b"\0" * 8  # offset 0: the empty name
        offsets = []
        for n in names:
            offsets.append(len(heap))
            raw = n.encode() + b"\0"
            heap += raw.ljust(_pad8(len(raw)), b"\0")
        children = []
        for n in names:
            m = members[n]
            if isinstance(m, dict):
                children.append(self._group(m))
            else:
                children.append((self._dataset(*m), None))
        heap_data = self._put(heap)
        heap_header = self._put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), _HEAP_FREE_NULL,
                                                       heap_data))
        entries = b"".join(self._entry(off, hdr, cache)
                           for off, (hdr, cache) in zip(offsets, children))
        snod = (b"SNOD" + struct.pack("<BBH", 1, 0, len(names))
                + entries.ljust(2 * _LEAF_K * 40, b"\0"))
        snod_address = self._put(snod)
        # One leaf B-tree node: key 0 (the empty name), the node, the last name.
        keys = struct.pack("<QQQ", 0, snod_address, offsets[-1] if offsets else 0)
        btree = (b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, _UNDEF, _UNDEF)
                 + keys.ljust((2 * _INTERNAL_K + 1) * 8 + 2 * _INTERNAL_K * 8, b"\0"))
        btree_address = self._put(btree)
        header = self._put(_object_header(
            [_message(_SYMBOL_TABLE, struct.pack("<QQ", btree_address, heap_header))]
            + [_message(_ATTRIBUTE, a) for a in attrs]))
        return header, (btree_address, heap_header)

    def _dataset(self, shape, dtype, name) -> int:
        nbytes = int(np.prod(shape)) * dtype.itemsize
        data = self._alloc(nbytes)
        self._layout[name] = (data, shape, dtype)
        space = struct.pack("<BBBx4x", 1, len(shape), 0) + struct.pack(f"<{len(shape)}Q", *shape)
        fill = struct.pack("<BBBB", 2, 1, 2, 0)  # allocated early, written if set, undefined
        layout = struct.pack("<BBQQ", 3, 1, data, nbytes)
        return self._put(_object_header([_message(_DATASPACE, space),
                                         _message(_DATATYPE, _datatype(dtype)),
                                         _message(_FILL, fill), _message(_LAYOUT, layout)]))

    # --- data ------------------------------------------------------------------
    def write(self, name: str, start: int, rows: np.ndarray) -> None:
        """Write ``rows`` into dataset ``name`` from row ``start`` on."""
        address, shape, dtype = self._layout[name]
        rows = np.ascontiguousarray(rows, dtype=dtype)
        if rows.shape[1:] != shape[1:] or not 0 <= start <= start + len(rows) <= shape[0]:
            raise ValueError(f"{name}: rows {rows.shape} at {start} do not fit {shape}")
        row_bytes = int(np.prod(shape[1:])) * dtype.itemsize
        self._file.seek(address + start * row_bytes)
        self._file.write(rows.astype(dtype.newbyteorder("<"), copy=False).tobytes())

    def close(self) -> None:
        """Close the file; an atomic writer renames it to its final path."""
        self._file.close()
        if self.path != self.final_path:
            os.replace(self.path, self.final_path)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is not None and self.path != self.final_path:
            self._file.close()
            os.remove(self.path)
        else:
            self.close()


# --- reading ------------------------------------------------------------------------
def _messages(f, address: int):
    """(type, body) of every message of the version-1 object header at ``address``."""
    f.seek(address)
    version, _, count, _, size = struct.unpack("<BBHII4x", f.read(16))
    if version != 1:
        raise NotImplementedError(f"HDF5 reader: object header version {version}")
    blocks, out = [(address + 16, size)], []
    while blocks and len(out) < count:
        start, size = blocks.pop(0)
        f.seek(start)
        raw, pos = f.read(size), 0
        while pos + 8 <= len(raw) and len(out) < count:
            kind, length, flags = struct.unpack_from("<HHB", raw, pos)
            body = raw[pos + 8: pos + 8 + length]
            pos += 8 + length
            if flags & 0x02:
                raise NotImplementedError("HDF5 reader: shared header messages")
            if kind == _CONTINUATION:
                blocks.append(struct.unpack("<QQ", body[:16]))
            out.append((kind, body))
    return out


def _heap_name(f, heap_data: int, offset: int) -> str:
    f.seek(heap_data + offset)
    raw = b""
    while b"\0" not in raw:
        chunk = f.read(64)
        if not chunk:
            break
        raw += chunk
    return raw.split(b"\0", 1)[0].decode()


def _group_members(f, btree: int, heap: int) -> Dict[str, int]:
    f.seek(heap)
    sig, _, _, _, heap_data = struct.unpack("<4sB3xQQQ", f.read(32))
    if sig != b"HEAP":
        raise ValueError("HDF5 reader: bad local heap")
    members, todo = {}, [btree]
    while todo:
        f.seek(todo.pop())
        sig, kind, level, used, _, _ = struct.unpack("<4sBBHQQ", f.read(24))
        if sig != b"TREE" or kind != 0:
            raise ValueError("HDF5 reader: bad group B-tree node")
        words = struct.unpack(f"<{2 * used + 1}Q", f.read((2 * used + 1) * 8))
        children = words[1::2]
        if level > 0:
            todo.extend(children)
            continue
        for snod in children:
            f.seek(snod)
            sig, _, _, n = struct.unpack("<4sBBH", f.read(8))
            if sig != b"SNOD":
                raise ValueError("HDF5 reader: bad symbol table node")
            entries = [struct.unpack_from("<QQ", f.read(40)) for _ in range(n)]
            for name_offset, header in entries:
                members[_heap_name(f, heap_data, name_offset)] = header
    return members


def _dtype(body: bytes) -> np.dtype:
    cls, b0, _, _, size = struct.unpack_from("<BBBBI", body)
    order = ">" if b0 & 1 else "<"
    if cls & 0x0F == 1:
        return np.dtype(f"{order}f{size}")
    if cls & 0x0F == 0:
        return np.dtype(f"{order}{'i' if b0 & 0x08 else 'u'}{size}")
    raise NotImplementedError(f"HDF5 reader: datatype class {cls & 0x0F}")


def read_dataset(path: str, key: str, mmap: bool = False) -> np.ndarray:
    """The dataset ``key`` (``"group/name"``) of the HDF5 file at ``path``.
    With ``mmap`` a read-only ``np.memmap`` of it, so that a slice reads
    only what it keeps (as h5py's slicing does); a dataset that was never
    written reads as zeros either way."""
    with open(path, "rb") as f:
        head = f.read(96)
        if head[:8] != _SIGNATURE:
            raise ValueError(f"{path} is not an HDF5 file")
        if head[8] != 0:
            raise NotImplementedError(f"HDF5 reader: superblock version {head[8]}")
        header = struct.unpack_from("<Q", head, 56 + 8)[0]
        for part in key.strip("/").split("/"):
            table = [b for k, b in _messages(f, header) if k == _SYMBOL_TABLE]
            if not table:
                raise KeyError(f"{key}: {part!r} is looked up in a dataset")
            members = _group_members(f, *struct.unpack("<QQ", table[0][:16]))
            if part not in members:
                raise KeyError(f"{key}: no {part!r} (members {sorted(members)})")
            header = members[part]
        msgs = dict(_messages(f, header))
        if _LAYOUT not in msgs:
            raise KeyError(f"{key} is not a dataset")
        space, layout = msgs[_DATASPACE], msgs[_LAYOUT]
        rank = space[1]
        dims_at = 8 if space[0] == 1 else 4
        shape = struct.unpack_from(f"<{rank}Q", space, dims_at)
        dtype = _dtype(msgs[_DATATYPE])
        if layout[0] != 3 or layout[1] != 1:
            raise NotImplementedError(f"HDF5 reader: {key} is not stored contiguously")
        address, _ = struct.unpack_from("<QQ", layout, 2)
        count = int(np.prod(shape))
        if address == _UNDEF or count == 0:  # never written: the default fill value
            return np.zeros(shape, dtype.newbyteorder("="))
        if mmap:
            return np.memmap(path, dtype=dtype, mode="r", offset=address, shape=tuple(shape))
        f.seek(address)
        data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
        return data.reshape(shape).astype(dtype.newbyteorder("="))

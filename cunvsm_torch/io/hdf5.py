"""A small HDF5 writer and reader for flat files of float32 datasets, in numpy.

The checkpoint files of the reference (``<prefix>_<epoch>.hdf5``) hold four
float32 datasets in the root group and nothing else.  This module writes
exactly that without h5py, in the oldest layout of the HDF5 file format,
which h5py and the HDF5 library read:

* superblock version 0, offsets and lengths of 8 bytes;
* a root group with a symbol table: one version 1 B-tree leaf node, one
  local heap of the dataset names and one symbol table node (SNOD);
* per dataset a version 1 object header with a dataspace, a datatype, a
  fill value and a contiguous layout message, then the raw data, little
  endian, in row-major order.

No structure of that layout carries a checksum.  The reader walks the same
structures, so it also reads the float32 datasets that h5py writes in its
default layout, contiguous or chunked without filters (the JAX package's
writer chunks tables of 8192 rows or more into blocks of 2048 rows): a
chunked dataset's layout message (version 3, class 2) points at a version 1
B-tree of type 1, whose leaves address the chunks by their element
offsets; every chunk is stored whole, so the edge chunks are trimmed to the
dataset's shape.  Anything else (a filtered dataset, another datatype, a
version 2 object header, a later superblock) raises a ``ValueError`` that
names it.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Dict, List, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address
HEAP_FREE_NULL = 1  # end of a local heap's free list (H5HLprivate.h)
LEAF_K = 4  # group leaf node K: a SNOD holds 2K entries
INTERNAL_K = 16  # group internal node K: a B-tree node holds 2K children
# The library reads whole nodes, so each is written at its full size.
BTREE_NODE_SIZE = 24 + 2 * INTERNAL_K * 8 + (2 * INTERNAL_K + 1) * 8
SNOD_SIZE = 8 + 2 * LEAF_K * 40

# Object header message types.
MSG_NIL, MSG_DATASPACE, MSG_DATATYPE, MSG_FILL = 0, 1, 3, 5
MSG_LAYOUT, MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 8, 11, 16, 17

# Datatype message of IEEE float32, little endian: class 1 (floating
# point) version 1; bit field: byte order, mantissa normalized with an
# implied leading bit, sign at bit 31; size 4; bit offset 0, precision 32,
# exponent at 23 of 8 bits, mantissa at 0 of 23 bits, exponent bias 127.
FLOAT32_LE = struct.pack("<B3BIHHBBBBI", 0x11, 0x20, 31, 0, 4, 0, 32, 23, 8, 0, 23, 127)


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _message(kind: int, body: bytes, flags: int = 0) -> bytes:
    body = body + b"\0" * (_pad8(len(body)) - len(body))
    return struct.pack("<HHB3x", kind, len(body), flags) + body


def _object_header(messages: List[bytes]) -> bytes:
    size = sum(len(m) for m in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, size) + b"".join(messages)


def _dataset_header(shape: Tuple[int, ...], addr: int, nbytes: int) -> bytes:
    rank = len(shape)
    dataspace = struct.pack("<BBB5x", 1, rank, 1) + struct.pack(f"<{2 * rank}Q", *shape, *shape)
    # Fill value version 2: allocation late, written if set, defined with
    # size 0 (the default fill); the bytes h5py writes for float32 datasets.
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)
    layout = struct.pack("<BBQQ", 3, 1, addr, nbytes)
    return _object_header([
        _message(MSG_DATASPACE, dataspace),
        _message(MSG_DATATYPE, FLOAT32_LE, flags=1),
        _message(MSG_FILL, fill, flags=1),
        _message(MSG_LAYOUT, layout),
    ])


def write_datasets(f: BinaryIO, datasets: Dict[str, np.ndarray]) -> None:
    """Write ``datasets`` (name -> float32 array) as the root group of a new
    HDF5 file to the binary stream ``f``, which must be at offset 0."""
    names = sorted(datasets)  # the SNOD's entries are in strcmp order
    if not 0 < len(names) <= 2 * LEAF_K:
        raise ValueError(f"write_datasets: 1 to {2 * LEAF_K} datasets, got {len(names)}")
    arrays = []
    for name in names:
        a = np.asarray(datasets[name])
        if a.dtype != np.float32:
            raise ValueError(f"write_datasets: {name} is {a.dtype}, not float32")
        arrays.append(np.ascontiguousarray(a, dtype="<f4"))

    # Local heap data: the empty name at offset 0, then each name,
    # NUL-terminated and padded to 8 bytes.
    heap_data, name_offsets = bytearray(8), []
    for name in names:
        name_offsets.append(len(heap_data))
        raw = name.encode() + b"\0"
        heap_data += raw + b"\0" * (_pad8(len(raw)) - len(raw))

    root_ohdr = 96
    btree = root_ohdr + len(_object_header([_message(MSG_SYMBOL_TABLE, bytes(16))]))
    heap = btree + BTREE_NODE_SIZE
    heap_addr = heap + 32
    snod = heap_addr + len(heap_data)
    # A header's size depends on the rank only, not on the addresses.
    header_sizes = [len(_dataset_header(a.shape, 0, 0)) for a in arrays]
    ohdrs, data_addrs = [], []
    pos = snod + SNOD_SIZE
    for size in header_sizes:
        ohdrs.append(pos)
        pos += size
    for a in arrays:
        data_addrs.append(pos)
        pos = _pad8(pos + a.nbytes)
    eof = pos

    out = bytearray(SIGNATURE)
    out += struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K, INTERNAL_K, 0)
    out += struct.pack("<4Q", 0, UNDEF, eof, UNDEF)
    out += struct.pack("<QQI4xQQ", 0, root_ohdr, 1, btree, heap)  # root entry
    out += _object_header([_message(MSG_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))])
    # One B-tree leaf: key 0 is the empty name, key 1 the last name of
    # the one child, the SNOD.
    node = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, UNDEF, UNDEF)
    node += struct.pack("<QQQ", 0, snod, name_offsets[-1])
    out += node + bytes(BTREE_NODE_SIZE - len(node))
    out += b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), HEAP_FREE_NULL, heap_addr)
    out += heap_data
    sn = b"SNOD" + struct.pack("<BxH", 1, len(names)) + b"".join(
        struct.pack("<QQI4x16x", off, addr, 0) for off, addr in zip(name_offsets, ohdrs)
    )
    out += sn + bytes(SNOD_SIZE - len(sn))
    for a, addr in zip(arrays, data_addrs):
        out += _dataset_header(a.shape, addr, a.nbytes)
    f.write(out)
    for a, addr in zip(arrays, data_addrs):
        f.write(bytes(addr - f.tell()))
        f.write(memoryview(a.reshape(-1)).cast("B"))
    f.write(bytes(eof - f.tell()))


class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f

    def read(self, addr: int, n: int) -> bytes:
        self.f.seek(addr)
        data = self.f.read(n)
        if len(data) != n:
            raise ValueError(f"HDF5: truncated file at {addr} (+{n})")
        return data

    def messages(self, addr: int) -> Dict[int, Tuple[int, bytes]]:
        """type -> (flags, body) of the messages of the object header at
        ``addr``, continuation chunks followed."""
        prefix = self.read(addr, 16)
        version, _, _, _, size = struct.unpack("<BBHII", prefix[:12])
        if version != 1:
            raise ValueError("HDF5: only version 1 object headers are read")
        chunks, out = [(addr + 16, size)], {}
        while chunks:
            start, length = chunks.pop()
            blob, p = self.read(start, length), 0
            while p + 8 <= length:
                kind, n, flags = struct.unpack("<HHB", blob[p:p + 5])
                body = blob[p + 8:p + 8 + n]
                p += 8 + n
                if kind == MSG_CONTINUATION:
                    chunks.append(struct.unpack("<QQ", body[:16]))
                elif kind != MSG_NIL:
                    out[kind] = (flags, body)
        return out

    def chunks(self, btree: int, rank: int):
        """(chunk address, stored bytes, element offsets) of every chunk
        under the raw-data B-tree at ``btree``, for a dataset of ``rank``
        dimensions: all levels walked."""
        key_size = 8 + 8 * (rank + 1)  # chunk size, filter mask, offsets
        nodes, out = [btree], []
        while nodes:
            node = nodes.pop()
            hdr = self.read(node, 24)
            if hdr[:4] != b"TREE" or hdr[4] != 1:
                raise ValueError("HDF5: bad chunk B-tree node")
            level, used = hdr[5], struct.unpack("<H", hdr[6:8])[0]
            # Keys and children interleave: key 0, child 0, key 1, ...
            body = self.read(node + 24, used * (key_size + 8) + key_size)
            for i in range(used):
                key = body[i * (key_size + 8):(i + 1) * (key_size + 8) - 8]
                child = struct.unpack("<Q", body[(i + 1) * (key_size + 8) - 8:
                                                 (i + 1) * (key_size + 8)])[0]
                if level:
                    nodes.append(child)
                    continue
                size, mask = struct.unpack("<II", key[:8])
                if mask:
                    raise ValueError("HDF5: a chunk skips filters; not read")
                offsets = struct.unpack(f"<{rank}Q", key[8:8 + 8 * rank])
                out.append((child, size, offsets))
        return out

    def group_entries(self, btree: int, heap: int) -> Dict[str, int]:
        """name -> object header address of every entry of a group."""
        hdr = self.read(heap, 32)
        if hdr[:4] != b"HEAP":
            raise ValueError("HDF5: bad local heap signature")
        seg_size, _, seg_addr = struct.unpack("<QQQ", hdr[8:32])
        names = self.read(seg_addr, seg_size)
        entries: Dict[str, int] = {}
        nodes = [btree]
        while nodes:
            node = nodes.pop()
            hdr = self.read(node, 24)
            if hdr[:4] != b"TREE" or hdr[4] != 0:
                raise ValueError("HDF5: bad group B-tree node")
            level, used = hdr[5], struct.unpack("<H", hdr[6:8])[0]
            # Keys and children interleave: key 0, child 0, key 1, ...
            body = self.read(node + 24, used * 16 + 8)
            children = [struct.unpack("<Q", body[8 + 16 * i:16 + 16 * i])[0] for i in range(used)]
            if level:
                nodes += children
                continue
            for child in children:
                sn = self.read(child, 8)
                if sn[:4] != b"SNOD":
                    raise ValueError("HDF5: bad symbol table node")
                blob = self.read(child + 8, 40 * struct.unpack("<H", sn[6:8])[0])
                for i in range(0, len(blob), 40):
                    off, ohdr = struct.unpack("<QQ", blob[i:i + 16])
                    entries[names[off:names.index(b"\0", off)].decode()] = ohdr
        return entries


def read_datasets(f: BinaryIO) -> Dict[str, np.ndarray]:
    """Every dataset of the root group of the HDF5 file ``f`` (a binary
    file opened for reading), as float32 arrays."""
    h = _Reader(f)
    sb = h.read(0, 96)
    if sb[:8] != SIGNATURE:
        raise ValueError("HDF5: not an HDF5 file (no signature at offset 0)")
    if sb[8] != 0:
        raise ValueError(f"HDF5: superblock version {sb[8]}; only version 0 is read")
    if sb[13] != 8 or sb[14] != 8:
        raise ValueError("HDF5: only 8-byte offsets and lengths are read")
    root_ohdr = struct.unpack("<Q", sb[64:72])[0]
    root = h.messages(root_ohdr)
    if MSG_SYMBOL_TABLE not in root:
        raise ValueError("HDF5: the root group has no symbol table (a later group layout)")
    btree, heap = struct.unpack("<QQ", root[MSG_SYMBOL_TABLE][1][:16])
    out = {}
    for name, ohdr in h.group_entries(btree, heap).items():
        msgs = h.messages(ohdr)
        if MSG_FILTERS in msgs:
            raise ValueError(f"HDF5: dataset {name} is filtered (compressed); not read")
        if not {MSG_LAYOUT, MSG_DATATYPE, MSG_DATASPACE} <= msgs.keys():
            raise ValueError(f"HDF5: object {name} is not a dataset")
        if msgs[MSG_DATATYPE][1][:20] != FLOAT32_LE:
            raise ValueError(f"HDF5: dataset {name} is not little-endian float32")
        dataspace = msgs[MSG_DATASPACE][1]
        if dataspace[0] != 1:
            raise ValueError(f"HDF5: dataset {name} has dataspace version {dataspace[0]}")
        shape = struct.unpack(f"<{dataspace[1]}Q", dataspace[8:8 + 8 * dataspace[1]])
        layout = msgs[MSG_LAYOUT][1]
        if layout[:2] == b"\x03\x02":
            out[name] = _read_chunked(h, name, shape, layout)
            continue
        if layout[:2] != b"\x03\x01":
            kind = {0: "compact", 2: "chunked", 3: "virtual"}.get(layout[1], "other")
            raise ValueError(f"HDF5: dataset {name} has a {kind} layout (message version "
                             f"{layout[0]}); only contiguous and chunked datasets are read")
        addr, nbytes = struct.unpack("<QQ", layout[2:18])
        count = int(np.prod(shape, dtype=np.int64))
        if addr == UNDEF or nbytes != 4 * count:
            raise ValueError(f"HDF5: dataset {name} stores {nbytes} bytes for {shape}")
        f.seek(addr)
        arr = np.fromfile(f, "<f4", count)
        if arr.size != count:
            raise ValueError(f"HDF5: dataset {name} is truncated")
        out[name] = arr.reshape(shape)
    return out


def _read_chunked(h: _Reader, name: str, shape: Tuple[int, ...], layout: bytes) -> np.ndarray:
    """A chunked dataset (layout message version 3, class 2): dimensionality
    rank + 1, the B-tree address, then rank + 1 chunk dimensions of 4 bytes,
    the last the element size.  Chunks that were never written hold the
    fill value, 0."""
    rank = layout[2] - 1
    if rank != len(shape):
        raise ValueError(f"HDF5: dataset {name}: chunk rank {rank} for shape {shape}")
    btree = struct.unpack("<Q", layout[3:11])[0]
    dims = struct.unpack(f"<{rank + 1}I", layout[11:11 + 4 * (rank + 1)])
    chunk, elem = dims[:rank], dims[rank]
    if elem != 4:
        raise ValueError(f"HDF5: dataset {name} has {elem}-byte chunk elements")
    out = np.zeros(shape, np.float32)
    if btree == UNDEF:
        return out
    chunk_bytes = 4 * int(np.prod(chunk, dtype=np.int64))
    for addr, size, offsets in h.chunks(btree, rank):
        if size != chunk_bytes:
            raise ValueError(f"HDF5: dataset {name} stores a chunk of {size} bytes, "
                             f"expected {chunk_bytes}")
        if any(o >= n or o % c for o, n, c in zip(offsets, shape, chunk)):
            raise ValueError(f"HDF5: dataset {name} has a chunk at {offsets} outside {shape}")
        block = np.frombuffer(h.read(addr, size), "<f4").reshape(chunk)
        # The edge chunks are stored whole: trim them to the dataset.
        region = tuple(slice(o, min(o + c, n)) for o, c, n in zip(offsets, chunk, shape))
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    return out

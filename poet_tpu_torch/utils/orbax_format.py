"""Read the orbax checkpoints that `poet_tpu` writes, with numpy, the
standard library and libzstd: no orbax, tensorstore or JAX.

`read_pytree(path)` returns the nested tree that orbax's
`PyTreeCheckpointer().restore(path)` gives without a template: dicts and
lists of numpy arrays, Python ints and floats for orbax's "scalar" leaves,
None for a leaf saved without an array (optax's `MaskedNode` and
`EmptyState`), and (), {} or [] for an empty tuple, dict or list. A bfloat16 array is widened to
float32 (exact: its 16 bits are the high half of the float32's), as numpy
has no bfloat16.

The directory (`PyTreeCheckpointHandler`'s layout):
  * `_METADATA`, JSON: `tree_metadata` maps each leaf's key path to its
    keys (`key_type` 2 a dict key, 1 a sequence index) and its
    `value_type`; `use_ocdbt` and `use_zarr3` say how the arrays are kept.
    zarr v3 is refused.
  * with `use_ocdbt`, one key-value database in tensorstore's OCDBT format:
    the root `manifest.ocdbt`, which orbax merges from the per-process
    databases, names the latest version's b-tree root; the nodes and the
    values stored out of line sit in data files (`d/<hash>`,
    `ocdbt.process_*/d/<hash>`) at (offset, length).
  * without it, one directory per array.
  * each array is a zarr v2 array named by its key path joined with '.':
    `<name>/.zarray` (JSON) and its chunks `<name>/<i>.<j>...`.

OCDBT's framing, on every manifest and b-tree node: a big-endian magic
(0x0cdb3a2a a manifest, 0x0cdb20de a node), the total length (u64 LE), a
format version (varint, 0), a compression (varint: 0 none, 1 zstd), the
body, and a CRC-32C (u32 LE) of everything before it, checked here: a bad
one raises. A value stored out of line is raw bytes in its data file (a
zarr chunk is a zstd frame). Varints are LEB128; the node's columns are
read as tensorstore's `kvstore/ocdbt/format` writes them:
  * manifest: config (uuid[16], manifest kind, max inline value bytes, max
    decoded node bytes, version tree arity log2 (u8), compression method
    and, for zstd, its level (i32 LE)), a data file table, then the newest
    versions: count, generation[n], root height[n] (u8), root file id[n],
    offset[n], length[n], three statistics[n] each, commit time[n] (u64 LE);
    the older versions' tree after them is not read;
  * data file table: count, common prefix with the previous path[n - 1],
    suffix length[n], base path length[n], the suffixes;
  * node: height (u8), a data file table, entry count, key prefix length
    [n - 1], key suffix length[n], in an interior node subtree common prefix
    length[n], the suffixes; a leaf then value length[n], value kind[n] (0
    inline, 1 out of line), file id and offset of each out-of-line value,
    the inline values; an interior node child file id[n], offset[n],
    length[n] and three statistics[n]. A child's keys are relative to its parent's key
    prefix plus the first `subtree common prefix length` bytes of its
    entry's key.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_EMPTY = 2**64 - 1          # the offset of an empty tree's root

# the zarr v2 dtypes of poet_tpu's checkpoints (bfloat16 is read as its uint16 bits)
_DTYPES = {"<f4": np.float32, "<f8": np.float64, "<i4": np.int32, "<i8": np.int64,
           "|b1": np.bool_, "bfloat16": np.uint16}


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT frames carry it."""
    crc, table = 0xFFFFFFFF, _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """A cursor over a decoded body."""

    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError(f"{self.what}: ends {self.pos + n - len(self.buf)} bytes early")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        shift = value = 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: a varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def unframe(raw: bytes, magic: int, what: str) -> bytes:
    """The body of one OCDBT manifest or node: magic, length and CRC-32C
    checked, decompressed."""
    if len(raw) < 18:
        raise ValueError(f"{what}: {len(raw)} bytes, too short for an OCDBT frame")
    got, length = struct.unpack(">I", raw[:4])[0], struct.unpack("<Q", raw[4:12])[0]
    if got != magic:
        raise ValueError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    if length != len(raw):
        raise ValueError(f"{what}: the frame says {length} bytes, the data holds {len(raw)}")
    want = struct.unpack("<I", raw[-4:])[0]
    if crc32c(raw[:-4]) != want:
        raise ValueError(f"{what}: CRC-32C mismatch (the data is corrupt)")
    r = _Reader(raw[:-4], what)
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version}, this reader knows 0")
    body = raw[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        from poet_tpu_torch.native import zstd_decompress

        return zstd_decompress(body)
    raise ValueError(f"{what}: unknown OCDBT compression {compression}")


def _data_file_table(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    r.varints(n)                     # base path lengths: the split does not matter here
    paths, prev = [], ""
    for i in range(n):
        prev = prev[:prefix[i]] + r.take(suffix[i]).decode()
        paths.append(prev)
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    """A node's keys and, in an interior node, each child's subtree common
    prefix length (a column between the suffix lengths and the suffixes)."""
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        prev = prev[:prefix[i]] + r.take(suffix[i])
        keys.append(prev)
    return keys, common


# a value reference: inline bytes, or (data file path, offset, length)
Ref = Tuple[str, int, int]


class OcdbtDatabase:
    """One OCDBT database rooted at a directory: `items()` walks its newest
    version's b-tree in key order, `get(key)` reads one value."""

    def __init__(self, root: str):
        self.root = root
        self._values: Optional[Dict[bytes, Any]] = None

    def _read(self, ref: Ref) -> bytes:
        path, offset, length = ref
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{path}: {length} bytes at {offset} asked, {len(data)} there")
        return data

    def _root(self) -> Optional[Tuple[int, Ref]]:
        """(height, node reference) of the newest version's root, None for
        an empty tree."""
        path = os.path.join(self.root, "manifest.ocdbt")
        with open(path, "rb") as f:
            r = _Reader(unframe(f.read(), MANIFEST_MAGIC, path), path)
        r.take(16)                                        # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{path}: a numbered manifest (kind {kind}); orbax writes kind 0")
        r.varint(), r.varint(), r.u8()                    # inline, node sizes; arity
        if r.varint() == 1:                               # zstd: its level
            r.take(4)
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            return None
        gens, heights = r.varints(n), [r.u8() for _ in range(n)]
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        newest = max(range(n), key=gens.__getitem__)
        if offsets[newest] == _EMPTY:
            return None
        return heights[newest], (files[ids[newest]], offsets[newest], lengths[newest])

    def _walk(self, height: int, ref: Ref, prefix: bytes) -> Iterator[Tuple[bytes, Any]]:
        what = f"{os.path.join(self.root, ref[0])}@{ref[1]}"
        r = _Reader(unframe(self._read(ref), NODE_MAGIC, what), what)
        got = r.u8()
        if got != height:
            raise ValueError(f"{what}: node height {got}, its parent says {height}")
        files = _data_file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, interior=height > 0)
        if height == 0:
            lengths = r.varints(n)
            kinds = r.varints(n)
            if any(k not in (0, 1) for k in kinds):
                raise ValueError(f"{what}: unknown value kind in {sorted(set(kinds))}")
            m = sum(kinds)
            ids, offsets = r.varints(m), r.varints(m)
            j = 0
            for key, length, kind in zip(keys, lengths, kinds):
                if kind:
                    yield prefix + key, (files[ids[j]], offsets[j], length)
                    j += 1
                else:
                    yield prefix + key, r.take(length)
            return
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        for key, c, i, off, length in zip(keys, common, ids, offsets, lengths):
            yield from self._walk(height - 1, (files[i], off, length), prefix + key[:c])

    def items(self) -> Iterator[Tuple[bytes, Any]]:
        """(key, value reference) in key order: a reference is inline bytes
        or (data file, offset, length)."""
        root = self._root()
        if root is not None:
            yield from self._walk(root[0], root[1], b"")

    def get(self, key: str) -> Optional[bytes]:
        if self._values is None:
            self._values = dict(self.items())
        ref = self._values.get(key.encode())
        if ref is None or isinstance(ref, bytes):
            return ref
        return self._read(ref)


def _file_getter(path: str) -> Callable[[str], Optional[bytes]]:
    def get(key: str) -> Optional[bytes]:
        p = os.path.join(path, *key.split("/"))
        if not os.path.isfile(p):
            return None
        with open(p, "rb") as f:
            return f.read()

    return get


def _fill(value, dtype: str):
    """A zarr v2 `fill_value` as a scalar of the stored dtype (None: 0)."""
    if value is None:
        return 0
    if isinstance(value, str):
        value = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}[value]
    if dtype == "bfloat16":
        return int(np.array(value, np.float32).view(np.uint32) >> 16)
    return value


def read_zarr(get: Callable[[str], Optional[bytes]], name: str) -> np.ndarray:
    """The zarr v2 array `name` of a key-value store as a numpy array
    (bfloat16 widened to float32)."""
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"the checkpoint has no array {name!r} ({name}/.zarray)")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}, this reader takes 2")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: zarr order {meta['order']!r}; only 'C' is read")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']} are not read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: zarr compressor {comp.get('id')!r}; only zstd or none")
    dtype_name = meta["dtype"]
    if dtype_name not in _DTYPES:
        raise ValueError(f"{name}: zarr dtype {dtype_name!r} is not read")
    dtype = np.dtype(_DTYPES[dtype_name])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value"), dtype_name), dtype=dtype)
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    nbytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in np.ndindex(*grid):
        key = sep.join(str(i) for i in idx) if idx else "0"
        data = get(f"{name}/{key}")
        if data is None:                        # an absent chunk holds the fill value
            continue
        if comp is not None:
            from poet_tpu_torch.native import zstd_decompress

            data = zstd_decompress(data, size_hint=nbytes)
        if len(data) != nbytes:
            raise ValueError(f"{name}/{key}: {len(data)} bytes, a chunk holds {nbytes}")
        chunk = np.frombuffer(data, dtype=dtype).reshape(chunks)
        lo = [i * c for i, c in zip(idx, chunks)]
        hi = [min(a + c, s) for a, c, s in zip(lo, chunks, shape)]
        out[tuple(slice(a, b) for a, b in zip(lo, hi))] = \
            chunk[tuple(slice(0, b - a) for a, b in zip(lo, hi))]
    if dtype_name == "bfloat16":
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out


# value types orbax saves without an array, and what its restore gives for them
_NO_ARRAY = {"None": lambda: None, "Tuple": tuple, "Dict": dict, "List": list}


def read_metadata(path: str) -> Dict:
    """The checkpoint's `_METADATA`; ValueError when it is missing or names
    a layout this reader does not take."""
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isdir(path):
        raise ValueError(f"{path} is not a directory: an orbax checkpoint is one")
    if not os.path.isfile(meta_path):
        raise ValueError(f"{path} holds no _METADATA: it is not an orbax checkpoint that "
                         "poet_tpu wrote (PyTreeCheckpointer)")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: the arrays are zarr v3 (use_zarr3); this reader takes "
                         "zarr v2, which orbax writes by default")
    if "tree_metadata" not in meta:
        raise ValueError(f"{meta_path} holds no tree_metadata")
    return meta


def _listify(node):
    """Dicts keyed by sequence indices -> lists, recursively."""
    if isinstance(node, _Seq):
        return [_listify(node[i]) for i in sorted(node)]
    if isinstance(node, dict):
        return {k: _listify(v) for k, v in node.items()}
    return node


class _Seq(dict):
    """A node whose keys are sequence indices (key_type 1)."""


def read_pytree(path: str) -> Dict:
    """The tree orbax's `PyTreeCheckpointer().restore(path)` gives without a
    template (see the module's docstring)."""
    path = os.path.abspath(path)
    meta = read_metadata(path)
    get = OcdbtDatabase(path).get if meta.get("use_ocdbt", True) else _file_getter(path)
    tree: Dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        node = tree
        for k, nxt in zip(keys, keys[1:] + [None]):
            key = int(k["key"]) if k["key_type"] == 1 else k["key"]
            if nxt is None:
                break
            node = node.setdefault(key, _Seq() if nxt["key_type"] == 1 else {})
        vtype = entry["value_metadata"]["value_type"]
        if vtype in _NO_ARRAY:
            value = _NO_ARRAY[vtype]()
        else:
            value = read_zarr(get, ".".join(str(k["key"]) for k in keys))
            if vtype == "scalar":
                value = value.item()
        node[key] = value
    if meta["tree_metadata"] and all(e["key_metadata"][0]["key_type"] == 1
                                     for e in meta["tree_metadata"].values()):
        tree = _Seq(tree)
    return _listify(tree)


def tree_digests(tree, path: Tuple[str, ...] = ()) -> Dict[str, Dict]:
    """{'/'-joined key path: {dtype, shape, sha256 of the C-order bytes}}
    for every array leaf of a restored tree (None, () and Python scalars
    have no bytes)."""
    import hashlib

    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            out.update(tree_digests(tree[k], path + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(tree_digests(v, path + (str(i),)))
    elif isinstance(tree, np.ndarray):
        arr = np.ascontiguousarray(tree)
        out["/".join(path)] = {"dtype": arr.dtype.str, "shape": list(arr.shape),
                               "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
    return out

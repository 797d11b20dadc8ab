"""The port's orbax reader (`poet_tpu_torch/utils/orbax_format.py`, on numpy
and libzstd through `poet_tpu_torch/native`) against orbax and tensorstore.

`read_pytree` must give what `ocp.PyTreeCheckpointer().restore` gives
without a template, leaf for leaf and bit for bit (a bfloat16 leaf widened
to float32, its bits the high half): every dtype orbax writes for
poet_tpu's trees, Python scalars, 0-d arrays, None / () / {} / [] leaves,
nested dicts and lists, arrays of many chunks, values stored out of line
and inline, with and without OCDBT. Orbax refuses zero-size arrays, so the
empty array is a zarr v2 array written by tensorstore. A b-tree of several
levels is written through tensorstore's `ocdbt` kvstore with a small
`max_decoded_node_bytes`; the reader's key walk and values must equal
tensorstore's `list()` and `read()`. A flipped byte must raise on its
CRC-32C; a missing `_METADATA`, zarr v3, a Fortran-order array and an
unknown compressor raise naming what they are; without libzstd the reader
raises naming the library.
"""

import json
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import orbax.checkpoint as ocp
import tensorstore as ts

from poet_tpu_torch import native
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)
from poet_tpu_torch.utils.orbax_format import (
    NODE_MAGIC,
    OcdbtDatabase,
    crc32c,
    read_pytree,
    read_zarr,
    unframe,
)


def assert_same_tree(got, want, path=""):
    """`got` (the port's reader) equals orbax's `want` leaf for leaf, bit
    for bit; a bfloat16 leaf is compared as its float32 widening."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got)
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    elif isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, (path, got, want)
    else:
        w = np.asarray(want)
        if w.dtype == jnp.bfloat16:
            w = (w.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        assert isinstance(got, np.ndarray), (path, type(got))
        assert got.dtype == w.dtype and got.shape == w.shape, (path, got.dtype, w.dtype)
        assert got.tobytes() == w.tobytes(), path


def _tree(seed=0):
    """Every kind of leaf: the dtypes poet_tpu's checkpoints hold (f32
    parameters and moments, bf16 moments, i32 counts), f64, i64, bool,
    Python scalars, 0-d arrays, None, (), {}, [], nested lists; arrays large
    and random (stored out of line) and small (inline)."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"dense": {"kernel": rng.standard_normal((96, 64)).astype(np.float32),
                             "bias": rng.standard_normal(64).astype(np.float32)},
                   "embed": rng.standard_normal((500, 8)).astype(np.float32)},
        "mu": jnp.asarray(rng.standard_normal((33, 17)), jnp.bfloat16),
        "f64": rng.standard_normal(300),
        "i64": rng.integers(-2**40, 2**40, size=(7, 3)),
        "i32": rng.integers(-9, 9, size=11).astype(np.int32),
        "mask": rng.uniform(size=(5, 4)) > 0.5,
        "count": np.int32(7),
        "zero_d": np.array(2.5, np.float32),
        "step": 12, "lr": 0.125,
        "states": [None, {"count": np.int32(3), "trace": None}, ()],
        "skip": (), "empty": {}, "empty_list": [],
    }


def _save(path, tree, ocdbt=True, chunk_bytes=None):
    handler = ocp.PyTreeCheckpointHandler(use_ocdbt=ocdbt)
    args = jax.tree_util.tree_map(
        lambda x: ocp.SaveArgs(chunk_byte_size=chunk_bytes) if hasattr(x, "shape")
        else ocp.SaveArgs(), tree)
    ocp.Checkpointer(handler).save(path, tree, save_args=args)
    return path


@pytest.mark.parametrize("ocdbt", [True, False], ids=["ocdbt", "zarr_dirs"])
@pytest.mark.parametrize("chunk_bytes", [None, 512], ids=["one_chunk", "chunks"])
def test_reader_equals_orbax_restore(tmp_path, ocdbt, chunk_bytes):
    path = _save(str(tmp_path / "ck"), _tree(), ocdbt, chunk_bytes)
    assert_same_tree(read_pytree(path), ocp.PyTreeCheckpointer().restore(path))
    meta = json.load(open(os.path.join(path, "_METADATA")))
    assert meta["use_ocdbt"] is ocdbt and meta["use_zarr3"] is False


def test_values_out_of_line_and_inline(tmp_path):
    """The checkpoint holds both kinds of value; the reader's references say
    which, and each is read back as orbax reads it."""
    path = _save(str(tmp_path / "ck"), _tree(1))
    refs = dict(OcdbtDatabase(path).items())
    indirect = {k for k, v in refs.items() if not isinstance(v, bytes)}
    assert b"params.embed/0.0" in indirect and b"count/0" not in indirect
    assert all(k.endswith(b".zarray") is False for k in indirect)
    assert_same_tree(read_pytree(path), ocp.PyTreeCheckpointer().restore(path))


@pytest.mark.parametrize("node_bytes", [120, 400])
def test_multi_level_btree_against_tensorstore(tmp_path, node_bytes):
    """A b-tree of several levels: the key walk equals tensorstore's list()
    and every value its read(), inline and out of line."""
    root = tmp_path / "db"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}",
                          "config": {"max_decoded_node_bytes": node_bytes,
                                     "max_inline_value_bytes": 24}}).result()
    rng = np.random.default_rng(node_bytes)
    for i in rng.permutation(60):
        kv.write(f"layer{i:03d}/w.{i % 3}", rng.bytes(int(rng.integers(0, 64)))).result()
    db = OcdbtDatabase(str(root))
    height = db._root()[0]
    assert height >= 2                        # interior nodes, not one leaf
    keys = [k for k, _ in db.items()]
    assert keys == sorted(kv.list().result())
    for k in keys:
        assert db.get(k.decode()) == kv.read(k).result().value, k


def test_zarr_arrays_in_a_multi_level_btree(tmp_path):
    """An orbax-shaped checkpoint whose OCDBT b-tree has interior nodes
    (written as zarr by tensorstore over an `ocdbt` kvstore with small
    nodes): read_pytree against the arrays written."""
    root = tmp_path / "ck"
    base = {"driver": "ocdbt", "base": f"file://{root}",
            "config": {"max_decoded_node_bytes": 256}}
    rng = np.random.default_rng(3)
    want, tree_meta = {}, {}
    for i in range(12):
        name = f"w{i:02d}"
        arr = rng.standard_normal((9, 5 + i)).astype(np.float32)
        ts.open({"driver": "zarr", "kvstore": {**base, "path": name},
                 "metadata": {"shape": list(arr.shape), "chunks": [4, 3], "dtype": "<f4",
                              "compressor": {"id": "zstd", "level": 1}},
                 "create": True}).result().write(arr).result()
        want[name] = arr
        tree_meta[str((name,))] = {"key_metadata": [{"key": name, "key_type": 2}],
                                   "value_metadata": {"value_type": "np.ndarray",
                                                      "skip_deserialize": False}}
    (root / "_METADATA").write_text(json.dumps({"tree_metadata": tree_meta, "use_ocdbt": True,
                                                "use_zarr3": False}))
    assert OcdbtDatabase(str(root))._root()[0] >= 1
    got = read_pytree(str(root))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].tobytes() == v.tobytes(), k
    assert_same_tree(got, ocp.PyTreeCheckpointer().restore(str(root)))


def test_empty_and_absent_chunks(tmp_path):
    """An empty array (orbax refuses to save one: tensorstore writes it) and
    a chunk never written (the fill value, or zeros where it is null)."""
    def kv(name):
        return {"driver": "file", "path": f"{tmp_path}/{name}/"}

    ts.open({"driver": "zarr", "kvstore": kv("empty"),
             "metadata": {"shape": [0, 3], "chunks": [2, 3], "dtype": "<f4", "compressor": None},
             "create": True}).result()
    store = ts.open({"driver": "zarr", "kvstore": kv("partial"),
                     "metadata": {"shape": [4, 4], "chunks": [2, 2], "dtype": "<i4",
                                  "fill_value": 7, "compressor": {"id": "zstd", "level": 1}},
                     "create": True}).result()
    store[0:2, 2:4].write(np.arange(4, dtype=np.int32).reshape(2, 2)).result()
    ts.open({"driver": "zarr", "kvstore": kv("nofill"),
             "metadata": {"shape": [3], "chunks": [2], "dtype": "<f8", "fill_value": None,
                          "compressor": None},
             "create": True}).result()

    def get(key):
        p = tmp_path / key
        return p.read_bytes() if p.is_file() else None

    empty = read_zarr(get, "empty")
    assert empty.shape == (0, 3) and empty.dtype == np.float32
    want = np.full((4, 4), 7, np.int32)
    want[0:2, 2:4] = np.arange(4).reshape(2, 2)
    np.testing.assert_array_equal(read_zarr(get, "partial"), want)
    np.testing.assert_array_equal(read_zarr(get, "nofill"), np.zeros(3))


def _nodes_and_manifests(path):
    out = []
    for root, _, files in os.walk(path):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                head = fh.read(4)
            if head in (b"\x0c\xdb\x3a\x2a", b"\x0c\xdb\x20\xde"):
                out.append(p)
    return sorted(out)


@pytest.mark.parametrize("where", ["root_manifest", "process_manifest", "node", "crc"])
def test_a_flipped_byte_raises(tmp_path, where):
    path = _save(str(tmp_path / "ck"), _tree(2))
    files = _nodes_and_manifests(path)
    target = {"root_manifest": os.path.join(path, "manifest.ocdbt"),
              "process_manifest": os.path.join(path, "ocdbt.process_0", "manifest.ocdbt"),
              "node": next(p for p in files if os.sep + "d" + os.sep in p),
              "crc": os.path.join(path, "manifest.ocdbt")}[where]
    data = bytearray(open(target, "rb").read())
    data[-2 if where == "crc" else len(data) // 2] ^= 0x10
    open(target, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        if where == "process_manifest":
            OcdbtDatabase(os.path.join(path, "ocdbt.process_0"))._root()
        else:
            read_pytree(path)


def test_crc32c_and_frames():
    assert crc32c(b"123456789") == 0xE3069283         # the Castagnoli check value
    assert crc32c(b"") == 0
    with pytest.raises(ValueError, match="magic"):
        unframe(b"\x00" * 32, NODE_MAGIC, "x")


def test_zstd_binding_against_zstandard():
    """native.zstd_decompress on frames with and without their content size
    (zarr's chunks carry none), with the size given or streamed."""
    zstandard = pytest.importorskip("zstandard")
    rng = np.random.default_rng(0)
    for n in (0, 1, 1000, 300_000):
        data = rng.integers(0, 5, n, dtype=np.uint8).tobytes()
        for with_size in (True, False):
            frame = zstandard.ZstdCompressor(level=1, write_content_size=with_size).compress(data)
            assert native.zstd_decompress(frame) == data
            assert native.zstd_decompress(frame, size_hint=n) == data
    with pytest.raises(ValueError, match="zstd"):
        native.zstd_decompress(frame, size_hint=n + 1)
    with pytest.raises(ValueError, match="truncated"):
        native.zstd_decompress(frame[:-7])
    assert native.zstd_version().count(".") == 2


def test_refusals(tmp_path):
    path = _save(str(tmp_path / "ck"), _tree(3))
    plain = tmp_path / "not_orbax"
    plain.mkdir()
    with pytest.raises(ValueError, match="_METADATA"):
        read_pytree(str(plain))
    meta_path = os.path.join(path, "_METADATA")
    meta = json.load(open(meta_path))
    json.dump(dict(meta, use_zarr3=True), open(meta_path, "w"))
    with pytest.raises(ValueError, match="zarr v3"):
        read_pytree(path)

    def zarray(**over):
        meta = {"zarr_format": 2, "shape": [2], "chunks": [2], "dtype": "<f4", "order": "C",
                "compressor": None, "fill_value": None, "filters": None}
        return {"a/.zarray": json.dumps(dict(meta, **over)).encode()}.get

    with pytest.raises(ValueError, match="order 'F'"):
        read_zarr(zarray(order="F"), "a")
    with pytest.raises(ValueError, match="compressor 'blosc'"):
        read_zarr(zarray(compressor={"id": "blosc"}), "a")
    with pytest.raises(ValueError, match="dtype"):
        read_zarr(zarray(dtype="<c8"), "a")


def test_without_libzstd_the_reader_names_it(tmp_path, monkeypatch):
    path = _save(str(tmp_path / "ck"), _tree(4))
    monkeypatch.setattr(native, "ZSTD_LIBRARIES", ("libzstd.so.no-such-version",))
    monkeypatch.setattr(native, "_zstd", None)
    with pytest.raises(ImportError, match="libzstd"):
        read_pytree(path)


def test_orbax_directory_copy_reads_the_same(tmp_path):
    """The reader reads only what the directory holds: a copy elsewhere (as
    a checkpoint moves between machines) reads the same."""
    path = _save(str(tmp_path / "ck"), _tree(5))
    moved = str(tmp_path / "moved" / "ck")
    shutil.copytree(path, moved)
    shutil.rmtree(path)
    assert_same_tree(read_pytree(moved), ocp.PyTreeCheckpointer().restore(moved))

"""PLY mesh loader (ASCII + binary little/big endian).

A copy of `poet_tpu/evaluation/ply.py` (the port imports nothing of
`poet_tpu`). Host-side numpy; parity target:
evaluation_tools/model_tools.py:25-206 (BOP-toolkit-style loader returning
{'pts', 'normals', 'colors', 'faces'}).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

_STRUCT_FMT = {
    "char": "b", "int8": "b",
    "uchar": "B", "uint8": "B",
    "short": "h", "int16": "h",
    "ushort": "H", "uint16": "H",
    "int": "i", "int32": "i",
    "uint": "I", "uint32": "I",
    "float": "f", "float32": "f",
    "double": "d", "float64": "d",
}
_SIZES = {k: struct.calcsize(v) for k, v in _STRUCT_FMT.items()}


def load_ply(path: str) -> Dict[str, np.ndarray]:
    """Load a PLY file -> dict with 'pts' (N, 3) and optionally 'normals',
    'colors', 'texture_uv', 'faces' (M, 3)."""
    with open(path, "rb") as f:
        header, fmt = _read_header(f)
        elements = header["elements"]
        data: Dict[str, Any] = {}
        for elem_name, count, props in elements:
            if fmt == "ascii":
                rows = _read_ascii_element(f, count, props)
            else:
                rows = _read_binary_element(f, count, props, fmt)
            data[elem_name] = (props, rows)

    out: Dict[str, np.ndarray] = {}
    if "vertex" in data:
        props, rows = data["vertex"]
        names = [p[0] for p in props]

        def cols(keys):
            if all(k in names for k in keys):
                idx = [names.index(k) for k in keys]
                return np.stack([rows[:, i] for i in idx], axis=1)
            return None

        pts = cols(["x", "y", "z"])
        assert pts is not None, "PLY file has no x/y/z vertex properties"
        out["pts"] = pts.astype(np.float64)
        normals = cols(["nx", "ny", "nz"])
        if normals is not None:
            out["normals"] = normals.astype(np.float64)
        colors = cols(["red", "green", "blue"])
        if colors is not None:
            out["colors"] = colors.astype(np.float64)
        uv = cols(["texture_u", "texture_v"])
        if uv is not None:
            out["texture_uv"] = uv.astype(np.float64)
    if "face" in data:
        props, rows = data["face"]
        out["faces"] = np.asarray(rows, dtype=np.int64)
    return out


def _read_header(f) -> Tuple[Dict[str, Any], str]:
    magic = f.readline().strip()
    assert magic == b"ply", f"not a PLY file (magic={magic!r})"
    fmt = None
    elements: List[Tuple[str, int, list]] = []
    current = None
    while True:
        raw = f.readline()
        if not raw:
            # EOF before end_header: raise instead of spinning forever on
            # the empty readline() of a truncated/corrupt file
            raise ValueError("truncated PLY header: no end_header before EOF")
        line = raw.decode("ascii", errors="replace").strip()
        if line.startswith("comment") or not line:
            continue
        toks = line.split()
        if toks[0] == "format":
            fmt = toks[1]  # ascii | binary_little_endian | binary_big_endian
        elif toks[0] == "element":
            current = (toks[1], int(toks[2]), [])
            elements.append(current)
        elif toks[0] == "property":
            if toks[1] == "list":
                current[2].append((toks[4], "list", toks[2], toks[3]))
            else:
                current[2].append((toks[2], toks[1]))
        elif toks[0] == "end_header":
            break
    return {"elements": elements}, fmt


def _read_ascii_element(f, count, props):
    rows = []
    has_list = any(len(p) == 4 for p in props)
    for _ in range(count):
        toks = f.readline().split()
        if has_list:
            # face-style: first token is the list length
            n = int(toks[0])
            if n != 3:
                # BOP-toolkit/reference behavior (model_tools.py): only
                # triangular faces — silently dropping vertices would yield
                # wrong geometry
                raise ValueError(f"only triangular PLY faces supported, got {n}")
            rows.append([float(t) for t in toks[1 : 1 + n]])
        else:
            rows.append([float(t) for t in toks[: len(props)]])
    return np.asarray(rows, dtype=np.float64)


def _read_binary_element(f, count, props, fmt):
    endian = "<" if fmt == "binary_little_endian" else ">"
    has_list = any(len(p) == 4 for p in props)
    if not has_list:
        fmt_str = endian + "".join(_STRUCT_FMT[p[1]] for p in props)
        size = struct.calcsize(fmt_str)
        buf = f.read(size * count)
        it = struct.iter_unpack(fmt_str, buf)
        return np.asarray([row for row in it], dtype=np.float64)
    rows = []
    for _ in range(count):
        row = []
        for p in props:
            if len(p) == 4:
                _, _, len_type, val_type = p
                (n,) = struct.unpack(endian + _STRUCT_FMT[len_type], f.read(_SIZES[len_type]))
                if n != 3:
                    raise ValueError(
                        f"only triangular PLY faces supported, got {n}")
                vals = struct.unpack(
                    endian + _STRUCT_FMT[val_type] * n, f.read(_SIZES[val_type] * n)
                )
                row.extend(vals)
            else:
                (v,) = struct.unpack(endian + _STRUCT_FMT[p[1]], f.read(_SIZES[p[1]]))
                row.append(v)
        rows.append(row)
    return np.asarray(rows, dtype=np.float64)

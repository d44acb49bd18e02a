"""PLY point-cloud IO (ascii + binary little/big endian), numpy-vectorized.

Replaces the reference's PCL loadPLYFile usage (src/lidar/ply.cc:14) and the
sparse PLY helpers (src/util/ply.{h,cc}). Reads arbitrary vertex properties;
returns xyz, normals and colors when present. Writing emits binary little
endian by default.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclass
class PlyData:
    xyz: np.ndarray  # [N,3] float
    normals: np.ndarray | None = None  # [N,3] float
    colors: np.ndarray | None = None  # [N,3] uint8
    extra: dict = field(default_factory=dict)


def read_ply(path: str) -> PlyData:
    with open(path, "rb") as f:
        data = f.read()

    # --- header ---
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header_end = data.find(b"\n", end) + 1
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    if not header or header[0].strip() != "ply":
        raise ValueError(f"{path}: missing 'ply' magic")

    fmt = None
    n_vertex = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    for line in header[1:]:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            in_vertex = tok[1] == "vertex"
            if in_vertex:
                n_vertex = int(tok[2])
        elif tok[0] == "property" and in_vertex:
            if tok[1] == "list":
                raise ValueError("list properties unsupported on vertex element")
            props.append((tok[2], _PLY_DTYPES[tok[1]]))

    names = [n for n, _ in props]
    if fmt == "ascii":
        text = data[header_end:].decode("ascii")
        arr = np.loadtxt(text.splitlines()[:n_vertex], dtype=np.float64, ndmin=2)
        cols = {n: arr[:, i] for i, (n, _) in enumerate(props)}
    else:
        endian = "<" if "little" in fmt else ">"
        dt = np.dtype([(n, endian + t) for n, t in props])
        arr = np.frombuffer(data, dtype=dt, count=n_vertex, offset=header_end)
        cols = {n: arr[n] for n in names}

    def grab3(a, b, c, dtype=np.float32):
        if a in cols and b in cols and c in cols:
            return np.stack(
                [np.asarray(cols[a], dtype), np.asarray(cols[b], dtype), np.asarray(cols[c], dtype)],
                axis=-1,
            )
        return None

    xyz = grab3("x", "y", "z")
    if xyz is None:
        raise ValueError(f"{path}: vertex element lacks x/y/z")
    normals = grab3("nx", "ny", "nz")
    if normals is None:
        normals = grab3("normal_x", "normal_y", "normal_z")
    colors = grab3("red", "green", "blue", np.uint8)
    extra = {
        n: np.asarray(cols[n])
        for n in names
        if n not in ("x", "y", "z", "nx", "ny", "nz", "normal_x", "normal_y", "normal_z", "red", "green", "blue")
    }
    return PlyData(xyz=xyz, normals=normals, colors=colors, extra=extra)


def write_ply(
    path: str,
    xyz: np.ndarray,
    normals: np.ndarray | None = None,
    colors: np.ndarray | None = None,
    binary: bool = True,
) -> None:
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    fields: list[tuple[str, str, np.ndarray]] = [
        ("x", "float", xyz[:, 0]), ("y", "float", xyz[:, 1]), ("z", "float", xyz[:, 2])
    ]
    if normals is not None:
        normals = np.asarray(normals, np.float32)
        fields += [("nx", "float", normals[:, 0]), ("ny", "float", normals[:, 1]), ("nz", "float", normals[:, 2])]
    if colors is not None:
        colors = np.asarray(colors, np.uint8)
        fields += [("red", "uchar", colors[:, 0]), ("green", "uchar", colors[:, 1]), ("blue", "uchar", colors[:, 2])]

    hdr = ["ply"]
    hdr.append("format binary_little_endian 1.0" if binary else "format ascii 1.0")
    hdr.append(f"element vertex {n}")
    for name, t, _ in fields:
        hdr.append(f"property {t} {name}")
    hdr.append("end_header")
    header = ("\n".join(hdr) + "\n").encode("ascii")

    with open(path, "wb") as f:
        f.write(header)
        if binary:
            dt = np.dtype([(name, "<" + _PLY_DTYPES[t]) for name, t, _ in fields])
            rec = np.empty(n, dtype=dt)
            for name, _, col in fields:
                rec[name] = col
            f.write(rec.tobytes())
        else:
            cols = np.stack([c.astype(np.float64) for _, _, c in fields], axis=-1)
            np.savetxt(f, cols, fmt="%.6f")


def write_ply_mesh(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    colors: np.ndarray | None = None,
    binary: bool = True,
) -> None:
    """Triangle mesh writer (vertex + face elements), as WriteBinaryPlyMesh
    (src/util/ply.cc) produces for the meshers."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    nv, nf = verts.shape[0], faces.shape[0]
    hdr = ["ply"]
    hdr.append("format binary_little_endian 1.0" if binary else "format ascii 1.0")
    hdr.append(f"element vertex {nv}")
    hdr += ["property float x", "property float y", "property float z"]
    if colors is not None:
        hdr += ["property uchar red", "property uchar green", "property uchar blue"]
    hdr.append(f"element face {nf}")
    hdr.append("property list uchar int vertex_index")
    hdr.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(hdr) + "\n").encode("ascii"))
        if binary:
            if colors is None:
                f.write(verts.astype("<f4").tobytes())
            else:
                dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                               ("r", "u1"), ("g", "u1"), ("b", "u1")])
                rec = np.empty(nv, dt)
                rec["x"], rec["y"], rec["z"] = verts.T
                rec["r"], rec["g"], rec["b"] = np.asarray(colors, np.uint8).T
                f.write(rec.tobytes())
            fdt = np.dtype([("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])
            frec = np.empty(nf, fdt)
            frec["n"] = 3
            frec["a"], frec["b"], frec["c"] = faces.T
            f.write(frec.tobytes())
        else:
            for v in verts:
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n".encode())
            for t in faces:
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n".encode())


def read_ply_mesh(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read back (verts, faces) from a mesh written by write_ply_mesh
    (binary little endian, uchar-count int32-index face lists)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    header_end = data.find(b"\n", end) + 1
    header = data[:header_end].decode("ascii").splitlines()
    nv = nf = 0
    vprops = 0
    cur = None
    binary = True
    for line in header:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "format":
            binary = "binary" in tok[1]
        elif tok[0] == "element":
            cur = tok[1]
            if cur == "vertex":
                nv = int(tok[2])
            elif cur == "face":
                nf = int(tok[2])
        elif tok[0] == "property" and cur == "vertex" and tok[1] != "list":
            vprops += 1
    if binary:
        vdt = np.dtype([(f"p{i}", "<f4" if i < 3 else "u1") for i in range(vprops)])
        varr = np.frombuffer(data, vdt, count=nv, offset=header_end)
        verts = np.stack([varr["p0"], varr["p1"], varr["p2"]], axis=-1)
        fdt = np.dtype([("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])
        farr = np.frombuffer(data, fdt, count=nf, offset=header_end + nv * vdt.itemsize)
        faces = np.stack([farr["a"], farr["b"], farr["c"]], axis=-1).astype(np.int32)
    else:
        lines = data[header_end:].decode("ascii").splitlines()
        verts = np.array([[float(x) for x in l.split()[:3]] for l in lines[:nv]], np.float32)
        faces = np.array([[int(x) for x in l.split()[1:4]] for l in lines[nv : nv + nf]], np.int32)
    return verts, faces

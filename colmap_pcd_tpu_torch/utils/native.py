"""ctypes bindings for the native host runtime (cpp/native.cpp).

Builds the shared library on first use (g++, seconds) from the repo's `cpp/`,
which the JAX package builds too. Every consumer has a numpy fallback, so
the package works without a toolchain; a failed build is logged. The native
path is the host-side kd-tree (FLANN's role in the reference, and the
`backend="host"` of `LidarMap.nn_query`, with its radius search) and the
bulk correspondence graph (the CSR build and the incremental `NativeCorrGraph`).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

_CPP_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "cpp")


def _make() -> None:
    """Run cpp/Makefile. A $CXX that cannot link OpenMP (its install has
    no libgomp.spec) is retried with the g++ on PATH."""
    attempts = [["make", "-sB"]]
    if os.environ.get("CXX"):
        attempts.append(["make", "-sB", "CXX=g++"])
    errors = []
    for cmd in attempts:
        proc = subprocess.run(cmd, cwd=_CPP_DIR, capture_output=True, text=True)
        if proc.returncode == 0:
            return
        errors.append(f"{' '.join(cmd)}: {proc.stderr.strip()}")
    raise RuntimeError("\n".join(errors))


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = os.path.join(_CPP_DIR, "libnative.so")
        src = os.path.join(_CPP_DIR, "native.cpp")
        hash_file = os.path.join(_CPP_DIR, ".native.hash")
        try:
            # rebuild keyed on a source content hash, not mtime: git checkouts
            # do not preserve mtimes, and the .so is never committed, so a
            # stale/foreign-arch binary must not be silently loaded
            with open(src, "rb") as f:
                src_hash = hashlib.sha256(f.read()).hexdigest()
            built_hash = None
            if os.path.exists(hash_file):
                with open(hash_file) as f:
                    built_hash = f.read().strip()
            if not os.path.exists(so) or built_hash != src_hash:
                _make()
                with open(hash_file, "w") as f:
                    f.write(src_hash)
            lib = ctypes.CDLL(so)
        except Exception as e:
            logging.getLogger(__name__).warning(
                "native host runtime unavailable, using the numpy fallbacks: %s", e
            )
            return None
        c_fp = ctypes.POINTER(ctypes.c_float)
        c_i32 = ctypes.POINTER(ctypes.c_int32)
        c_i64 = ctypes.POINTER(ctypes.c_int64)
        lib.kdtree_build.restype = ctypes.c_void_p
        lib.kdtree_build.argtypes = [c_fp, ctypes.c_int32]
        lib.kdtree_nn.argtypes = [ctypes.c_void_p, c_fp, ctypes.c_int32, c_i32, c_fp]
        lib.kdtree_radius.argtypes = [
            ctypes.c_void_p, c_fp, ctypes.c_int32, ctypes.c_float, ctypes.c_int32, c_i32, c_i32,
        ]
        lib.kdtree_free.argtypes = [ctypes.c_void_p]
        lib.cg_create.restype = ctypes.c_void_p
        lib.cg_add_matches.argtypes = [ctypes.c_void_p, c_i64, c_i64, ctypes.c_int32]
        lib.cg_find.argtypes = [ctypes.c_void_p, c_i64, ctypes.c_int32, ctypes.c_int32, c_i64, c_i32]
        lib.cg_num_nodes.restype = ctypes.c_int64
        lib.cg_num_nodes.argtypes = [ctypes.c_void_p]
        lib.cg_free.argtypes = [ctypes.c_void_p]
        lib.cg_build_csr.restype = ctypes.c_int64
        lib.cg_build_csr.argtypes = [c_i64, c_i64, ctypes.c_int64, c_i64, c_i64, c_i64]
        _lib = lib
        return _lib


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class NativeKdTree:
    """Exact 3D kd-tree with batched OpenMP queries (host-side NN path)."""

    def __init__(self, points: np.ndarray):
        self.lib = get_lib()
        self.points = np.ascontiguousarray(points, np.float32)
        if self.lib is None:
            self.handle = None
        else:
            self.handle = self.lib.kdtree_build(_fp(self.points), len(self.points))

    def nn(self, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(indices [Q], distances [Q])."""
        q = np.ascontiguousarray(queries, np.float32)
        n = len(q)
        if self.handle is None:  # numpy fallback (O(QN), fine for tests)
            d = np.linalg.norm(self.points[None] - q[:, None], axis=-1)
            idx = np.argmin(d, axis=1)
            return idx.astype(np.int32), d[np.arange(n), idx]
        idx = np.empty(n, np.int32)
        d2 = np.empty(n, np.float32)
        self.lib.kdtree_nn(self.handle, _fp(q), n, _i32(idx), _fp(d2))
        return idx, np.sqrt(d2)

    def radius(self, queries: np.ndarray, radius: float, cap: int = 64):
        """(indices [Q, cap], counts [Q]): up to `cap` points within `radius`."""
        q = np.ascontiguousarray(queries, np.float32)
        n = len(q)
        out_idx = np.zeros((n, cap), np.int32)
        cnt = np.zeros(n, np.int32)
        if self.handle is None:
            d = np.linalg.norm(self.points[None] - q[:, None], axis=-1)
            for i in range(n):
                sel = np.nonzero(d[i] <= radius)[0][:cap]
                out_idx[i, : len(sel)] = sel
                cnt[i] = len(sel)
            return out_idx, cnt
        self.lib.kdtree_radius(self.handle, _fp(q), n, radius, cap, _i32(out_idx), _i32(cnt))
        return out_idx, cnt

    def __del__(self):
        if getattr(self, "handle", None) and self.lib is not None:
            self.lib.kdtree_free(self.handle)


FEAT_BITS = 20  # (image_id << 20) | feat_idx packing


def pack_key(image_id, feat_idx):
    return (np.asarray(image_id, np.int64) << FEAT_BITS) | np.asarray(feat_idx, np.int64)


def unpack_key(key):
    key = np.asarray(key, np.int64)
    return key >> FEAT_BITS, key & ((1 << FEAT_BITS) - 1)


def build_csr(keys1: np.ndarray, keys2: np.ndarray):
    """Bulk CSR adjacency build over packed edge arrays.

    Returns (keys [M] sorted unique, off [M+1], nbr [E2]) where nbr holds
    neighbor keys grouped by source key (both edge directions). Native C++
    (cpp/native.cpp cg_build_csr) when available, numpy argsort fallback —
    this is the bulk replacement for the reference's per-feature C++
    correspondence walks (src/base/correspondence_graph.h:45-116)."""
    k1 = np.ascontiguousarray(keys1, np.int64)
    k2 = np.ascontiguousarray(keys2, np.int64)
    n = len(k1)
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(1, np.int64), np.zeros(0, np.int64))
    lib = get_lib()
    if lib is not None:
        out_keys = np.empty(2 * n, np.int64)
        out_off = np.empty(2 * n + 1, np.int64)
        out_nbr = np.empty(2 * n, np.int64)
        m = lib.cg_build_csr(_i64(k1), _i64(k2), n, _i64(out_keys), _i64(out_off), _i64(out_nbr))
        return out_keys[:m].copy(), out_off[: m + 1].copy(), out_nbr
    src = np.concatenate([k1, k2])
    dst = np.concatenate([k2, k1])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    keys, starts = np.unique(src, return_index=True)
    off = np.concatenate([starts, [len(src)]]).astype(np.int64)
    return keys, off, dst


class NativeCorrGraph:
    """Bulk correspondence adjacency (C++ CSR); without the library, dicts."""

    def __init__(self):
        self.lib = get_lib()
        self.handle = self.lib.cg_create() if self.lib is not None else None
        self._py: dict[int, list[int]] = {}

    def add_matches(self, image_id1: int, image_id2: int, matches: np.ndarray):
        k1 = np.ascontiguousarray(pack_key(image_id1, matches[:, 0]))
        k2 = np.ascontiguousarray(pack_key(image_id2, matches[:, 1]))
        if self.handle is not None:
            self.lib.cg_add_matches(self.handle, _i64(k1), _i64(k2), len(k1))
            return
        for a, b in zip(k1.tolist(), k2.tolist()):
            self._py.setdefault(a, []).append(b)
            self._py.setdefault(b, []).append(a)

    def find_batch(self, image_id: int, feat_idx: np.ndarray, cap: int = 32):
        """For each feature: neighbour (image_id, feat) arrays [Q, cap] and counts [Q]."""
        keys = np.ascontiguousarray(pack_key(image_id, feat_idx))
        n = len(keys)
        out = np.zeros((n, cap), np.int64)
        cnt = np.zeros(n, np.int32)
        if self.handle is not None:
            self.lib.cg_find(self.handle, _i64(keys), n, cap, _i64(out), _i32(cnt))
        else:
            for i, k in enumerate(keys.tolist()):
                nb = self._py.get(k, [])[:cap]
                out[i, : len(nb)] = nb
                cnt[i] = len(nb)
        imgs, feats = unpack_key(out)
        return imgs, feats, cnt

    def __del__(self):
        if getattr(self, "handle", None) and self.lib is not None:
            self.lib.cg_free(self.handle)

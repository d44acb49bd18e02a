"""SQLite persistence, schema-compatible with COLMAP 3.8 databases.

Parity with src/base/database.{h,cc}: tables cameras / images / keypoints /
descriptors / matches / two_view_geometries with the same blob layouts
(database.cc:1285-1380 schema, :50-110 blob (de)serialization), so databases
produced by either system open in the other. Keypoints are stored as float32
rows of 6 (x, y, a11, a12, a21, a22 affine shape — we write scale/orientation
folded into the affine form like COLMAP's FeatureKeypoint), descriptors as
uint8 [N,128], matches as uint32 [M,2] keyed by the packed pair id.
"""

from __future__ import annotations

import sqlite3

import numpy as np

MAX_IMAGE_ID = 2147483647


def image_pair_to_pair_id(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def pair_id_to_image_pair(pid: int) -> tuple[int, int]:
    image_id2 = pid % MAX_IMAGE_ID
    image_id1 = (pid - image_id2) // MAX_IMAGE_ID
    return image_id1, image_id2


_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


class Database:
    def __init__(self, path: str):
        # check_same_thread=False: the extraction pipeline writes from a single
        # dedicated writer thread (threading_utils.pipeline_map), never two at once
        self.conn = sqlite3.connect(path, check_same_thread=False, timeout=30.0)
        # WAL lets the overlapped pipeline read (matcher/mapper threads, their
        # own connections) while the extractor writes
        try:
            self.conn.execute("PRAGMA journal_mode=WAL")
        except sqlite3.OperationalError:
            pass  # e.g. read-only or network filesystem
        self.conn.executescript(_SCHEMA)
        self.conn.commit()

    def close(self):
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.conn.commit()
        self.close()

    # ------------------------------------------------------------- cameras
    def add_camera(self, model_id: int, width: int, height: int, params, prior_focal=False, camera_id=None) -> int:
        blob = np.asarray(params, np.float64).tobytes()
        cur = self.conn.execute(
            "INSERT OR REPLACE INTO cameras(camera_id, model, width, height, params, prior_focal_length)"
            " VALUES(?,?,?,?,?,?)",
            (camera_id, model_id, width, height, blob, int(prior_focal)),
        )
        return cur.lastrowid

    def cameras(self):
        out = {}
        for cid, model, w, h, params, prior in self.conn.execute(
            "SELECT camera_id, model, width, height, params, prior_focal_length FROM cameras"
        ):
            out[cid] = dict(
                model_id=model, width=w, height=h,
                params=np.frombuffer(params, np.float64).copy(), prior_focal=bool(prior),
            )
        return out

    # -------------------------------------------------------------- images
    def add_image(self, name: str, camera_id: int, image_id=None) -> int:
        cur = self.conn.execute(
            "INSERT OR REPLACE INTO images(image_id, name, camera_id) VALUES(?,?,?)",
            (image_id, name, camera_id),
        )
        return cur.lastrowid

    def images(self):
        out = {}
        for iid, name, cid in self.conn.execute("SELECT image_id, name, camera_id FROM images"):
            out[iid] = dict(name=name, camera_id=cid)
        return out

    # ----------------------------------------------------------- keypoints
    def write_keypoints(self, image_id: int, keypoints: np.ndarray):
        """keypoints [N,>=2] float32; stored as [N,6] affine form
        (x, y, a11, a12, a21, a22). [N,4] (x,y,scale,ori) is converted.

        Coordinate convention at the DB boundary: this framework works in
        array-index coordinates (pixel centers at integer coords); COLMAP
        stores keypoints with the upper-left pixel center at (0.5, 0.5)
        (base/feature/types.h). We add +0.5 on write and subtract it on
        read so databases produced by either system open in the other with
        no systematic offset."""
        kp = np.asarray(keypoints, np.float32).copy()
        kp[:, :2] += 0.5
        n = kp.shape[0]
        if kp.shape[1] == 2:
            kp = np.concatenate([kp, np.tile([1, 0, 0, 1], (n, 1)).astype(np.float32)], axis=1)
        elif kp.shape[1] == 4:
            s, o = kp[:, 2], kp[:, 3]
            a = np.stack([s * np.cos(o), -s * np.sin(o), s * np.sin(o), s * np.cos(o)], axis=-1)
            kp = np.concatenate([kp[:, :2], a.astype(np.float32)], axis=1)
        assert kp.shape[1] == 6
        self.conn.execute(
            "INSERT OR REPLACE INTO keypoints(image_id, rows, cols, data) VALUES(?,?,?,?)",
            (image_id, n, 6, kp.tobytes()),
        )

    def read_keypoints(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?", (image_id,)
        ).fetchone()
        if row is None:
            return np.zeros((0, 6), np.float32)
        n, c, data = row
        kp = np.frombuffer(data, np.float32).reshape(n, c).copy()
        kp[:, :2] -= 0.5  # COLMAP pixel-center convention -> array coords
        return kp

    # --------------------------------------------------------- descriptors
    def write_descriptors(self, image_id: int, desc: np.ndarray):
        d = np.asarray(desc, np.uint8)
        self.conn.execute(
            "INSERT OR REPLACE INTO descriptors(image_id, rows, cols, data) VALUES(?,?,?,?)",
            (image_id, d.shape[0], d.shape[1], d.tobytes()),
        )

    def read_descriptors(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM descriptors WHERE image_id=?", (image_id,)
        ).fetchone()
        if row is None:
            return np.zeros((0, 128), np.uint8)
        n, c, data = row
        return np.frombuffer(data, np.uint8).reshape(n, c).copy()

    # ------------------------------------------------------------- matches
    def write_matches(self, image_id1: int, image_id2: int, matches: np.ndarray):
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1].copy()
        self.conn.execute(
            "INSERT OR REPLACE INTO matches(pair_id, rows, cols, data) VALUES(?,?,?,?)",
            (image_pair_to_pair_id(image_id1, image_id2), m.shape[0], 2, m.tobytes()),
        )

    def read_matches(self, image_id1: int, image_id2: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, data FROM matches WHERE pair_id=?",
            (image_pair_to_pair_id(image_id1, image_id2),),
        ).fetchone()
        if row is None:
            return np.zeros((0, 2), np.uint32)
        n, data = row
        m = np.frombuffer(data, np.uint32).reshape(n, 2).copy()
        if image_id1 > image_id2:
            m = m[:, ::-1].copy()
        return m

    # ------------------------------------------- two-view geometries
    def write_two_view_geometry(
        self, image_id1: int, image_id2: int, inlier_matches: np.ndarray,
        config: int, F=None, E=None, H=None, qvec=None, tvec=None,
    ):
        m = np.asarray(inlier_matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1].copy()

        def b(x, n):
            return (np.asarray(x, np.float64).tobytes() if x is not None else np.zeros(n, np.float64).tobytes())

        self.conn.execute(
            "INSERT OR REPLACE INTO two_view_geometries"
            "(pair_id, rows, cols, data, config, F, E, H, qvec, tvec) VALUES(?,?,?,?,?,?,?,?,?,?)",
            (
                image_pair_to_pair_id(image_id1, image_id2),
                m.shape[0], 2, m.tobytes(), config,
                b(F, 9), b(E, 9), b(H, 9), b(qvec, 4), b(tvec, 3),
            ),
        )

    def read_two_view_geometry(self, image_id1: int, image_id2: int):
        row = self.conn.execute(
            "SELECT rows, data, config, F, E, H, qvec, tvec FROM two_view_geometries WHERE pair_id=?",
            (image_pair_to_pair_id(image_id1, image_id2),),
        ).fetchone()
        if row is None:
            return None
        n, data, config, F, E, H, qvec, tvec = row
        m = np.frombuffer(data, np.uint32).reshape(n, 2).copy() if n else np.zeros((0, 2), np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1].copy()
        return dict(
            inlier_matches=m, config=config,
            F=np.frombuffer(F, np.float64).reshape(3, 3).copy(),
            E=np.frombuffer(E, np.float64).reshape(3, 3).copy(),
            H=np.frombuffer(H, np.float64).reshape(3, 3).copy(),
            qvec=np.frombuffer(qvec, np.float64).copy(),
            tvec=np.frombuffer(tvec, np.float64).copy(),
        )

    def all_two_view_pair_ids(self):
        return [
            pair_id_to_image_pair(r[0])
            for r in self.conn.execute("SELECT pair_id FROM two_view_geometries WHERE rows > 0")
        ]

    def commit(self):
        self.conn.commit()

"""Interchange model formats: NVM (VisualSFM), Bundler, .cam, VRML.

Parity with the reference's Reconstruction export family
(base/reconstruction.cc: ExportNVM :1003, ExportCam :1091, ExportBundler
:1277, ExportVRML :1384) plus an NVM importer so `model_converter` round
trips the VisualSFM ecosystem. All writers use 17-digit precision like the
reference (no text-precision loss).

A copy of colmap_pcd_tpu/io/model_formats.py (host code, carried: the JAX
package cannot be imported without JAX)."""

from __future__ import annotations

import os

import numpy as np

from ..models.reconstruction import Camera, Image, Reconstruction
from ..ops import camera_models as cm
from ..ops import np_geom


def _fmt(x: float) -> str:
    return f"{float(x):.17g}"


def _nvm_k(cam: Camera, skip_distortion: bool):
    """NVM's single radial coefficient; None = unsupported model
    (reconstruction.cc:1022-1034)."""
    if skip_distortion or cam.model_id in (
        cm.MODEL_IDS["SIMPLE_PINHOLE"], cm.MODEL_IDS["PINHOLE"]
    ):
        return 0.0
    if cam.model_id == cm.MODEL_IDS["SIMPLE_RADIAL"]:
        return -1.0 * cam.params[3]
    return None


def export_nvm(rec: Reconstruction, path: str, skip_distortion: bool = False) -> bool:
    """VisualSFM NVM_V3 (ExportNVM, reconstruction.cc:1003-1090)."""
    lines = ["NVM_V3 ", " ", f"{rec.num_reg_images}  "]
    idx_of: dict[int, int] = {}
    for k, iid in enumerate(rec.registered_ids):
        img = rec.images[iid]
        cam = rec.cameras[img.camera_id]
        kco = _nvm_k(cam, skip_distortion)
        if kco is None:
            print("WARNING: NVM only supports `SIMPLE_RADIAL` and pinhole camera models.")
            return False
        c = img.projection_center()
        q = img.qvec
        lines.append(
            f"{img.name} {_fmt(cam.mean_focal_length())} "
            f"{_fmt(q[0])} {_fmt(q[1])} {_fmt(q[2])} {_fmt(q[3])} "
            f"{_fmt(c[0])} {_fmt(c[1])} {_fmt(c[2])} {_fmt(kco)} 0"
        )
        idx_of[iid] = k
    lines.append("")
    lines.append(str(len(rec.points3D)))
    for p in rec.points3D.values():
        obs, seen = [], set()
        for iid, fidx in p.track:
            # one observation per image (VisualSFM restriction, :1067-1078)
            if iid in seen or iid not in idx_of:
                continue
            seen.add(iid)
            xy = rec.images[iid].xys[fidx]
            obs.append(f"{idx_of[iid]} {fidx} {_fmt(xy[0])} {_fmt(xy[1])}")
        col = p.color
        lines.append(
            f"{_fmt(p.xyz[0])} {_fmt(p.xyz[1])} {_fmt(p.xyz[2])} "
            f"{int(col[0])} {int(col[1])} {int(col[2])} "
            f"{len(obs)} " + " ".join(obs)
        )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return True


def import_nvm(path: str) -> Reconstruction:
    """Read NVM_V3 back into a Reconstruction (one SIMPLE_RADIAL camera per
    image, the NVM camera convention: q + camera center, k = -r)."""
    with open(path) as f:
        tokens = f.read().split()
    assert tokens[0].startswith("NVM_V3"), "not an NVM_V3 file"
    pos = 1
    n_imgs = int(tokens[pos]); pos += 1
    rec = Reconstruction()
    for k in range(n_imgs):
        name = tokens[pos]; pos += 1
        f_, qw, qx, qy, qz, cx, cy, cz, r, _zero = (
            float(tokens[pos + i]) for i in range(10)
        )
        pos += 10
        q = np.asarray([qw, qx, qy, qz])
        q = q / np.linalg.norm(q)
        C = np.asarray([cx, cy, cz])
        t = -np_geom.quat_to_rotmat(q) @ C
        cam = Camera(k + 1, cm.MODEL_IDS["SIMPLE_RADIAL"], 0, 0,
                     np.asarray([f_, 0.0, 0.0, -r]))
        rec.add_camera(cam)
        rec.add_image(Image(k + 1, name, k + 1, qvec=q, tvec=t))
        rec.register_image(k + 1)
    n_pts = int(tokens[pos]); pos += 1
    # first pass: collect per-image max feature index to size xys arrays
    obs_per_pt = []
    for _ in range(n_pts):
        xyz = [float(tokens[pos + i]) for i in range(3)]
        rgb = [int(tokens[pos + 3 + i]) for i in range(3)]
        n_obs = int(tokens[pos + 6])
        pos += 7
        obs = []
        for _o in range(n_obs):
            ii = int(tokens[pos]); fi = int(tokens[pos + 1])
            x = float(tokens[pos + 2]); y = float(tokens[pos + 3])
            pos += 4
            obs.append((ii + 1, fi, x, y))
        obs_per_pt.append((xyz, rgb, obs))
    max_feat = {iid: 0 for iid in rec.images}
    for _, _, obs in obs_per_pt:
        for iid, fi, _, _ in obs:
            max_feat[iid] = max(max_feat.get(iid, 0), fi + 1)
    for iid, nf in max_feat.items():
        img = rec.images[iid]
        img.xys = np.zeros((nf, 2), np.float64)
        img.point3D_ids = np.full(nf, -1, np.int64)
    from ..models.reconstruction import INVALID_POINT3D

    for iid in rec.images:
        img = rec.images[iid]
        if img.point3D_ids.size:
            img.point3D_ids[:] = INVALID_POINT3D
    for xyz, rgb, obs in obs_per_pt:
        track = []
        for iid, fi, x, y in obs:
            img = rec.images[iid]
            img.xys[fi] = (x, y)
            if img.point3D_ids[fi] == INVALID_POINT3D:
                track.append((iid, fi))
        if track:
            rec.add_point3D(np.asarray(xyz), track, color=np.asarray(rgb, np.uint8))
    return rec


def _bundler_k1k2(cam: Camera, skip_distortion: bool):
    if skip_distortion or cam.model_id in (
        cm.MODEL_IDS["SIMPLE_PINHOLE"], cm.MODEL_IDS["PINHOLE"]
    ):
        return 0.0, 0.0
    if cam.model_id == cm.MODEL_IDS["SIMPLE_RADIAL"]:
        return float(cam.params[3]), 0.0
    if cam.model_id == cm.MODEL_IDS["RADIAL"]:
        return float(cam.params[3]), float(cam.params[4])
    return None


def export_bundler(
    rec: Reconstruction, path: str, list_path: str, skip_distortion: bool = False
) -> bool:
    """Bundler v0.3 .out + image list (ExportBundler,
    reconstruction.cc:1277-1375). Bundler's camera frame flips y and z, and
    image coordinates are principal-point-centered with y up."""
    lines = ["# Bundle file v0.3", f"{rec.num_reg_images} {len(rec.points3D)}"]
    names = []
    idx_of: dict[int, int] = {}
    for k, iid in enumerate(rec.registered_ids):
        img = rec.images[iid]
        cam = rec.cameras[img.camera_id]
        kk = _bundler_k1k2(cam, skip_distortion)
        if kk is None:
            print("WARNING: Bundler only supports `SIMPLE_RADIAL`, `RADIAL`, "
                  "and pinhole camera models.")
            return False
        k1, k2 = kk
        R = np_geom.quat_to_rotmat(img.qvec)
        t = img.tvec
        lines.append(f"{_fmt(cam.mean_focal_length())} {_fmt(k1)} {_fmt(k2)}")
        lines.append(f"{_fmt(R[0,0])} {_fmt(R[0,1])} {_fmt(R[0,2])}")
        lines.append(f"{_fmt(-R[1,0])} {_fmt(-R[1,1])} {_fmt(-R[1,2])}")
        lines.append(f"{_fmt(-R[2,0])} {_fmt(-R[2,1])} {_fmt(-R[2,2])}")
        lines.append(f"{_fmt(t[0])} {_fmt(-t[1])} {_fmt(-t[2])}")
        names.append(img.name)
        idx_of[iid] = k
    for p in rec.points3D.values():
        lines.append(f"{_fmt(p.xyz[0])} {_fmt(p.xyz[1])} {_fmt(p.xyz[2])}")
        lines.append(f"{int(p.color[0])} {int(p.color[1])} {int(p.color[2])}")
        obs = []
        for iid, fidx in p.track:
            if iid not in idx_of:
                continue
            img = rec.images[iid]
            cam = rec.cameras[img.camera_id]
            fi_, fj_, ci_, cj_ = cm._FOCAL_IDX[cam.model_id]
            xy = img.xys[fidx]
            # lower-left origin (reconstruction.cc:1356-1365)
            obs.append(
                f"{idx_of[iid]} {fidx} {_fmt(xy[0] - cam.params[ci_])} "
                f"{_fmt(cam.params[cj_] - xy[1])}"
            )
        lines.append(f"{len(obs)} " + " ".join(obs))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(list_path, "w") as f:
        f.write("\n".join(names) + "\n")
    return True


def export_cam(rec: Reconstruction, path: str, skip_distortion: bool = False) -> bool:
    """One MVE-style .cam file per registered image (ExportCam,
    reconstruction.cc:1091-1180): `t R` row, then
    `f_norm k1 k2 paspect ppx_norm ppy_norm`."""
    os.makedirs(path, exist_ok=True)
    for iid in rec.registered_ids:
        img = rec.images[iid]
        cam = rec.cameras[img.camera_id]
        kk = _bundler_k1k2(cam, skip_distortion)
        if kk is None:
            print("WARNING: CAM only supports `SIMPLE_RADIAL`, `RADIAL`, "
                  "and pinhole camera models.")
            return False
        k1, k2 = kk
        name = os.path.splitext(img.name)[0] + ".cam"
        dst = os.path.join(path, name)
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        R = np_geom.quat_to_rotmat(img.qvec)
        t = img.tvec
        fi_, fj_, ci_, cj_ = cm._FOCAL_IDX[cam.model_id]
        p = cam.params
        fx, fy = p[fi_], p[fj_]
        w = max(cam.width, cam.height, 1)
        with open(dst, "w") as f:
            f.write(
                " ".join(_fmt(v) for v in [t[0], t[1], t[2]])
                + " " + " ".join(_fmt(R[i, j]) for i in range(3) for j in range(3))
                + "\n"
            )
            f.write(
                f"{_fmt(fx / w)} {_fmt(k1)} {_fmt(k2)} {_fmt(fy / fx)} "
                f"{_fmt(p[ci_] / cam.width if cam.width else 0.5)} "
                f"{_fmt(p[cj_] / cam.height if cam.height else 0.5)}\n"
            )
    return True


def export_vrml(
    rec: Reconstruction,
    images_path: str,
    points3D_path: str,
    image_scale: float = 1.0,
    image_rgb=(1.0, 0.0, 0.0),
):
    """VRML 2.0 camera glyphs + point set (ExportVRML,
    reconstruction.cc:1384-1500)."""
    six = image_scale * 0.15
    siy = image_scale * 0.1
    base = np.asarray([
        [-six, -siy, six * 2.0], [+six, -siy, six * 2.0],
        [+six, +siy, six * 2.0], [-six, +siy, six * 2.0],
        [0, 0, 0],
        [-six / 3, -siy / 3, six * 2.0], [+six / 3, -siy / 3, six * 2.0],
        [+six / 3, +siy / 3, six * 2.0], [-six / 3, +siy / 3, six * 2.0],
    ])
    r, g, b = image_rgb
    with open(images_path, "w") as f:
        f.write("#VRML V2.0 utf8\n")
        for iid in rec.registered_ids:
            img = rec.images[iid]
            R = np_geom.quat_to_rotmat(img.qvec)
            C = img.projection_center()
            pts = base @ R + C[None, :]  # R^T @ p + C per row
            f.write("Shape{\n appearance Appearance {\n")
            f.write("  material DEF Default-ffRffGffB Material {\n")
            f.write("  ambientIntensity 0\n")
            f.write(f"  diffuseColor  {r} {g} {b}\n")
            f.write("  emissiveColor 0.1 0.1 0.1 } }\n")
            f.write(" geometry IndexedFaceSet {\n solid FALSE \n")
            f.write(" colorPerVertex TRUE \n ccw TRUE \n")
            f.write(" coord Coordinate {\n point [\n")
            for p in pts:
                f.write(f"{_fmt(p[0])} {_fmt(p[1])} {_fmt(p[2])}\n")
            f.write(" ] }\n")
            f.write("color Color {color [\n")
            for _ in range(len(pts)):
                f.write(f" {r} {g} {b}\n")
            f.write("\n] }\n")
            f.write("coordIndex [\n 0, 1, 2, 3, -1\n 5, 6, 4, -1\n"
                    " 6, 7, 4, -1\n 7, 8, 4, -1\n 8, 5, 4, -1\n \n] \n")
            f.write(" } }\n")
    with open(points3D_path, "w") as f:
        f.write("#VRML V2.0 utf8\n")
        f.write("Background { skyColor [1.0 1.0 1.0] } \n")
        f.write("Shape{ appearance Appearance {\n")
        f.write(" material Material {emissiveColor 1 1 1} }\n")
        f.write(" geometry PointSet {\n coord Coordinate {\n point [\n")
        for p in rec.points3D.values():
            f.write(f"{_fmt(p.xyz[0])} {_fmt(p.xyz[1])} {_fmt(p.xyz[2])}\n")
        f.write(" ] }\n color Color { color [\n")
        for p in rec.points3D.values():
            c = p.color.astype(np.float64) / 255.0
            f.write(f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
        f.write(" ] } } }\n")

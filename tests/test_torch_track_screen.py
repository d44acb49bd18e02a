"""The triangulator's screened walks against the JAX package's unscreened
ones (CPU): merge_tracks, complete_tracks and complete_image screen their
point or feature sets with one array pass before walking them, and must
leave exactly the model the plain walks leave.

Each state is built once as plain arrays (cameras, images with poses,
keypoints and point3D_ids, points with tracks, the pair matches) and loaded
into both packages' Reconstruction and CorrespondenceGraph; the walks run
in the local refinement's order (merge, complete, complete the new image),
in the global one's (complete, merge), and with the new image completed
first."""

import numpy as np
import pytest

import synthetic_torch
from colmap_pcd_tpu.models import correspondence_graph as graph_j
from colmap_pcd_tpu.models import reconstruction as rec_j
from colmap_pcd_tpu.models import triangulator as tri_j
from colmap_pcd_tpu_torch.models import correspondence_graph as graph_t
from colmap_pcd_tpu_torch.models import reconstruction as rec_t
from colmap_pcd_tpu_torch.models import triangulator as tri_t
from colmap_pcd_tpu_torch.ops import np_geom
from colmap_pcd_tpu_torch.utils.synthetic_world import make_world_with_ids

LOCAL_GATE = 2.0  # the mapper's local refinement: filter_max_reproj_error / 2
GLOBAL_GATE = 4.0  # the controller's global refinement: TriangulatorOptions' default
NEW_IMAGE = 6  # registered, never triangulated: complete_image's image
MISSING_ID = 10**6  # an id no state holds


def _world(seed):
    """A mid-mapping state: images 1-6 registered at slightly perturbed
    true poses (7 and 8 not), 1-5 triangulated, then a fifth of the
    observations dropped, so that tracks can be completed."""
    rec, graph, _, gt = synthetic_torch.make_world(
        np.random.default_rng(seed), n_images=8, n_points=400, noise_px=0.5
    )
    rng = np.random.default_rng(seed + 1)
    for iid in range(1, NEW_IMAGE + 1):
        q, t = gt[iid - 1]
        rec.images[iid].qvec = q + rng.normal(0, 2e-4, 4)
        rec.images[iid].tvec = t + rng.normal(0, 5e-3, 3)
        rec.register_image(iid)
    tri = tri_t.IncrementalTriangulator(rec, graph)
    for iid in range(1, NEW_IMAGE):
        tri.triangulate_image(tri_t.TriangulatorOptions(), iid)
    for pid in sorted(rec.points3D):
        p = rec.points3D.get(pid)
        if p is None:
            continue
        for iid, f in list(p.track):
            if rng.random() < 0.2 and pid in rec.points3D:
                rec.delete_observation(iid, f)
    return rec, graph


def _plant_duplicates(rec, rng):
    """Split the last two observations of some long tracks into a point of
    their own: near the original (the merge passes) or 0.5 m off (the
    merged point fails _tracks_reproject_ok)."""
    long_tracks = [pid for pid in sorted(rec.points3D) if len(rec.points3D[pid].track) >= 4]
    for k, pid in enumerate(long_tracks[:12]):
        p = rec.points3D[pid]
        moved = p.track[-2:]
        for iid, f in moved:
            rec.delete_observation(iid, f)
        offset = rng.normal(0, 1e-3 if k % 2 else 0.5, 3)
        rec.add_point3D(p.xyz + offset, moved)


def _free_neighbours(rec, graph, pid):
    """(image, feature) of the free correspondences, in registered images,
    of point pid's observations."""
    out = []
    for iid, f in rec.points3D[pid].track:
        for cid, cf in graph.find_correspondences(iid, f):
            cimg = rec.images.get(cid)
            if cimg.registered and cimg.point3D_ids[cf] == rec_t.INVALID_POINT3D:
                out.append((cid, cf))
    return out


def _plant_at_gate(rec, graph, image_ids, gate, delta, taken):
    """Move one free feature of `image_ids` not in `taken` to `gate + delta`
    px from the projection of a point it corresponds to; return (image,
    feature, pid)."""
    for pid in sorted(rec.points3D):
        for cid, cf in _free_neighbours(rec, graph, pid):
            if cid not in image_ids or (cid, cf) in taken:
                continue
            img = rec.images[cid]
            cam = rec.cameras[img.camera_id]
            xy, _ = np_geom.project(
                cam.model_id, cam.padded_params(), img.qvec, img.tvec, rec.points3D[pid].xyz
            )
            img.xys[cf] = xy + (gate + delta) * np.asarray([0.6, 0.8])
            taken.add((cid, cf))
            return cid, cf, pid
    raise AssertionError("no free correspondence to plant")


def _planted_world(seed):
    """_world with near-duplicate tracks and free correspondences planted
    1e-12 px inside and outside both gates, for the tracks and for the new
    image."""
    rec, graph = _world(seed)
    _plant_duplicates(rec, np.random.default_rng(seed + 2))
    tri = tri_t.IncrementalTriangulator(rec, graph)
    old, taken = set(range(1, NEW_IMAGE)), set()
    for gate in (LOCAL_GATE, GLOBAL_GATE):
        for images in (old, {NEW_IMAGE}):
            for delta in (-1e-12, 1e-12):
                cid, cf, pid = _plant_at_gate(rec, graph, images, gate, delta, taken)
                err = tri._reproj_errors([(cid, cf)], rec.points3D[pid].xyz)[0]
                assert (err < gate) == (delta < 0), (err, gate, delta)
    return rec, graph


def whole_tracks_world(seed):
    """Every image registered at its true pose and every feature in the
    track of its world point: nothing to merge and nothing to complete."""
    rec, graph, _, gt, point_ids = make_world_with_ids(
        np.random.default_rng(seed), n_images=6, n_points=300, noise_px=0.5
    )
    obs = {}
    for iid, ids in point_ids.items():
        rec.images[iid].qvec, rec.images[iid].tvec = gt[iid - 1]
        rec.register_image(iid)
        for f, w in enumerate(ids.tolist()):
            obs.setdefault(w, []).append((iid, f))
    world = np.random.default_rng(seed).normal(0, 1, (max(obs) + 1, 3))
    for w in sorted(obs):
        if len(obs[w]) >= 2:
            rec.add_point3D(world[w], obs[w])
    return rec, graph


STATES = {"mid_mapping": _world, "planted": _planted_world, "ground_truth": whole_tracks_world}


def _to_arrays(rec, graph):
    return {
        "cameras": [
            (c.camera_id, c.model_id, c.width, c.height, np.array(c.params)) for c in rec.cameras.values()
        ],
        "images": [
            (im.image_id, im.name, im.camera_id, np.array(im.qvec), np.array(im.tvec),
             im.registered, np.array(im.xys), np.array(im.point3D_ids))
            for im in rec.images.values()
        ],
        "registered_ids": list(rec.registered_ids),
        "points": [(pid, np.array(p.xyz), list(p.track)) for pid, p in rec.points3D.items()],
        "next_id": rec._next_point3D_id,
        "features": dict(graph.num_observations_per_image),
        "pairs": [(i, j, np.array(m)) for (i, j), m in graph._pair_matches.items()],
    }


def _load(arrays, rec_mod, graph_mod):
    rec = rec_mod.Reconstruction()
    for cid, model, w, h, params in arrays["cameras"]:
        rec.add_camera(rec_mod.Camera(cid, model, w, h, params.copy()))
    for iid, name, cid, q, t, reg, xys, pids in arrays["images"]:
        rec.add_image(rec_mod.Image(iid, name, cid, qvec=q.copy(), tvec=t.copy(), registered=reg,
                                    xys=xys.copy(), point3D_ids=pids.copy()))
    rec.registered_ids = list(arrays["registered_ids"])
    for pid, xyz, track in arrays["points"]:
        rec.points3D[pid] = rec_mod.Point3D(xyz=xyz.copy(), track=list(track))
    rec._next_point3D_id = arrays["next_id"]
    graph = graph_mod.CorrespondenceGraph()
    for iid, n in arrays["features"].items():
        graph.add_image(iid, n)
    for i, j, m in arrays["pairs"]:
        graph.add_matches(i, j, m.copy())
    return rec, graph


def _walk(tri_mod, rec, graph, order):
    """The walks in one refinement's order over every point (the list also
    holds a repeated id and an id no point has); returns their counts.
    "new_image" completes the new image first, before complete_tracks
    claims most of its free features."""
    tri = tri_mod.IncrementalTriangulator(rec, graph)
    ids = list(rec.points3D) + [MISSING_ID, min(rec.points3D)]
    if order != "global":
        opts = tri_mod.TriangulatorOptions(
            complete_max_reproj_error=LOCAL_GATE, merge_max_reproj_error=LOCAL_GATE
        )
        if order == "new_image":
            return tri.complete_image(opts, NEW_IMAGE), tri.merge_tracks(opts, ids)
        return (tri.merge_tracks(opts, ids), tri.complete_tracks(opts, ids),
                tri.complete_image(opts, NEW_IMAGE))
    opts = tri_mod.TriangulatorOptions(
        complete_max_reproj_error=GLOBAL_GATE, merge_max_reproj_error=GLOBAL_GATE
    )
    return tri.complete_tracks(opts, ids), tri.merge_tracks(opts, ids)


@pytest.mark.parametrize("order", ["local", "global", "new_image"])
@pytest.mark.parametrize("state", sorted(STATES))
def test_screened_walks_equal_the_jax_walks(state, order):
    arrays = _to_arrays(*STATES[state](5))
    rec_p, graph_p = _load(arrays, rec_t, graph_t)
    rec_r, graph_r = _load(arrays, rec_j, graph_j)
    counts = _walk(tri_t, rec_p, graph_p, order)
    assert counts == _walk(tri_j, rec_r, graph_r, order)
    if state == "ground_truth":
        assert counts == (0,) * len(counts)
    elif state == "planted":
        assert all(counts), counts  # every walk had work in the planted state
    assert list(rec_p.points3D) == list(rec_r.points3D)
    for pid, p in rec_p.points3D.items():
        q = rec_r.points3D[pid]
        assert p.track == q.track, pid
        assert p.xyz.tobytes() == q.xyz.tobytes(), pid
    for iid, im in rec_p.images.items():
        np.testing.assert_array_equal(im.point3D_ids, rec_r.images[iid].point3D_ids)

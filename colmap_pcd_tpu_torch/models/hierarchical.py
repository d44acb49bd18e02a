"""Hierarchical mapping: scene clustering, parallel sub-reconstructions, merge.

Parity with src/base/scene_clustering.{h,cc} + src/controllers/
hierarchical_mapper.{h,cc}: partition the image match graph into overlapping
clusters, reconstruct each independently (the natural multi-host seam —
SURVEY.md §2.10/§5.8: clusters map to hosts, each with its own map block),
then merge sub-models by similarity alignment over shared registered images.

Clustering here is a balanced recursive bisection of the match graph by
normalized cut approximation (greedy BFS growth), not Metis (graph_cut.cc) —
same interface, pure numpy.

A copy of colmap_pcd_tpu/models/hierarchical.py (host code, carried): the
merge's Umeyama runs through the port's `solvers.umeyama` on `device`, and
every leaf's mapper computes there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import device as device_mod
from ..ops import solvers
from .correspondence_graph import CorrespondenceGraph
from .incremental_mapper import MapperOptions
from .reconstruction import Reconstruction


@dataclass
class SceneClusteringOptions:
    """(scene_clustering.h Options)."""

    branching: int = 2
    image_overlap: int = 5
    leaf_max_num_images: int = 100


def cluster_images(
    graph: CorrespondenceGraph,
    image_ids: list[int],
    opts: SceneClusteringOptions = SceneClusteringOptions(),
) -> list[list[int]]:
    """Partition images into overlapping leaf clusters."""
    ids = sorted(image_ids)
    if len(ids) <= opts.leaf_max_num_images:
        return [list(ids)]
    # edge weights = match counts
    w: dict[tuple[int, int], int] = {}
    for i, j in graph.image_pairs():
        if i in image_ids and j in image_ids:
            w[(i, j)] = graph.num_matches(i, j)

    def bisect(sub: list[int]) -> tuple[list[int], list[int]]:
        # greedy BFS growth from the two endpoints of the weakest "diameter"
        subset = set(sub)
        adj: dict[int, list[tuple[int, int]]] = {i: [] for i in sub}
        for (i, j), m in w.items():
            if i in subset and j in subset:
                adj[i].append((j, m))
                adj[j].append((i, m))
        seed_a = sub[0]
        # farthest by hop count
        seen = {seed_a: 0}
        frontier = [seed_a]
        while frontier:
            nxt = []
            for u in frontier:
                for v, _ in adj[u]:
                    if v not in seen:
                        seen[v] = seen[u] + 1
                        nxt.append(v)
            frontier = nxt
        seed_b = max(seen, key=seen.get)
        part = {seed_a: 0, seed_b: 1}
        # alternate growth by strongest attachment
        changed = True
        while changed:
            changed = False
            for u in sub:
                if u in part:
                    continue
                score = [0, 0]
                for v, m in adj[u]:
                    if v in part:
                        score[part[v]] += m
                if score[0] or score[1]:
                    part[u] = int(score[1] > score[0])
                    changed = True
        for u in sub:  # disconnected leftovers round-robin
            if u not in part:
                part[u] = len(part) % 2
        a = [u for u in sub if part[u] == 0]
        b = [u for u in sub if part[u] == 1]
        if not a or not b:
            h = len(sub) // 2
            a, b = sub[:h], sub[h:]
        # overlap: strongest cross-edges duplicated into both
        cross = sorted(
            ((m, i, j) for (i, j), m in w.items()
             if (i in a) != (j in a) and (i in subset and j in subset)),
            reverse=True,
        )
        return a, b

    # pure partition during recursion; overlap added at leaf emission
    leaves = []
    stack = [ids]
    while stack:
        cur = stack.pop()
        if len(cur) <= opts.leaf_max_num_images:
            leaves.append(sorted(cur))
            continue
        a, b = bisect(cur)
        if len(a) == len(cur) or len(b) == len(cur):
            leaves.append(sorted(cur))
            continue
        stack.extend([a, b])

    # augment each leaf with its strongest outside neighbors so adjacent
    # sub-models share enough images (>= 3) for similarity alignment
    out = []
    for leaf in leaves:
        inside = set(leaf)
        cross = sorted(
            (
                (m, j if i in inside else i)
                for (i, j), m in w.items()
                if (i in inside) != (j in inside)
            ),
            reverse=True,
        )
        aug = list(leaf)
        for m, u in cross:
            if len(aug) - len(leaf) >= opts.image_overlap:
                break
            if u not in inside:
                aug.append(u)
                inside.add(u)
        out.append(sorted(aug))
    return out


def merge_reconstructions(dst: Reconstruction, src: Reconstruction, min_common: int = 3,
                          device=None) -> bool:
    """Align src onto dst by shared registered images (Umeyama over camera
    centers, on `device`: None means CUDA) and import its images/points
    (HierarchicalMapperController merge / reconstruction.cc Merge)."""
    dev = device_mod.resolve(device)
    common = [
        i
        for i in src.registered_ids
        if i in dst.images and dst.images[i].registered
    ]
    if len(common) < min_common:
        return False
    src_c = np.stack([src.images[i].projection_center() for i in common])
    dst_c = np.stack([dst.images[i].projection_center() for i in common])
    q, t, s = solvers.umeyama(
        torch.as_tensor(src_c, dtype=torch.float32, device=dev),
        torch.as_tensor(dst_c, dtype=torch.float32, device=dev), with_scale=True,
    )
    src.transform(q.cpu().numpy(), t.cpu().numpy(), float(s))

    for iid in src.registered_ids:
        if iid in dst.images and dst.images[iid].registered:
            continue
        im = src.images[iid]
        if iid not in dst.images:
            dst.add_image(im)
        else:
            dst.images[iid].qvec = im.qvec
            dst.images[iid].tvec = im.tvec
        dst.register_image(iid)
    # import points whose tracks reference now-registered images, remapping
    # feature observations; skip observations already claimed in dst
    for pid, p in src.points3D.items():
        track = []
        for iid, fidx in p.track:
            img = dst.images.get(iid)
            if img is None or not img.registered:
                continue
            if fidx < len(img.point3D_ids) and img.point3D_ids[fidx] == -1:
                track.append((iid, fidx))
        if len(track) >= 2:
            dst.add_point3D(p.xyz, track, color=p.color)
    return True


def run_hierarchical_mapper(
    rec_template,
    graph: CorrespondenceGraph,
    mapper_options: MapperOptions,
    clustering: SceneClusteringOptions = SceneClusteringOptions(),
    lidar_map=None,
    pose_priors=None,
    controller_options=None,
    device=None,
) -> Reconstruction:
    """Cluster -> reconstruct each leaf -> merge. `rec_template` provides
    cameras/images (a factory callable returning a fresh Reconstruction).
    Every leaf's mapper and the merges run on `device` (None: CUDA)."""
    import copy

    from .controllers import ControllerOptions, IncrementalMapperController

    base = rec_template() if callable(rec_template) else rec_template
    clusters = cluster_images(graph, list(base.images.keys()), clustering)
    # the cluster holding the seed (pose prior / init image) reconstructs
    # metrically with lidar; the others reconstruct classically (up to scale)
    # and are merged onto the metric anchor by similarity alignment
    seeds = set((pose_priors or {}).keys()) | {mapper_options.init_image_id1}
    clusters.sort(key=lambda c: -len(seeds & set(c)))
    subs = []
    anchored = []
    for ci, cluster in enumerate(clusters):
        sub = rec_template() if callable(rec_template) else copy.deepcopy(base)
        # restrict to cluster images
        for iid in list(sub.images.keys()):
            if iid not in cluster:
                del sub.images[iid]
        mo = copy.deepcopy(mapper_options)
        has_seed = bool(seeds & set(cluster)) and (
            mapper_options.init_image_id1 in cluster
            or bool(set((pose_priors or {}).keys()) & set(cluster))
        )
        if cluster:
            if mapper_options.init_image_id1 in cluster:
                mo.init_image_id1 = mapper_options.init_image_id1
            else:
                pri = sorted(set((pose_priors or {}).keys()) & set(cluster))
                mo.init_image_id1 = pri[0] if pri else min(cluster)
            mo.init_image_id2 = -1
        if mo.if_add_lidar_constraint and not has_seed:
            mo.if_add_lidar_constraint = False
            mo.init_min_tri_angle = min(mo.init_min_tri_angle, 4.0)
        ctl = IncrementalMapperController(
            sub, graph, mo, controller_options or ControllerOptions(verbose=False),
            lidar_map=lidar_map if mo.if_add_lidar_constraint else None,
            pose_priors=pose_priors if mo.if_add_lidar_constraint else None,
            device=device,
        )
        if ctl.reconstruct() and sub.num_reg_images >= 2:
            subs.append(sub)
            anchored.append(mo.if_add_lidar_constraint)
    if not subs:
        return base
    # anchor preference: metric (lidar) sub-model first, then by size
    order = sorted(range(len(subs)), key=lambda i: (not anchored[i], -subs[i].num_reg_images))
    subs = [subs[i] for i in order]
    main = subs[0]
    merged = True
    pending = subs[1:]
    while merged and pending:
        merged = False
        for s in list(pending):
            if merge_reconstructions(main, s, device=device):
                pending.remove(s)
                merged = True
    return main

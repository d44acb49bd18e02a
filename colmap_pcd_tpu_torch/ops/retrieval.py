"""Image retrieval: VLAD global descriptors over a k-means vocabulary.

Port of colmap_pcd_tpu/ops/retrieval.py (the reference's src/retrieval/
VisualIndex + vocab tree, as a small k-means vocabulary with Lloyd
iterations of one assignment matmul + one-hot sums, and VLAD aggregation;
a query is one [N, k*D] x [k*D] product). Used by the vocab-tree matcher and
the sequential matcher's loop detection (models/feature_pipeline.py).

Numerics follow the JAX package: the distance |x|^2 - 2 x.c + |c|^2,
`argmin` taking the first index at a tie, sums as one-hot products (no
`index_add_`: CUDA atomics would make the centroids differ from run to
run), f32 descriptors, centroids and VLADs. The distances and sums are
taken in float64 and rounded to f32: in f32, the card's and the CPU's
products sum in different orders, a descriptor near the boundary of two
cells flips, and over ten Lloyd iterations on 50 000 descriptors the
centroids drifted 1.5e-3 apart and the VLADs 0.03 (NVIDIA H100; chip_smoke
phase 11); in float64 only exact ties remain, which `argmin` breaks alike.
The VLAD sum is taken over the gathered residuals x - c[word(x)] as one
[k, N] x [N, D] product: the same terms as the JAX package's [N, k, D]
residual tensor, which at 8192 features and k = 64 would cost 268 MB per
image, without forming it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import device as device_mod

Tensor = torch.Tensor


def _sq_dists(desc: Tensor, cent: Tensor) -> Tensor:
    """[N, k] float64 squared distances |x|^2 - 2 x.c + |c|^2."""
    x, c = desc.double(), cent.double()
    return torch.sum(x**2, 1)[:, None] - 2 * (x @ c.T) + torch.sum(c**2, 1)[None, :]


def _one_hot(words: Tensor, k: int) -> Tensor:
    return torch.nn.functional.one_hot(words, k).double()


def kmeans(desc: Tensor, k: int = 64, iters: int = 10, seed: int = 0,
           init_idx: Tensor | None = None) -> Tensor:
    """Lloyd k-means on [N, D] -> centroids [k, D]. The init draws k distinct
    rows with a `torch.Generator(seed)`; `init_idx` [k] replaces the draw
    (tests pass the JAX package's `jax.random.choice` indices)."""
    N = desc.shape[0]
    if init_idx is None:
        gen = torch.Generator().manual_seed(seed)
        init_idx = torch.randperm(N, generator=gen)[:k]
    cent = desc[torch.as_tensor(init_idx, device=desc.device).long()]
    for _ in range(iters):
        onehot = _one_hot(torch.argmin(_sq_dists(desc, cent), dim=1), k)  # [N, k]
        sums = onehot.T @ desc.double()  # [k, D]
        counts = torch.sum(onehot, dim=0)[:, None]
        cent = torch.where(counts > 0, (sums / torch.clamp(counts, min=1)).to(cent.dtype), cent)
    return cent


def assign_words(desc: Tensor, centroids: Tensor) -> Tensor:
    """Nearest-centroid assignment [N] int32: the VLAD codebook cell doubles
    as the visual word for vote-and-verify spatial re-ranking."""
    return torch.argmin(_sq_dists(desc, centroids), dim=1).to(torch.int32)


def vlad(desc: Tensor, valid: Tensor, centroids: Tensor) -> Tensor:
    """VLAD aggregation: [N, D] + [k, D] -> [k*D], power + L2 normalized."""
    assign = torch.argmin(_sq_dists(desc, centroids), dim=1)
    onehot = _one_hot(assign, centroids.shape[0]) * valid[:, None]  # [N, k]
    v = (onehot.T @ (desc.double() - centroids[assign].double())).reshape(-1)
    v = torch.sign(v) * torch.sqrt(torch.abs(v))
    return (v / torch.clamp(torch.linalg.norm(v), min=1e-12)).to(desc.dtype)


@dataclass
class RetrievalIndex:
    """The index on one device: VLADs [n_images, k*D] and centroids [k, D];
    for vote-and-verify re-ranking also geoms [n_images, cap, 4] (x, y,
    scale, orientation), words [n_images, cap] and valids [n_images, cap]."""

    ids: list
    vlads: Tensor
    centroids: Tensor
    geoms: Tensor | None = None
    words: Tensor | None = None
    valids: Tensor | None = None


def _unit_rows(d: np.ndarray) -> np.ndarray:
    d = d.astype(np.float32)
    return d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-8)


def build_index(
    descs_by_image: dict[int, np.ndarray],
    k: int = 64,
    max_train: int = 50000,
    seed: int = 0,
    geoms_by_image: dict[int, np.ndarray] | None = None,
    device=None,
) -> RetrievalIndex:
    """VLAD index on `device` (None: CUDA; the CPU only by name). Pass
    geoms_by_image (keypoints [N, >=4] (x, y, scale, ori) per image) to
    enable vote-and-verify re-ranking at query time (the VisualIndex::Query
    + VoteAndVerify path, retrieval/visual_index.h). An image without
    descriptors gets a zero VLAD."""
    dev = device_mod.resolve(device)
    ids = sorted(descs_by_image.keys())
    all_desc = [d for i in ids for d in [descs_by_image[i]] if d.size]
    if not all_desc:
        return RetrievalIndex(ids, torch.zeros((len(ids), k * 128), device=dev),
                              torch.zeros((k, 128), device=dev))
    train = _unit_rows(np.concatenate(all_desc)[:max_train])
    kk = min(k, train.shape[0])
    cent = kmeans(torch.as_tensor(train, device=dev), k=kk, seed=seed)
    D = train.shape[1]
    vlads = torch.zeros((len(ids), kk * D), device=dev)
    cap = 1 << int(np.ceil(np.log2(max(max(d.shape[0] for d in all_desc), 1))))
    want_geom = geoms_by_image is not None
    geoms = np.zeros((len(ids), cap, 4), np.float32) if want_geom else None
    words = torch.zeros((len(ids), cap), dtype=torch.int32, device=dev) if want_geom else None
    valids = np.zeros((len(ids), cap), np.float32) if want_geom else None
    for n, i in enumerate(ids):
        d = descs_by_image[i]
        if d.size == 0:
            continue
        d = _unit_rows(d)
        dp = np.zeros((cap, D), np.float32)
        dp[: d.shape[0]] = d
        v = np.zeros(cap, np.float32)
        v[: d.shape[0]] = 1.0
        dj = torch.as_tensor(dp, device=dev)
        vlads[n] = vlad(dj, torch.as_tensor(v, device=dev), cent)
        if want_geom:
            g = np.asarray(geoms_by_image.get(i, np.zeros((0, 4))), np.float32)
            m = min(g.shape[0], cap, d.shape[0])
            if g.shape[1] < 4:  # pad missing scale/orientation columns
                g = np.concatenate([g, np.ones((g.shape[0], 4 - g.shape[1]), np.float32)], axis=1)
            geoms[n, :m] = g[:m, :4]
            words[n] = assign_words(dj, cent)
            valids[n, :m] = 1.0
    if want_geom:
        geoms, valids = torch.as_tensor(geoms, device=dev), torch.as_tensor(valids, device=dev)
    return RetrievalIndex(ids, vlads, cent, geoms, words, valids)


def similarities(index: RetrievalIndex, qi: int) -> np.ndarray:
    """VLAD similarity of every indexed image to row qi, on the host."""
    return (index.vlads @ index.vlads[qi]).cpu().numpy()


def query(
    index: RetrievalIndex,
    image_id,
    num: int,
    rerank: bool = False,
    num_verify: int = 20,
    vv_opts=None,
) -> list:
    """Ranked most-similar image ids (excluding the query itself).

    With rerank=True (and an index built with geometries) the top num_verify
    VLAD candidates are re-scored by vote_and_verify effective inlier count
    and reordered (score desc, VLAD sim as tie-break) before the tail: the
    reference's spatial-verification retrieval mode (retrieval/visual_index.h
    Query + vote_and_verify.cc). The similarity row is ordered on the host by
    the JAX package's `np.argsort(-sims)`, so equal similarities order the
    same way."""
    try:
        qi = index.ids.index(image_id)
    except ValueError:
        return []
    sims = similarities(index, qi)
    order = [int(o) for o in np.argsort(-sims) if index.ids[int(o)] != image_id]
    if rerank and index.geoms is not None and order:
        from . import vote_verify as vv

        short = order[:num_verify]
        rows = torch.as_tensor(short, device=index.vlads.device)
        scores = vv.vote_and_verify_batch(
            index.geoms[qi], index.words[qi], index.valids[qi],
            index.geoms[rows], index.words[rows], index.valids[rows],
            vv_opts or vv.VoteVerifyOptions(),
        ).cpu().numpy()
        # stable: effective inliers desc, VLAD similarity breaks ties
        short = [short[r] for r in np.argsort(-scores, kind="stable")]
        order = short + order[num_verify:]
    return [index.ids[o] for o in order[:num]]

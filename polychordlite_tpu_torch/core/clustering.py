"""Mutual k-nearest-neighbour clustering.

Re-expression of the reference KNN clustering
(``src/polychord/clustering.f90``): points belong to the same cluster when
either is in the other's k-nearest-neighbour set, with transitive closure;
k sweeps 2..K with K doubling (from 10) until the partition stabilises, then
the algorithm recurses into each found sub-cluster (:15-97).

The O(nlive^2) similarity matrix is one Gram matmul; neighbour-set membership
is dense boolean matrix work; transitive closure is a union-find — all
vectorised numpy on the host (clustering runs once per compression e-fold,
off the hot path)."""

from __future__ import annotations

import numpy as np

from ..ops.linalg import similarity_matrix_np
from ..utils import native
from .rti import RunTimeInfo, add_cluster


def _knn_indices(sim: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k nearest neighbours of each point (self included,
    as in compute_knn, clustering.f90:134-174). Returns (n, k)."""
    knn = native.compute_knn(sim, k)
    if knn is not None:
        return knn
    order = np.argsort(sim, axis=1, kind="stable")
    return order[:, :k]


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, a: int) -> int:
        root = a
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[a] != root:
            self.parent[a], a = root, self.parent[a]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # union by min label reproduces do_clustering_k's relabelling
            # (clustering.f90:100-130)
            lo, hi = min(ra, rb), max(ra, rb)
            self.parent[hi] = lo


def _cluster_with_k(knn: np.ndarray) -> np.ndarray:
    """Single-k mutual-neighbour clustering (do_clustering_k + neighbours,
    clustering.f90:100-130,178-188): i~j iff j's nearest (knn[j,0]=j... the
    first entry is the point itself) — the reference's `neighbours` test is
    `any(knn1==knn2(1)) .or. any(knn2==knn1(1))`, i.e. i in knn_j or j in
    knn_i (the first neighbour of a point is itself)."""
    labels = native.mutual_knn_cluster(knn)
    if labels is not None:
        return labels
    n, k = knn.shape
    # membership[i, j] = True iff j is among i's k nearest neighbours
    member = np.zeros((n, n), dtype=bool)
    rows = np.repeat(np.arange(n), k)
    member[rows, knn.ravel()] = True
    linked = member | member.T
    uf = _UnionFind(n)
    ii, jj = np.nonzero(np.triu(linked, 1))
    for a, b in zip(ii, jj):
        uf.union(int(a), int(b))
    labels = np.array([uf.find(i) for i in range(n)])
    return _relabel(labels)


def _relabel(labels: np.ndarray) -> np.ndarray:
    """Canonical relabelling to 0,1,2,... in order of first appearance
    (utils.F90:713-752)."""
    _, inv = np.unique(labels, return_inverse=True)
    order = {}
    out = np.empty_like(labels)
    nxt = 0
    for i, lab in enumerate(labels):
        if lab not in order:
            order[lab] = nxt
            nxt += 1
        out[i] = order[lab]
    return out


def nn_clustering(sim: np.ndarray) -> np.ndarray:
    """Full recursive mutual-KNN clustering of a similarity matrix
    (NN_clustering, clustering.f90:15-97). Returns 0-based labels.

    The sweep runs k = 2..min(n, 10) EXACTLY like the reference: its
    ``do n=2,k`` loop fixes the trip count at entry (F90 semantics), so
    the in-loop k-doubling never extends the sweep (see
    tests/clustering_oracle.py).  An earlier round implemented the
    doubling as (apparently) intended — on thin-shell geometries deep in
    compression the partition never stabilises and that variant ground an
    O(n) sweep of union-find passes per call on the shells benchmark;
    the reference-exact cap is also what the
    partition-identity tests certify."""
    n = sim.shape[0]
    if n <= 2:
        return np.zeros(n, dtype=int)

    k = min(n, 10)
    knn = _knn_indices(sim, k)
    labels_old = np.arange(n)
    labels = np.zeros(n, dtype=int)

    for kk in range(2, k + 1):
        labels = _cluster_with_k(knn[:, :kk])
        num = labels.max() + 1
        if num == 1:
            return labels
        if np.array_equal(labels, labels_old):
            break
        labels_old = labels

    # recurse into each found sub-cluster (:80-95)
    num = labels.max() + 1
    if num > 1:
        out = labels.copy()
        offset = 0
        for c in range(num):
            pts = np.flatnonzero(labels == c)
            sub = nn_clustering(sim[np.ix_(pts, pts)])
            out[pts] = offset + sub
            offset += sub.max() + 1
        return _relabel(out)
    return labels


def do_clustering(rti: RunTimeInfo, sub_dimensions=None) -> bool:
    """Cluster every active cluster's live points; split any that separate
    (cluster_module.do_clustering, clustering.f90:253-324).  Returns True
    iff any cluster was split."""
    s = rti.settings
    found = False
    i_cluster = 0
    num_old = rti.ncluster  # fixed at entry, as in the reference loop
    while i_cluster < num_old:
        live = rti.live[i_cluster]
        n = live.shape[0]
        if n > 2:
            if sub_dimensions is not None:
                data = live[:, np.asarray(sub_dimensions, dtype=int)]
            else:
                data = live[:, s.h]
            sim = similarity_matrix_np(data)
            labels = nn_clustering(sim)
            num = labels.max() + 1
            if num > 1:
                found = True
                add_cluster(rti, i_cluster, labels, int(num))
                # split cluster removed, survivors shift down: revisit the
                # same index without advancing (reference loop :288-322)
                continue
        i_cluster += 1
    return found

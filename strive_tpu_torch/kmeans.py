"""k-means in torch, for ``scripts/cluster_scenarios.py``.

The JAX package's clustering is sklearn's ``KMeans(n_clusters=k,
random_state=0, n_init=10)`` (``scripts/cluster_scenarios.py:140``). This
is the same algorithm on a torch device, in float64 (a clustering holds
tens of points):

- the data centered on its mean first, as sklearn centers dense data;
- greedy k-means++ seeding with ``2 + int(log k)`` local trials a center,
  its draws from a CPU ``torch.Generator`` seeded ``seed``, so the card
  and the CPU seed alike (sklearn draws from numpy, so its seeds differ);
- ``n_init`` seedings, each refined by Lloyd iterations to sklearn's
  stopping rule: labels unchanged, or a total squared center shift
  ``<= TOL x`` the mean feature variance, at most ``MAX_ITER``
  iterations, then one more assignment if the labels had not settled;
  an empty cluster takes the point farthest from its center;
- the run of lowest inertia kept (a later run only if its partition
  differs).

The result, :class:`KMeansResult`, is a plain picklable class with
sklearn's attribute names and ``predict`` (nearest center, ties to the
first), so a ``cluster.pkl`` of it is read without sklearn.
"""

from __future__ import annotations

import math

import numpy as np
import torch


MAX_ITER = 300  # sklearn's KMeans defaults
TOL = 1e-4       # of the mean feature variance


class KMeansResult:
    """A fitted clustering: ``n_clusters``, ``cluster_centers_`` (k, D),
    ``labels_`` (N,), ``inertia_`` (numpy / Python numbers)."""

    def __init__(self, cluster_centers, labels, inertia):
        self.cluster_centers_ = np.asarray(cluster_centers, np.float64)
        self.n_clusters = int(self.cluster_centers_.shape[0])
        self.labels_ = np.asarray(labels, np.int32)
        self.inertia_ = float(inertia)

    def predict(self, X):
        return predict(self.cluster_centers_, X)


def predict(centers, X):
    """Index of the nearest center of each row of ``X``, ties to the first
    (sklearn's ``KMeans.predict``); works for any object with
    ``cluster_centers_`` through ``predict(obj.cluster_centers_, X)``."""
    C = torch.as_tensor(np.asarray(centers, np.float64))
    X = torch.as_tensor(np.asarray(X, np.float64))
    return _sq_dist(X, C).argmin(dim=1).numpy().astype(np.int32)


def _sq_dist(X, C):
    """(N, k) squared distances."""
    return ((X[:, None, :] - C[None, :, :]) ** 2).sum(-1)


def kmeans_plusplus(X, k, generator):
    """Greedy k-means++ seeding (sklearn ``_kmeans_plusplus``).

    :param X: (N, D) float64 tensor
    :param generator: CPU ``torch.Generator``; every draw comes from it
    :return: (k, D) initial centers
    """
    N = X.shape[0]
    n_trials = 2 + int(math.log(k))
    centers = X.new_empty((k, X.shape[1]))
    first = int(torch.randint(N, (1,), generator=generator))
    centers[0] = X[first]
    closest = _sq_dist(X, centers[0:1])[:, 0]
    pot = closest.sum()
    for c in range(1, k):
        draws = torch.rand(n_trials, generator=generator,
                           dtype=torch.float64).to(X.device) * pot
        ids = torch.searchsorted(torch.cumsum(closest, 0), draws)
        ids = ids.clamp(max=N - 1)
        cand = torch.minimum(closest[None, :], _sq_dist(X[ids], X))
        cand_pot = cand.sum(dim=1)
        best = int(cand_pot.argmin())
        pot, closest = cand_pot[best], cand[best]
        centers[c] = X[ids[best]]
    return centers


def _update_centers(X, labels, centers, k):
    """Mean of each cluster's points; an empty cluster takes the point
    farthest from its center (sklearn ``_relocate_empty_clusters_dense``)."""
    sums = X.new_zeros((k, X.shape[1])).index_add_(0, labels, X)
    counts = X.new_zeros(k).index_add_(0, labels, torch.ones_like(X[:, 0]))
    empty = torch.nonzero(counts == 0)[:, 0]
    if empty.numel():
        far = ((X - centers[labels]) ** 2).sum(1).argsort(descending=True,
                                                          stable=True)
        for new_id, idx in zip(empty.tolist(), far[:empty.numel()].tolist()):
            old_id = int(labels[idx])
            sums[old_id] -= X[idx]
            counts[old_id] -= 1
            sums[new_id] = X[idx]
            counts[new_id] = 1
    return sums / counts[:, None]


def lloyd(X, centers, tol):
    """Lloyd iterations from ``centers`` (sklearn ``_kmeans_single_lloyd``).

    :param tol: absolute bound on the total squared center shift
    :return: (labels, centers, inertia)
    """
    k = centers.shape[0]
    labels_old = None
    settled = False
    for _ in range(MAX_ITER):
        labels = _sq_dist(X, centers).argmin(dim=1)
        new = _update_centers(X, labels, centers, k)
        shift = float(((new - centers) ** 2).sum())
        centers = new
        if labels_old is not None and torch.equal(labels, labels_old):
            settled = True
            break
        if shift <= tol:
            break
        labels_old = labels
    if not settled:
        labels = _sq_dist(X, centers).argmin(dim=1)
    inertia = float(((X - centers[labels]) ** 2).sum())
    return labels, centers, inertia


def _same_partition(a, b, k):
    """True if labelings ``a`` and ``b`` differ only by a relabelling."""
    mapping = {}
    for x, y in zip(a.tolist(), b.tolist()):
        if mapping.setdefault(x, y) != y:
            return False
    return len(set(mapping.values())) == len(mapping) <= k


def fit(X, k, n_init=10, seed=0, device="cpu", init=None):
    """Cluster the rows of ``X`` into ``k`` groups.

    :param X: (N, D) array-like
    :param init: optional (k, D) initial centers: one Lloyd run from them
        (sklearn ``KMeans(init=centers, n_init=1)``)
    :return: :class:`KMeansResult`
    """
    X = torch.as_tensor(np.asarray(X, np.float64), device=device)
    mean = X.mean(dim=0)
    Xc = X - mean
    abs_tol = float(Xc.var(dim=0, unbiased=False).mean()) * TOL
    if init is not None:
        starts = [torch.as_tensor(np.asarray(init, np.float64),
                                  device=device) - mean]
    else:
        gen = torch.Generator().manual_seed(seed)
        starts = (kmeans_plusplus(Xc, k, gen) for _ in range(n_init))
    best = None
    for start in starts:
        labels, centers, inertia = lloyd(Xc, start, abs_tol)
        if best is None or (inertia < best[2] and not _same_partition(
                labels, best[0], k)):
            best = (labels, centers, inertia)
    labels, centers, inertia = best
    return KMeansResult((centers + mean).cpu().numpy(), labels.cpu().numpy(),
                        inertia)

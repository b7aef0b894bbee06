"""k-means in numpy for ``--cluster loss``.

The JAX package groups the per-item losses with scikit-learn's
``KMeans(n_clusters=7, random_state=0, n_init=10)``; the card's machine has
no scikit-learn.  :func:`kmeans` follows that estimator step by step on
dense data with unit weights: the data centred on its mean, greedy
k-means++ seeding (``2 + int(log k)`` trials a centre) from one
``RandomState(seed)`` shared by the ``n_init`` runs, Lloyd iterations
until the labels repeat or the centres move less than ``tol`` times the
data's mean variance (empty clusters take the points farthest from their
centres), a last assignment, and the run of least inertia whose partition
differs from the best so far.  Distances take scikit-learn's form
(``|c|^2 - 2 x.c``, plus ``|x|^2`` in the seeding), so the seeding draws
the same candidates.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _sq_dist(centers: np.ndarray, x: np.ndarray, x_sq: np.ndarray) -> np.ndarray:
    """[c, n] squared distances as scikit-learn's ``_euclidean_distances``
    (``-2 c.x + |c|^2 + |x|^2``, clipped at 0)."""
    d = -2 * (centers @ x.T)
    d += np.einsum("ij,ij->i", centers, centers)[:, None]
    d += x_sq[None, :]
    return np.maximum(d, 0, out=d)


def _plusplus(x: np.ndarray, k: int, x_sq: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    n = x.shape[0]
    weight = np.ones(n, dtype=x.dtype)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]), dtype=x.dtype)
    centers[0] = x[rng.choice(n, p=weight / weight.sum())]
    closest = _sq_dist(centers[0, None], x, x_sq)
    pot = closest @ weight
    for c in range(1, k):
        rand = rng.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(weight * closest), rand)
        np.clip(cand, None, closest.size - 1, out=cand)
        dist = _sq_dist(x[cand], x, x_sq)
        np.minimum(closest, dist, out=dist)
        cand_pot = dist @ weight.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot, closest = cand_pot[best], dist[best]
        centers[c] = x[cand[best]]
    return centers


def _assign(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    d = np.einsum("ij,ij->i", centers, centers)[None, :] - 2 * (x @ centers.T)
    return np.argmin(d, axis=1).astype(np.int32)


def _lloyd(x: np.ndarray, centers: np.ndarray, tol: float, max_iter: int):
    k = centers.shape[0]
    labels_old = np.full(x.shape[0], -1, dtype=np.int32)
    strict = False
    for _ in range(max_iter):
        labels = _assign(x, centers)
        counts = np.bincount(labels, minlength=k).astype(x.dtype)
        sums = np.zeros_like(centers)
        np.add.at(sums, labels, x)
        empty = np.flatnonzero(counts == 0)
        if empty.size:
            far = np.argsort(-((x - centers[labels]) ** 2).sum(axis=1), kind="stable")[:empty.size]
            for new, idx in zip(empty, far):
                old = labels[idx]
                sums[old] -= x[idx]
                counts[old] -= 1
                sums[new], counts[new] = x[idx], 1
        new_centers = np.where(counts[:, None] > 0, sums / np.maximum(counts, 1)[:, None], centers)
        shift = ((new_centers - centers) ** 2).sum()
        centers = new_centers
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if shift <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(x, centers)
    inertia = float(((x - centers[labels]) ** 2).sum())
    return labels, inertia, centers


def _same_partition(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    """True when ``a`` and ``b`` differ only by a renaming of the labels."""
    mapping = np.full(k, -1, dtype=np.int64)
    for la, lb in zip(a, b):
        if mapping[la] == -1:
            mapping[la] = lb
        elif mapping[la] != lb:
            return False
    return True


def kmeans(values, n_clusters: int = 7, seed: int = 0, n_init: int = 10, max_iter: int = 300,
           tol: float = 1e-4) -> Tuple[np.ndarray, float, np.ndarray]:
    """``(labels, inertia, centers)`` of ``values`` (``[n]`` or ``[n, d]``)."""
    x = np.array(values, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    if x.shape[0] < n_clusters:
        raise ValueError(f"n_samples={x.shape[0]} should be >= n_clusters={n_clusters}")
    mean = x.mean(axis=0)
    x -= mean
    x_sq = np.einsum("ij,ij->i", x, x)
    rng = np.random.RandomState(seed)
    tol_abs = float(np.mean(np.var(x, axis=0)) * tol)
    best = None
    for _ in range(n_init):
        labels, inertia, centers = _lloyd(x, _plusplus(x, n_clusters, x_sq, rng), tol_abs, max_iter)
        if best is None or (inertia < best[1] and not _same_partition(labels, best[0], n_clusters)):
            best = (labels, inertia, centers)
    labels, inertia, centers = best
    return labels, inertia, centers + mean

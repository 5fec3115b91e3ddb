"""Synthetic datasets + federated partitioners (own copy).

Counterpart of `repro.data.synthetic` (numpy only, no torch). The port
keeps its own copy instead of importing the JAX package; the functions
are bitwise identical to the reference (tests/test_torch_modules.py pins
it).

The reference assumes no network access, so CIFAR-10 is replaced by a deterministic
10-class synthetic image generator (DESIGN.md deviation #1): each class is
a distinct procedural texture (oriented gratings, blobs, checkers) with
per-sample random phase/position/color — linearly separable enough for a
kNN probe to measure representation quality, hard enough that training
matters.

Partitioners reproduce the paper's Sec. 5.1 splits: IID uniform and
Dirichlet(alpha) Non-IID with a >= `min_per_client` floor (paper: 520
images per vehicle, 95 vehicles).
"""
from __future__ import annotations

import numpy as np

N_CLASSES = 10
IMG = 32


def make_dataset(n_per_class: int = 5000, seed: int = 0, img: int = IMG):
    """Returns (images (N,img,img,3) float32 in [0,1], labels (N,) int32)."""
    rng = np.random.RandomState(seed)
    xs, ys = [], []
    yy, xx = np.meshgrid(np.arange(img), np.arange(img), indexing="ij")
    for c in range(N_CLASSES):
        n = n_per_class
        phase = rng.uniform(0, 2 * np.pi, (n, 1, 1))
        freq = 0.2 + 0.08 * c
        angle = np.pi * c / N_CLASSES
        gx = np.cos(angle) * xx + np.sin(angle) * yy
        base = 0.5 + 0.5 * np.sin(freq * gx[None] + phase)           # (n,img,img)
        # class-specific blob
        cx = rng.uniform(6, img - 6, (n, 1, 1))
        cy = rng.uniform(6, img - 6, (n, 1, 1))
        r2 = (xx[None] - cx) ** 2 + (yy[None] - cy) ** 2
        blob = np.exp(-r2 / (2 * (2.0 + 0.6 * c) ** 2))
        lum = 0.6 * base + 0.4 * blob
        # class-tinted color with per-sample jitter
        hue = np.array([np.cos(2 * np.pi * c / N_CLASSES),
                        np.cos(2 * np.pi * c / N_CLASSES + 2.1),
                        np.cos(2 * np.pi * c / N_CLASSES + 4.2)]) * 0.25 + 0.75
        tint = hue[None, None, None, :] * (1 + rng.uniform(-0.1, 0.1, (n, 1, 1, 3)))
        im = lum[..., None] * tint + rng.normal(0, 0.05, (n, img, img, 3))
        xs.append(np.clip(im, 0, 1).astype(np.float32))
        ys.append(np.full((n,), c, np.int32))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    perm = rng.permutation(len(x))
    return x[perm], y[perm]


def partition_iid(labels, n_clients: int, seed: int = 0):
    """Uniform IID split; returns list of index arrays."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(labels))
    return np.array_split(idx, n_clients)


def partition_dirichlet(labels, n_clients: int, alpha: float,
                        min_per_client: int = 0, seed: int = 0):
    """Dirichlet(alpha) Non-IID split (paper Fig. 3; alpha=0.1 in Sec. 5.1).

    Re-draws until every client holds >= min_per_client samples, matching
    the paper's "at least 520 images per vehicle" constraint.
    """
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    for _attempt in range(100):
        client_idx = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet([alpha] * n_clients)
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for ci, part in enumerate(np.split(idx_c, cuts)):
                client_idx[ci].extend(part.tolist())
        sizes = np.array([len(ix) for ix in client_idx])
        if min_per_client == 0 or sizes.min() >= min_per_client:
            return [np.array(sorted(ix)) for ix in client_idx]
        # top-up small clients from the largest ones (paper guarantees >=520)
        order = np.argsort(sizes)
        donors = list(order[::-1])
        for ci in order:
            while len(client_idx[ci]) < min_per_client:
                d = donors[0]
                if len(client_idx[d]) <= min_per_client:
                    donors.pop(0)
                    continue
                client_idx[ci].append(client_idx[d].pop())
        return [np.array(sorted(ix)) for ix in client_idx]
    raise RuntimeError("dirichlet partition failed")


def category_histogram(labels, parts, n_classes: int = N_CLASSES):
    """Per-client class histogram (the paper's Fig. 3 data)."""
    return np.stack([np.bincount(labels[p], minlength=n_classes)
                     for p in parts])


def token_batch(rng: np.random.RandomState, batch: int, seq: int,
                vocab: int):
    """Synthetic Zipf-like token stream (batch, seq) int32 in [1,
    vocab - 2], for the LM training paths."""
    z = rng.zipf(1.3, size=(batch, seq))
    return (z % (vocab - 2) + 1).astype(np.int32)

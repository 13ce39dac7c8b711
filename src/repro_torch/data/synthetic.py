"""Synthetic data pipeline.

Fashion-MNIST is not downloadable in this offline container, so
``make_fmnist_like`` builds a 10-class 28x28 grayscale dataset from smoothed
class prototypes + structured noise.  Classes are genuinely separable but not
trivially so (prototype mixtures + per-sample deformation), which preserves
the *relative* comparisons the paper makes (method A vs B on identical data).

Partitioners reproduce the paper's device splits:
  - ``partition_iid``: uniform random split across N devices.
  - ``partition_noniid_classes``: each device samples from a random subset of
    ``classes_per_device`` classes (paper: 2 of 10).
  - ``partition_dirichlet``: Dir(alpha) label skew (extra, for ablations).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _smooth(img: np.ndarray, iters: int = 2) -> np.ndarray:
    for _ in range(iters):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    return img


def make_fmnist_like(n_train: int = 60000, n_test: int = 10000,
                     n_classes: int = 10, seed: int = 0,
                     noise: float = 0.5) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    # weak class signal on a shared background: per-pixel SNR << 1 so the
    # CNN needs many SGD steps (like real FMNIST), instead of one round
    shared = _smooth(rng.randn(28, 28), 3)
    protos = []
    for c in range(n_classes):
        base = shared + 0.45 * _smooth(rng.randn(28, 28), 3)
        mode2 = base + 0.3 * _smooth(rng.randn(28, 28), 2)
        protos.append((base, mode2))

    def gen(n, rs):
        labels = rs.randint(0, n_classes, size=n).astype(np.int32)
        imgs = np.empty((n, 28, 28, 1), np.float32)
        modes = rs.randint(0, 2, size=n)
        shifts = rs.randint(-3, 4, size=(n, 2))
        eps = rs.randn(n, 28, 28).astype(np.float32) * noise
        for i in range(n):
            p = protos[labels[i]][modes[i]]
            p = np.roll(p, shifts[i, 0], 0)
            p = np.roll(p, shifts[i, 1], 1)
            imgs[i, :, :, 0] = p + eps[i]
        return imgs, labels

    xtr, ytr = gen(n_train, rng)
    xte, yte = gen(n_test, np.random.RandomState(seed + 1))
    return {"x_train": xtr, "y_train": ytr, "x_test": xte, "y_test": yte}


# -- device partitioners -------------------------------------------------
def partition_iid(n_samples: int, n_devices: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n_samples)
    return [np.sort(s) for s in np.array_split(idx, n_devices)]


def partition_noniid_classes(labels: np.ndarray, n_devices: int,
                             classes_per_device: int = 2,
                             seed: int = 0) -> List[np.ndarray]:
    """Paper's non-IID split: each device draws from a random subset of
    ``classes_per_device`` classes."""
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    per_dev = len(labels) // n_devices
    out = []
    for _ in range(n_devices):
        cls = rng.choice(n_classes, classes_per_device, replace=False)
        pool = np.concatenate([by_class[c] for c in cls])
        out.append(np.sort(rng.choice(pool, per_dev, replace=False)))
    return out


def partition_dirichlet(labels: np.ndarray, n_devices: int, alpha: float = 0.5,
                        seed: int = 0) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    out: List[List[int]] = [[] for _ in range(n_devices)]
    for c in range(n_classes):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_devices)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for d, part in enumerate(np.split(idx, cuts)):
            out[d].extend(part.tolist())
    return [np.sort(np.array(d, np.int64)) for d in out]


# -- LM token stream (for transformer examples / smoke) -------------------
def make_token_batch(rng: np.random.RandomState, batch: int, seq: int,
                     vocab: int) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic token stream (so loss can actually decrease)."""
    base = rng.randint(0, vocab, size=(batch, seq), dtype=np.int64)
    # inject copy structure: second half repeats first half shifted
    half = seq // 2
    base[:, half:half * 2] = (base[:, :half] + 1) % vocab
    return {"tokens": base.astype(np.int32)}

"""Synthetic UCR-like time-series classification data (numpy only).

The port keeps its own copy of ``repro.data.synthetic.make_dataset`` and
``random_pairs`` so that it never imports the JAX package; the same seed
gives the same arrays in both.  Datasets have the statistical character
the UCR archive stresses: per-class smooth prototypes,
instances that are *time-warped* copies (random monotone warp maps) with
additive noise and amplitude jitter, z-normalised (UCR convention).  Warping
is what makes DTW the right distance, and window size the knob — matching
the paper's experimental regime.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Dataset:
    x_train: np.ndarray  # (N, L) float32, z-normalised
    y_train: np.ndarray  # (N,) int32
    x_test: np.ndarray   # (T, L)
    y_test: np.ndarray   # (T,)

    @property
    def length(self) -> int:
        return self.x_train.shape[1]

    @property
    def n_classes(self) -> int:
        return int(self.y_train.max()) + 1


def _smooth(x: np.ndarray, k: int) -> np.ndarray:
    ker = np.ones(k) / k
    return np.convolve(x, ker, mode="same")


def _znorm(x: np.ndarray) -> np.ndarray:
    return (x - x.mean(-1, keepdims=True)) / (x.std(-1, keepdims=True) + 1e-8)


def _prototype(rng: np.random.Generator, L: int) -> np.ndarray:
    walk = np.cumsum(rng.normal(size=L + 16))
    return _znorm(_smooth(walk, 9)[8 : 8 + L])


def _warp(rng: np.random.Generator, proto: np.ndarray, strength: float) -> np.ndarray:
    """Random monotone time warp: resample through a jittered knot map."""
    L = len(proto)
    n_knots = 6
    knots_x = np.linspace(0, 1, n_knots)
    knots_y = knots_x + rng.normal(scale=strength / n_knots, size=n_knots)
    knots_y[0], knots_y[-1] = 0.0, 1.0
    knots_y = np.maximum.accumulate(knots_y)
    knots_y /= max(knots_y[-1], 1e-9)
    t = np.interp(np.linspace(0, 1, L), knots_x, knots_y)
    return np.interp(t * (L - 1), np.arange(L), proto)


def make_dataset(
    n_classes: int = 4,
    n_train_per_class: int = 25,
    n_test_per_class: int = 10,
    length: int = 128,
    *,
    warp: float = 0.5,
    noise: float = 0.15,
    seed: int = 0,
) -> Dataset:
    """Generate a UCR-like dataset (z-normalised, stratified splits)."""
    rng = np.random.default_rng(seed)
    protos = [_prototype(rng, length) for _ in range(n_classes)]

    def sample(cls: int) -> np.ndarray:
        x = _warp(rng, protos[cls], warp)
        x = x * (1.0 + rng.normal(scale=0.1))
        x = x + rng.normal(scale=noise, size=length)
        return _znorm(x)

    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    for c in range(n_classes):
        for _ in range(n_train_per_class):
            xs_tr.append(sample(c))
            ys_tr.append(c)
        for _ in range(n_test_per_class):
            xs_te.append(sample(c))
            ys_te.append(c)
    perm = rng.permutation(len(xs_tr))
    x_train = np.asarray(xs_tr, np.float32)[perm]
    y_train = np.asarray(ys_tr, np.int32)[perm]
    return Dataset(
        x_train=x_train,
        y_train=y_train,
        x_test=np.asarray(xs_te, np.float32),
        y_test=np.asarray(ys_te, np.int32),
    )


def random_pairs(n_pairs: int, length: int, *,
                 seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Random z-normalised random-walk pairs ``(n_pairs, length)`` x 2,
    float32 (the paper's Fig. 1 protocol); the same seed gives the same
    arrays as ``repro.data.synthetic.random_pairs``."""
    rng = np.random.default_rng(seed)
    a = np.cumsum(rng.normal(size=(n_pairs, length)), axis=1)
    b = np.cumsum(rng.normal(size=(n_pairs, length)), axis=1)
    return _znorm(a).astype(np.float32), _znorm(b).astype(np.float32)

"""Binary patch descriptors + hamming matching for wide-baseline pipelines.

Capability match for the reference prototype's descriptor-based matching
(ORB/SIFT pipelines, py_proto/suriko/mvg.py:1922-2395 — there OpenCV does the
work). Equivalent here: BRIEF-style 256-bit binary descriptors (fixed
Gaussian sampling pattern over a smoothed patch) computed for all keypoints
in one vmap, and an all-pairs hamming matcher (XOR + popcount on packed
uint32 lanes) with mutual-nearest + ratio tests.

Two variants:
- :func:`compute_brief` — upright BRIEF (video / small-roll baselines).
- :func:`compute_oriented_brief` — ORB-style steered BRIEF: per-keypoint
  orientation from the intensity centroid (Rosin moments, as in ORB), the
  sampling pattern rotated by that angle before the comparisons. All
  keypoints steered in one batched gather — no per-keypoint loop.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

N_BITS = 256
N_WORDS = N_BITS // 32
_PATCH = 24  # half-size of the descriptor support


def _sampling_pattern(seed: int = 7) -> np.ndarray:
    """[N_BITS, 4] integer offsets (x1, y1, x2, y2), Gaussian, clipped."""
    rng = np.random.default_rng(seed)
    pts = np.clip(np.round(rng.normal(scale=_PATCH / 4.5, size=(N_BITS, 4))),
                  -(_PATCH - 1), _PATCH - 1).astype(np.int32)
    return pts

_PATTERN = _sampling_pattern()


def _box_blur(img: jnp.ndarray, k: int = 5) -> jnp.ndarray:
    ker = jnp.ones((k, k), img.dtype) / (k * k)
    return jax.lax.conv_general_dilated(
        img[None, None], ker[None, None], (1, 1), "SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))[0, 0]


@functools.partial(jax.jit, static_argnames=())
def compute_brief(image: jnp.ndarray, keypoints: jnp.ndarray,
                  valid: jnp.ndarray) -> jnp.ndarray:
    """[K, N_WORDS] uint32 descriptors at keypoints [K,2] (x, y)."""
    img = _box_blur(image.astype(jnp.float32))
    H, W = img.shape
    pat = jnp.asarray(_PATTERN)

    kx = jnp.clip(jnp.round(keypoints[:, 0]).astype(jnp.int32), _PATCH, W - _PATCH - 1)
    ky = jnp.clip(jnp.round(keypoints[:, 1]).astype(jnp.int32), _PATCH, H - _PATCH - 1)

    def sample(x, y):
        return img[y, x]

    x1 = kx[:, None] + pat[None, :, 0]
    y1 = ky[:, None] + pat[None, :, 1]
    x2 = kx[:, None] + pat[None, :, 2]
    y2 = ky[:, None] + pat[None, :, 3]
    bits = (img[y1, x1] < img[y2, x2]).astype(jnp.uint32)    # [K, N_BITS]

    words = bits.reshape(-1, N_WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    packed = jnp.sum(words << shifts[None, None, :], axis=-1).astype(jnp.uint32)
    return packed * valid[:, None].astype(jnp.uint32)


_ORIENT_R = 15  # intensity-centroid radius (ORB uses 15)


def _centroid_grid() -> np.ndarray:
    """[(2R+1)^2, 3] columns (dx, dy, in_circle) for the orientation moment."""
    r = _ORIENT_R
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    mask = (dx * dx + dy * dy) <= r * r
    return np.stack([dx.ravel(), dy.ravel(), mask.ravel()], axis=1).astype(np.int32)

_CENTROID = _centroid_grid()


def keypoint_orientations(image: jnp.ndarray, keypoints: jnp.ndarray) -> jnp.ndarray:
    """[K] patch orientation (radians) by intensity centroid: theta =
    atan2(m01, m10) with mpq = sum x^p y^q I(x, y) over a radius-15 disc."""
    img = image.astype(jnp.float32)
    H, W = img.shape
    r = _ORIENT_R
    kx = jnp.clip(jnp.round(keypoints[:, 0]).astype(jnp.int32), r, W - r - 1)
    ky = jnp.clip(jnp.round(keypoints[:, 1]).astype(jnp.int32), r, H - r - 1)
    g = jnp.asarray(_CENTROID)
    xs = kx[:, None] + g[None, :, 0]
    ys = ky[:, None] + g[None, :, 1]
    I = img[ys, xs] * g[None, :, 2].astype(jnp.float32)       # [K, P]
    m10 = jnp.sum(I * g[None, :, 0].astype(jnp.float32), axis=1)
    m01 = jnp.sum(I * g[None, :, 1].astype(jnp.float32), axis=1)
    return jnp.arctan2(m01, m10)


@jax.jit
def compute_oriented_brief(image: jnp.ndarray, keypoints: jnp.ndarray,
                           valid: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Steered BRIEF: ([K, N_WORDS] uint32 descriptors, [K] angles).

    The fixed sampling pattern is rotated per keypoint by the intensity-
    centroid orientation, so descriptors of the same patch seen under
    in-plane rotation agree (ORB's rBRIEF steering, sans the learned
    pattern — the random-Gaussian pattern keeps bit variance high enough
    for matching; see test_descriptors.py rotation tests)."""
    img = _box_blur(image.astype(jnp.float32))
    H, W = img.shape
    pat = jnp.asarray(_PATTERN, jnp.float32)                  # [N_BITS, 4]

    theta = keypoint_orientations(img, keypoints)             # [K]
    c, s = jnp.cos(theta), jnp.sin(theta)

    # margin covers the worst-case rotated offset (|p| <= sqrt(2)*(PATCH-1))
    m = int(np.ceil(np.sqrt(2.0) * (_PATCH - 1))) + 1
    kx = jnp.clip(jnp.round(keypoints[:, 0]).astype(jnp.int32), m, W - m - 1)
    ky = jnp.clip(jnp.round(keypoints[:, 1]).astype(jnp.int32), m, H - m - 1)

    def rot(px, py):
        rx = c[:, None] * px[None, :] - s[:, None] * py[None, :]
        ry = s[:, None] * px[None, :] + c[:, None] * py[None, :]
        return (jnp.round(rx).astype(jnp.int32),
                jnp.round(ry).astype(jnp.int32))

    dx1, dy1 = rot(pat[:, 0], pat[:, 1])
    dx2, dy2 = rot(pat[:, 2], pat[:, 3])
    bits = (img[ky[:, None] + dy1, kx[:, None] + dx1] <
            img[ky[:, None] + dy2, kx[:, None] + dx2]).astype(jnp.uint32)

    words = bits.reshape(-1, N_WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    packed = jnp.sum(words << shifts[None, None, :], axis=-1).astype(jnp.uint32)
    return packed * valid[:, None].astype(jnp.uint32), theta


def _popcount32(x: jnp.ndarray) -> jnp.ndarray:
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return (x * jnp.uint32(0x01010101)) >> 24


def hamming_matrix(da: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """[Ka, Kb] pairwise hamming distances of packed descriptors."""
    x = jnp.bitwise_xor(da[:, None, :], db[None, :, :])
    return jnp.sum(_popcount32(x), axis=-1).astype(jnp.int32)


class MatchResult(NamedTuple):
    idx_b: jnp.ndarray     # [Ka] best match in B for each A keypoint
    distance: jnp.ndarray  # [Ka]
    good: jnp.ndarray      # [Ka] mutual-NN + ratio + threshold gate


def match_descriptors(da: jnp.ndarray, db: jnp.ndarray,
                      valid_a: jnp.ndarray, valid_b: jnp.ndarray,
                      max_distance: int = 64,
                      ratio: float = 0.85) -> MatchResult:
    """Mutual nearest-neighbor hamming matching with Lowe-style ratio test."""
    D = hamming_matrix(da, db)
    big = jnp.int32(10_000)
    D = jnp.where(valid_a[:, None] & valid_b[None, :], D, big)

    best_b = jnp.argmin(D, axis=1)
    d1 = jnp.min(D, axis=1)
    # second best for the ratio test
    D2 = D.at[jnp.arange(D.shape[0]), best_b].set(big)
    d2 = jnp.min(D2, axis=1)

    # mutual check
    best_a_of_b = jnp.argmin(D, axis=0)
    mutual = best_a_of_b[best_b] == jnp.arange(D.shape[0])

    good = (d1 <= max_distance) & mutual & (d1.astype(jnp.float32)
                                            <= ratio * d2.astype(jnp.float32))
    good = good & valid_a
    return MatchResult(idx_b=best_b, distance=d1, good=good)

"""Scale-space keypoints: multi-level detection + steered BRIEF per level.

The reference prototype's ORB/SIFT pipelines (py_proto/suriko/mvg.py:
1922-2395, OpenCV-backed) are scale-invariant via an image pyramid. Equivalent
here: a sqrt(2)-factor bilinear pyramid (static level shapes), per-level
Shi-Tomasi detection and oriented-BRIEF description, all keypoints reported in
base-image coordinates with their scale. Matching restricted to compatible
scale pairs happens naturally through hamming distance (descriptors of the
same patch at the matching level agree); no quadratic scale search.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from surikatoko_tpu.vision import features
from surikatoko_tpu.vision.descriptors import N_WORDS, compute_oriented_brief

SCALE_FACTOR = math.sqrt(2.0)


def resize_bilinear(img: jnp.ndarray, out_hw: tuple[int, int]) -> jnp.ndarray:
    """Bilinear resize via jax.image (static output shape)."""
    return jax.image.resize(img.astype(jnp.float32), out_hw, method="bilinear")


def pyramid_shapes(base_hw: tuple[int, int], levels: int) -> list[tuple[int, int]]:
    H, W = base_hw
    return [(max(int(round(H / SCALE_FACTOR ** l)), 32),
             max(int(round(W / SCALE_FACTOR ** l)), 32))
            for l in range(levels)]


class ScaleSpaceKeypoints(NamedTuple):
    xy: jnp.ndarray           # [N, 2] base-image coordinates
    scale: jnp.ndarray        # [N] float: SCALE_FACTOR**level
    angle: jnp.ndarray        # [N] orientation (radians)
    descriptors: jnp.ndarray  # [N, N_WORDS] uint32 packed steered BRIEF
    valid: jnp.ndarray        # [N] bool


def detect_and_describe(image: jnp.ndarray, *, levels: int = 4,
                        corners_per_level: int = 24,
                        nms_radius: int = 6, border: int = 36
                        ) -> ScaleSpaceKeypoints:
    """Scale-space detection + description. N = levels * corners_per_level
    slots (masked). Border is in level pixels (descriptor support)."""
    base = jnp.asarray(image, jnp.float32)
    shapes = pyramid_shapes(base.shape, levels)

    xs, ss, an, ds, vs = [], [], [], [], []
    img_l = base
    for l, hw in enumerate(shapes):
        if l > 0:
            img_l = resize_bilinear(base, hw)
        kp, valid = features.detect_corners(
            img_l, max_corners=corners_per_level,
            nms_radius=nms_radius, border=border)
        desc, theta = compute_oriented_brief(img_l, kp, valid)
        s = SCALE_FACTOR ** l
        # map level coords back to base coords (resize maps corner-aligned:
        # base_x ~= x * (H_base/H_l); use per-axis factors to be exact)
        fx = base.shape[1] / hw[1]
        fy = base.shape[0] / hw[0]
        xs.append(kp * jnp.asarray([fx, fy], kp.dtype))
        ss.append(jnp.full((corners_per_level,), s, jnp.float32))
        an.append(theta)
        ds.append(desc)
        vs.append(valid)

    return ScaleSpaceKeypoints(
        xy=jnp.concatenate(xs), scale=jnp.concatenate(ss),
        angle=jnp.concatenate(an), descriptors=jnp.concatenate(ds),
        valid=jnp.concatenate(vs))


def similarity_consistent_matches(kp_a: ScaleSpaceKeypoints,
                                  kp_b: ScaleSpaceKeypoints,
                                  idx_b: jnp.ndarray, good: jnp.ndarray,
                                  *, iters: int = 128, tol: float = 4.0,
                                  seed: int = 0) -> np.ndarray:
    """2-point RANSAC over a 2D similarity transform (scale+rotation+
    translation as one complex multiply-add): returns the inlier mask of the
    best model. The standard geometric filter for scale/rotation-changed
    views; host-side (match post-processing, tiny N)."""
    good_np = np.asarray(good)
    n = int(good_np.sum())
    if n < 2:
        return good_np & False
    ga = np.nonzero(good_np)[0]
    a = np.asarray(kp_a.xy)[ga].astype(np.float64)
    b = np.asarray(kp_b.xy)[np.asarray(idx_b)[ga]].astype(np.float64)
    az = a[:, 0] + 1j * a[:, 1]
    bz = b[:, 0] + 1j * b[:, 1]
    rng = np.random.default_rng(seed)
    best = np.zeros(n, bool)
    for _ in range(iters):
        i, j = rng.choice(n, 2, replace=False)
        if abs(az[i] - az[j]) < 1e-9:
            continue
        alpha = (bz[i] - bz[j]) / (az[i] - az[j])
        beta = bz[i] - alpha * az[i]
        inl = np.abs(alpha * az + beta - bz) < tol
        if inl.sum() > best.sum():
            best = inl
    mask = np.zeros_like(good_np)
    mask[ga[best]] = True
    return mask

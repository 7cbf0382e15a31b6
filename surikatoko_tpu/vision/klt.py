"""Pyramidal Lucas-Kanade point tracking.

The reference prototype tracks corners with cv2.calcOpticalFlowPyrLK
(py_proto/suriko/mvg.py:2066, :3331, :5772 — OpenCV does the work, plus a
border fix at :43). Equivalent here: pure-JAX pyramidal LK — Gaussian
pyramid by strided convolution, per-level fixed-iteration Gauss-Newton on a
fixed (2w+1)^2 window, every point in one vmap, bilinear gathers. All shapes
static, so one jit per (levels, window, iters) configuration; iteration count
is fixed rather than tolerance-driven (lax-friendly, and LK converges in a
handful of steps inside the pull-in range anyway).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

_GAUSS5 = jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _blur_downsample(img: jnp.ndarray) -> jnp.ndarray:
    """5-tap Gaussian blur + 2x decimation (separable convs)."""
    k = _GAUSS5.astype(img.dtype)
    x = img[None, None]
    x = jax.lax.conv_general_dilated(x, k[None, None, :, None], (2, 1), "SAME",
                                     dimension_numbers=("NCHW", "OIHW", "NCHW"))
    x = jax.lax.conv_general_dilated(x, k[None, None, None, :], (1, 2), "SAME",
                                     dimension_numbers=("NCHW", "OIHW", "NCHW"))
    return x[0, 0]


def build_pyramid(img: jnp.ndarray, levels: int) -> list[jnp.ndarray]:
    """[level0=full-res, ..., level_{L-1}=coarsest]."""
    pyr = [img.astype(jnp.float32)]
    for _ in range(levels - 1):
        pyr.append(_blur_downsample(pyr[-1]))
    return pyr


def _bilinear(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample img at float (x, y) grids (clamped to the border)."""
    H, W = img.shape
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


class KltResult(NamedTuple):
    points: jnp.ndarray   # [K, 2] tracked (x, y) in img1
    status: jnp.ndarray   # [K] bool: well-conditioned + stayed in bounds
    error: jnp.ndarray    # [K] mean |I1 - I0| over the window at the solution


def _track_level(img0, img1, pts0_lvl, d, win: int, iters: int, min_det: float):
    """One pyramid level: refine flow d [K,2] for points pts0_lvl [K,2]."""
    r = jnp.arange(-win, win + 1, dtype=img0.dtype)
    uy, ux = jnp.meshgrid(r, r, indexing="ij")
    ux = ux.ravel()
    uy = uy.ravel()

    def one(p, d):
        px = p[0] + ux
        py = p[1] + uy
        i0 = _bilinear(img0, px, py)
        gx = 0.5 * (_bilinear(img0, px + 1, py) - _bilinear(img0, px - 1, py))
        gy = 0.5 * (_bilinear(img0, px, py + 1) - _bilinear(img0, px, py - 1))
        gxx = jnp.sum(gx * gx)
        gxy = jnp.sum(gx * gy)
        gyy = jnp.sum(gy * gy)
        det = gxx * gyy - gxy * gxy
        ok = det > min_det
        det_safe = jnp.where(ok, det, 1.0)

        def body(_, d):
            i1 = _bilinear(img1, px + d[0], py + d[1])
            e = i1 - i0
            bx = jnp.sum(e * gx)
            by = jnp.sum(e * gy)
            ddx = -(gyy * bx - gxy * by) / det_safe
            ddy = -(-gxy * bx + gxx * by) / det_safe
            return d + jnp.where(ok, jnp.stack([ddx, ddy]), 0.0)

        d = jax.lax.fori_loop(0, iters, body, d)
        err = jnp.mean(jnp.abs(_bilinear(img1, px + d[0], py + d[1]) - i0))
        return d, ok, err

    return jax.vmap(one)(pts0_lvl, d)


@functools.partial(jax.jit, static_argnames=("levels", "win", "iters"))
def track_points(img0: jnp.ndarray, img1: jnp.ndarray, pts0: jnp.ndarray,
                 valid: jnp.ndarray | None = None, *,
                 levels: int = 3, win: int = 7, iters: int = 10,
                 min_det: float = 1e-4, max_error: float = 20.0) -> KltResult:
    """Track pts0 [K,2] (x, y) from img0 to img1 (grayscale [H,W]).

    Coarse-to-fine over `levels`; the pull-in range is roughly
    win * 2**(levels-1) pixels of true displacement."""
    img0 = img0.astype(jnp.float32)
    img1 = img1.astype(jnp.float32)
    pyr0 = build_pyramid(img0, levels)
    pyr1 = build_pyramid(img1, levels)
    pts = pts0.astype(jnp.float32)

    K = pts.shape[0]
    d = jnp.zeros((K, 2), jnp.float32)
    ok_all = jnp.ones((K,), bool)
    err = jnp.zeros((K,), jnp.float32)
    for lvl in range(levels - 1, -1, -1):
        scale = jnp.float32(2.0 ** lvl)
        d, ok, err = _track_level(pyr0[lvl], pyr1[lvl], pts / scale, d,
                                  win, iters, min_det)
        ok_all = jnp.logical_and(ok_all, ok)
        if lvl > 0:
            d = d * 2.0

    new_pts = pts + d
    H, W = img1.shape
    in_bounds = ((new_pts[:, 0] >= win) & (new_pts[:, 0] <= W - 1 - win)
                 & (new_pts[:, 1] >= win) & (new_pts[:, 1] <= H - 1 - win))
    status = ok_all & in_bounds & (err < max_error)
    if valid is not None:
        status = status & valid
    return KltResult(points=new_pts, status=status, error=err)

"""Pinhole camera with Mikhail radial distortion; projection conventions of the
reference engine.

Parity notes (vs reference davison-mono-slam.cpp):
* Projection (:3007 ``ProjectCameraSalientPoint``):
      hu = [Cx - fx * X/Z,  Cy - fy * Y/Z]
  (negated because the camera frame is Left-Up-Forward, see geom/se3.py).
* Backprojection (:2418 ``BackprojectPixelIntoCameraPlane``):
      hc = [-(u - Cx)/fx, -(v - Cy)/fy, 1]
* Mikhail radial distortion (:2960 ``DistortPixel``): with radius measured in
  mm via the pixel size, ru = rd + k1 rd^3 + k2 rd^5; the *distorted* pixel is
      hd = C + (hu - C)/stretch,    stretch = 1 + k1 rd^2 + k2 rd^4,
  and undistortion (:2405) evaluates rd directly from hd then multiplies by
  stretch. The reference solves the quintic with Eigen's PolynomialSolver;
  here a fixed-iteration Newton solve (jit-friendly, converges in <6
  iterations for realistic k1,k2).
* Azimuth/elevation of a direction (:399 ``AzimElevFromEuclidCoords``):
      theta = atan2(x, z),  phi = atan2(-y, sqrt(x^2+z^2))
  and the inverse unit direction m(theta, phi) (:469).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class CameraIntrinsics(NamedTuple):
    image_size: jnp.ndarray          # [2] (width, height) pixels (static ints ok)
    principal_point: jnp.ndarray     # [2] (Cx, Cy) pixels
    focal_length_mm: jnp.ndarray     # scalar
    pixel_size_mm: jnp.ndarray       # [2] (dx, dy)

    @property
    def focal_length_pix(self) -> jnp.ndarray:
        return self.focal_length_mm / self.pixel_size_mm


class MikhailDistortion(NamedTuple):
    k1: jnp.ndarray
    k2: jnp.ndarray


def make_intrinsics(image_size, principal_point, focal_length_mm, pixel_size_mm, dtype=None) -> CameraIntrinsics:
    dtype = dtype or jnp.result_type(float)
    return CameraIntrinsics(
        image_size=jnp.asarray(image_size, dtype=dtype),
        principal_point=jnp.asarray(principal_point, dtype=dtype),
        focal_length_mm=jnp.asarray(focal_length_mm, dtype=dtype),
        pixel_size_mm=jnp.asarray(pixel_size_mm, dtype=dtype),
    )


def no_distortion(dtype=None) -> MikhailDistortion:
    dtype = dtype or jnp.result_type(float)
    return MikhailDistortion(jnp.zeros((), dtype), jnp.zeros((), dtype))


def _radius_mm(cam: CameraIntrinsics, pix: jnp.ndarray) -> jnp.ndarray:
    d = (pix - cam.principal_point) * cam.pixel_size_mm
    # tiny bias keeps sqrt differentiable at the principal point (r=0), where
    # autodiff of the distortion model would otherwise produce NaN that no
    # amount of downstream masking can remove (0 * nan = nan)
    return jnp.sqrt(jnp.sum(d * d, axis=-1) + jnp.asarray(1e-24, d.dtype))


def solve_distorted_radius(ru: jnp.ndarray, k1: jnp.ndarray, k2: jnp.ndarray,
                           newton_iters: int = 8) -> jnp.ndarray:
    """Root rd of g(rd) = rd + k1 rd^3 + k2 rd^5 = ru (k1,k2 >= 0).

    g is increasing and convex on rd>=0, so Newton from ANY point >= the root
    converges monotonically and quadratically. Each of ru, (ru/k1)^(1/3),
    (ru/k2)^(1/5) is an upper bound on the root (each term of g alone must not
    exceed ru); starting from their minimum converges in <6 iterations for
    any radius — including far off-image projections where the naive rd0=ru
    start needs dozens of steps (quintic-dominated regime shrinks Newton steps
    by only 4/5 per iteration). Keeping the iteration fully converged also
    makes autodiff through it agree with the closed-form implicit derivative
    used by the analytic Jacobians (models/monoslam/measure._dproj_dy)."""
    tiny = jnp.asarray(1e-30, ru.dtype)
    rd = jnp.minimum(ru, (ru / jnp.maximum(k1, tiny)) ** (1.0 / 3.0))
    rd = jnp.minimum(rd, (ru / jnp.maximum(k2, tiny)) ** (1.0 / 5.0))
    for _ in range(newton_iters):
        f = rd + k1 * rd**3 + k2 * rd**5 - ru
        fp = 1.0 + 3.0 * k1 * rd**2 + 5.0 * k2 * rd**4
        rd = rd - f / fp
    return rd


def distort_pixel(cam: CameraIntrinsics, dist: MikhailDistortion, hu: jnp.ndarray,
                  newton_iters: int = 8) -> jnp.ndarray:
    """Undistorted pixel hu -> distorted pixel hd (Newton solve of the
    radius quintic; the reference uses Eigen's PolynomialSolver,
    davison-mono-slam.cpp:2960-2997)."""
    ru = _radius_mm(cam, hu)
    rd = solve_distorted_radius(ru, dist.k1, dist.k2, newton_iters)
    stretch = 1.0 + dist.k1 * rd**2 + dist.k2 * rd**4
    return cam.principal_point + (hu - cam.principal_point) / stretch[..., None]


def undistort_pixel(cam: CameraIntrinsics, dist: MikhailDistortion, hd: jnp.ndarray) -> jnp.ndarray:
    """Distorted pixel hd -> undistorted hu (closed form: rd known from hd)."""
    rd = _radius_mm(cam, hd)
    stretch = 1.0 + dist.k1 * rd**2 + dist.k2 * rd**4
    return cam.principal_point + (hd - cam.principal_point) * stretch[..., None]


def project_camera_point(cam: CameraIntrinsics, dist: MikhailDistortion | None,
                         x_cam: jnp.ndarray) -> jnp.ndarray:
    """3D point in camera frame -> distorted pixel. Works batched.

    Note the sign: hu = C - f * [X/Z, Y/Z] (reference :3007).
    """
    f = cam.focal_length_pix
    z = x_cam[..., 2]
    hu = cam.principal_point - f * x_cam[..., :2] / z[..., None]
    if dist is None:
        return hu
    return distort_pixel(cam, dist, hu)


def backproject_pixel(cam: CameraIntrinsics, dist: MikhailDistortion | None,
                      hd: jnp.ndarray) -> jnp.ndarray:
    """Distorted pixel -> direction [x, y, 1] in the camera frame (A.58)."""
    hu = hd if dist is None else undistort_pixel(cam, dist, hd)
    f = cam.focal_length_pix
    xy = -(hu - cam.principal_point) / f
    return jnp.concatenate([xy, jnp.ones_like(xy[..., :1])], axis=-1)


def azim_elev_from_dir(hw: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Azimuth theta / elevation phi of a (world) direction (reference :399)."""
    theta = jnp.arctan2(hw[..., 0], hw[..., 2])
    phi = jnp.arctan2(-hw[..., 1], jnp.sqrt(hw[..., 0] ** 2 + hw[..., 2] ** 2))
    return theta, phi


def dir_from_azim_elev(theta: jnp.ndarray, phi: jnp.ndarray) -> jnp.ndarray:
    """Unit direction m(theta, phi), inverse of :func:`azim_elev_from_dir`
    (reference :469)."""
    cphi = jnp.cos(phi)
    return jnp.stack([cphi * jnp.sin(theta), -jnp.sin(phi), cphi * jnp.cos(theta)], axis=-1)

"""Measurement model h(x): project spherical inverse-depth landmarks into the
current camera, batched over all slots, with autodiff Jacobian blocks.

Forward model (reference davison-mono-slam.cpp:2880-3035):
  m = dir(theta, phi)                               # unit ray in tracker frame
  hc_scaled = R_cfw @ (rho * (x_first - r) + m)     # A.21, valid at rho -> 0
  hd = distort(C - f * hc_scaled[:2]/hc_scaled[2])  # pixel

The observation Jacobian H[2m, 13+6K] of the reference
(``Deriv_H_by_estim_vars`` :3115) is block-sparse: each observation depends on
the 13 camera vars and its own 6 landmark vars. We never materialize the dense
H — update.py consumes the per-slot blocks [K,2,13] and [K,2,6] directly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from surikatoko_tpu.geom import camera as cam_mod
from surikatoko_tpu.geom import quat
from surikatoko_tpu.models.monoslam.state import (
    CAM_STATE_COMPS,
    REPRES_SPHERICAL,
    REPRES_XYZ,
    MonoSlamParams,
)


def landmark_camera_point_scaled(cam13: jnp.ndarray, lm6: jnp.ndarray,
                                 repres: int = REPRES_SPHERICAL) -> jnp.ndarray:
    """Landmark position in the camera frame; for the spherical representation
    it is scaled by inverse depth rho (finite at infinity, rho=0). Reference
    ``InternalSalientPointToCamera`` with scaled_by_inv_dist=true
    (davison-mono-slam.cpp:2880-2940); XYZ branch = the unscaled :2905-2913
    (a uniform scale does not change the projected pixel)."""
    r = cam13[0:3]
    q = cam13[3:7]
    R_wfc = quat.to_rotmat(q)
    if repres == REPRES_XYZ:
        v_world = lm6[0:3] - r
    else:
        first_cam = lm6[0:3]
        theta, phi, rho = lm6[3], lm6[4], lm6[5]
        m = cam_mod.dir_from_azim_elev(theta, phi)
        v_world = rho * (first_cam - r) + m
    return R_wfc.T @ v_world  # cfw = wfc^T


def project_landmark(params: MonoSlamParams, cam13: jnp.ndarray, lm6: jnp.ndarray) -> jnp.ndarray:
    """Distorted pixel of one landmark (reference ProjectInternalSalientPoint
    :2948)."""
    hc = landmark_camera_point_scaled(cam13, lm6, params.sal_pnt_repres)
    dist = params.dist if params.enable_distortion else None
    return cam_mod.project_camera_point(params.cam, dist, hc)


def landmark_world_pos(lm6: jnp.ndarray, substitute_rho: jnp.ndarray | None = None,
                       repres: int = REPRES_SPHERICAL) -> jnp.ndarray:
    """Euclidean 3D position of a landmark slot (reference
    ConvertXyzFromSphericalSalientPoint :405-415; identity for XYZ). For
    rho<=0 the spherical point is behind/at infinity; optionally substitute a
    small positive rho."""
    if repres == REPRES_XYZ:
        return lm6[0:3]
    rho = lm6[5]
    if substitute_rho is not None:
        rho = jnp.where(rho <= 0, substitute_rho, rho)
    m = cam_mod.dir_from_azim_elev(lm6[3], lm6[4])
    return lm6[0:3] + m / rho


def spherical_to_xyz_slot(lm6: jnp.ndarray) -> jnp.ndarray:
    """Spherical slot -> XYZ slot (position + zero padding); reference
    conversion davison-mono-slam.cpp:405-415."""
    pos = landmark_world_pos(lm6)
    return jnp.concatenate([pos, jnp.zeros((3,), lm6.dtype)])


def xyz_to_spherical_slot(lm6: jnp.ndarray, first_cam_pos: jnp.ndarray) -> jnp.ndarray:
    """XYZ slot -> spherical slot anchored at `first_cam_pos` (reference
    conversion davison-mono-slam.cpp:417-467)."""
    d = lm6[0:3] - first_cam_pos
    theta, phi = cam_mod.azim_elev_from_dir(d)
    rho = 1.0 / jnp.linalg.norm(d)
    return jnp.concatenate([first_cam_pos, jnp.stack([theta, phi, rho])])


def project_all(params: MonoSlamParams, x: jnp.ndarray) -> jnp.ndarray:
    """Predicted pixels for all K slots: [K, 2]."""
    cam13 = x[:CAM_STATE_COMPS]
    lms = x[CAM_STATE_COMPS:].reshape(-1, 6)
    return jax.vmap(lambda lm: project_landmark(params, cam13, lm))(lms)


def measurement_jacobians_ad(
    params: MonoSlamParams, x: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(h [K,2], Hcam [K,2,13], Hlm [K,2,6]) by jax.jacfwd over the joint
    (cam13, lm6) arguments — the autodiff ground truth that
    tests/test_monoslam_jacobians.py checks against finite differences the way
    the reference's debug flags did (and against the analytic fast path)."""
    cam13 = x[:CAM_STATE_COMPS]
    lms = x[CAM_STATE_COMPS:].reshape(-1, 6)

    def h_fn(c, lm):
        return project_landmark(params, c, lm)

    h = jax.vmap(lambda lm: h_fn(cam13, lm))(lms)
    jac_fn = jax.jacfwd(h_fn, argnums=(0, 1))
    Hcam, Hlm = jax.vmap(lambda lm: jac_fn(cam13, lm))(lms)
    return h, Hcam, Hlm


def _drotmat_dq(q: jnp.ndarray) -> jnp.ndarray:
    """d(to_rotmat)/dq as [4,3,3] (derivative of the non-normalized
    unit-quaternion formula, matching quat.to_rotmat exactly)."""
    w, xq, y, z = q[0], q[1], q[2], q[3]
    o = jnp.zeros((), q.dtype)
    dw = 2.0 * jnp.stack([o, -z, y, z, o, -xq, -y, xq, o]).reshape(3, 3)
    dx = 2.0 * jnp.stack([o, y, z, y, -2 * xq, -w, z, w, -2 * xq]).reshape(3, 3)
    dy = 2.0 * jnp.stack([-2 * y, xq, w, xq, o, z, -w, z, -2 * y]).reshape(3, 3)
    dz = 2.0 * jnp.stack([-2 * z, -w, xq, w, -2 * z, y, xq, y, o]).reshape(3, 3)
    return jnp.stack([dw, dx, dy, dz])


def _dproj_dy(params: MonoSlamParams, y: jnp.ndarray
              ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(pix [K,2], J = d pix / d y_cam [K,2,3]) for camera-frame points y,
    chaining the pinhole and (closed-form implicit) Mikhail distortion
    derivatives. Analytic twin of autodiffing camera.project_camera_point."""
    cam = params.cam
    f = cam.focal_length_pix                       # [2]
    z = y[:, 2]
    inv_z = 1.0 / z
    hu = cam.principal_point - f * y[:, :2] / z[:, None]
    # d hu / d y: rows [-f_i/z * e_i, +f_i * y_i / z^2]
    K = y.shape[0]
    zero = jnp.zeros((K,), y.dtype)
    Jx = jnp.stack([-f[0] * inv_z, zero, f[0] * y[:, 0] * inv_z * inv_z], axis=-1)
    Jy = jnp.stack([zero, -f[1] * inv_z, f[1] * y[:, 1] * inv_z * inv_z], axis=-1)
    J_hu = jnp.stack([Jx, Jy], axis=1)             # [K,2,3]
    if not params.enable_distortion:
        return hu, J_hu

    # hd = C + p/stretch(rd), p = hu - C, ru(|p|) = g(rd) implicit (camera.py)
    dist = params.dist
    k1, k2 = dist.k1, dist.k2
    p = hu - cam.principal_point                   # [K,2] pixels
    d_mm = p * cam.pixel_size_mm
    ru = jnp.sqrt(jnp.sum(d_mm * d_mm, axis=-1) + jnp.asarray(1e-24, y.dtype))
    rd = cam_mod.solve_distorted_radius(ru, k1, k2)
    gp = 1.0 + 3.0 * k1 * rd**2 + 5.0 * k2 * rd**4
    stretch = 1.0 + k1 * rd**2 + k2 * rd**4
    hd = cam.principal_point + p / stretch[:, None]
    # d(1/stretch)/dhu = -(stretch'/stretch^2) * (drd/dru) * dru/dhu
    dstretch_drd = 2.0 * k1 * rd + 4.0 * k2 * rd**3
    dru_dhu = d_mm * cam.pixel_size_mm / ru[:, None]          # [K,2]
    dinv_dhu = (-dstretch_drd / (gp * stretch * stretch))[:, None] * dru_dhu
    # d hd_i / d hu_j = delta_ij/stretch + p_i * dinv_dhu_j
    J_hd = (jnp.eye(2, dtype=y.dtype) / stretch[:, None, None]
            + p[:, :, None] * dinv_dhu[:, None, :])           # [K,2,2]
    return hd, jnp.einsum("kij,kjl->kil", J_hd, J_hu)


def batched_jacobians(params: MonoSlamParams, cam13: jnp.ndarray,
                      lms: jnp.ndarray
                      ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(h [K,2], Hcam [K,2,13], Hlm [K,2,6]) for landmark slots ``lms``.

    Analytic, fully [K]-batched chain rule — the hot-path equivalent of the
    reference's hand-written Deriv_hd_by_cam_state_and_sal_pnt
    (davison-mono-slam.cpp:3067-3360). The camera-shared pieces (R, dR/dq) are
    computed once, every per-landmark factor is a [K,...] tensor op; measured
    ~2.5x faster per frame than the jacfwd formulation it replaces
    (measurement_jacobians_ad), which remains the correctness oracle in
    tests/test_monoslam_jacobians.py. Shared by the single-device update and
    the landmark-sharded kernel (parallel/sharded_ekf.py) so their numerics
    are identical.
    """
    K = lms.shape[0]
    dtype = cam13.dtype

    r = cam13[0:3]
    q = cam13[3:7]
    R = quat.to_rotmat(q)                          # wfc; y = R^T v = v @ R
    Dq = _drotmat_dq(q)                            # [4,3,3]

    if params.sal_pnt_repres == REPRES_XYZ:
        v = lms[:, 0:3] - r                        # [K,3]
    else:
        c0 = lms[:, 0:3]
        theta, phi, rho = lms[:, 3], lms[:, 4], lms[:, 5]
        st, ct = jnp.sin(theta), jnp.cos(theta)
        sp, cp = jnp.sin(phi), jnp.cos(phi)
        m = jnp.stack([cp * st, -sp, cp * ct], axis=-1)
        dm_dtheta = jnp.stack([cp * ct, jnp.zeros_like(cp), -cp * st], axis=-1)
        dm_dphi = jnp.stack([-sp * st, -cp, -sp * ct], axis=-1)
        diff = c0 - r
        v = rho[:, None] * diff + m

    y = v @ R                                      # [K,3] camera-frame (scaled)
    h, J = _dproj_dy(params, y)                    # [K,2], [K,2,3]

    JR = J @ R.T                                   # [K,2,3] = J @ d y / d v
    # d y / d q_a = Dq[a]^T v  ->  Hq = J ( Dq^T v )
    dy_dq = jnp.einsum("aij,ki->kja", Dq, v)       # [K,3,4]
    Hq = jnp.einsum("kij,kja->kia", J, dy_dq)      # [K,2,4]

    if params.sal_pnt_repres == REPRES_XYZ:
        Hr = -JR
        Hlm = jnp.concatenate([JR, jnp.zeros((K, 2, 3), dtype)], axis=-1)
    else:
        Hr = -rho[:, None, None] * JR
        Hc0 = rho[:, None, None] * JR
        Hth = jnp.einsum("kij,kj->ki", JR, dm_dtheta)[:, :, None]
        Hph = jnp.einsum("kij,kj->ki", JR, dm_dphi)[:, :, None]
        Hrho = jnp.einsum("kij,kj->ki", JR, diff)[:, :, None]
        Hlm = jnp.concatenate([Hc0, Hth, Hph, Hrho], axis=-1)

    Hcam = jnp.concatenate(
        [Hr, Hq, jnp.zeros((K, 2, 6), dtype)], axis=-1)       # [K,2,13]
    return h, Hcam, Hlm


def measurement_jacobians(
    params: MonoSlamParams, x: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(h [K,2], Hcam [K,2,13], Hlm [K,2,6]) for all slots of state ``x``."""
    return batched_jacobians(params, x[:CAM_STATE_COMPS],
                             x[CAM_STATE_COMPS:].reshape(-1, 6))

"""Filter-health mechanisms: the reference's self-healing toolbox (SURVEY §5.3).

Reference mapping (davison-mono-slam.cpp):
  normalize_quat_and_covar  <- NormalizeCameraOrientationQuaternionAndCovariances :1652
  ensure_nonneg_variance    <- EnsureNonnegativeStateVariance :1739
  substitute_negative_inv_rho <- :1713-1737
  symmetrize                <- FixSymmetricMat :4308
  check_state               <- CheckCameraAndSalientPointsCovs :514
  bad-ellipsoid removal mask <- RemoveSalientPointsWithNonextractableUncertEllipsoid :542
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from surikatoko_tpu.geom import ellipse as ell_mod
from surikatoko_tpu.models.monoslam.state import CAM_STATE_COMPS, MonoSlamState

_N = CAM_STATE_COMPS


def normalize_quat_and_covar(x: jnp.ndarray, P: jnp.ndarray
                             ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Renormalize the camera quaternion and propagate the normalization
    Jacobian into the covariance: P <- J P J^T where J is identity except the
    4x4 d(q/|q|)/dq block."""
    q = x[3:7]
    norm_fn = lambda qq: qq / jnp.linalg.norm(qq)
    Jq = jax.jacfwd(norm_fn)(q)                    # [4,4]
    x_new = x.at[3:7].set(norm_fn(q))
    # P <- J P J^T exploiting J = I + E (E nonzero only on the quat block);
    # only the 4-wide quat stripe changes, so instead of a full O(D^2)
    # symmetrize we write the column stripe as the exact transpose of the row
    # stripe (and symmetrize the tiny 4x4 corner where both were applied)
    rows = Jq @ P[3:7, :]                      # [4,D] = (J P)[3:7,:]
    corner = rows[:, 3:7] @ Jq.T               # [4,4]
    corner = 0.5 * (corner + corner.T)
    P_new = P.at[3:7, :].set(rows)
    P_new = P_new.at[:, 3:7].set(rows.T)
    P_new = P_new.at[3:7, 3:7].set(corner)
    return x_new, P_new


def ensure_nonneg_variance(P: jnp.ndarray) -> jnp.ndarray:
    """Zero the rows/cols of any state variable with negative variance
    (numerical defense; reference :1739-1756)."""
    bad = jnp.diag(P) < 0
    keep = jnp.logical_not(bad).astype(P.dtype)
    return P * keep[:, None] * keep[None, :]


def substitute_negative_inv_rho(x: jnp.ndarray, substitute: jnp.ndarray,
                                capacity: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Replace negative inverse depths with a small positive value; returns
    (x', count substituted). Reference flag sal_pnt_negative_inv_rho_substitute
    (davison-mono-slam.h:474)."""
    lms = x[_N:].reshape(capacity, 6)
    neg = lms[:, 5] < 0
    lms = lms.at[:, 5].set(jnp.where(neg, substitute, lms[:, 5]))
    return x.at[_N:].set(lms.reshape(-1)), jnp.sum(neg.astype(jnp.int32))


def symmetrize(P: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * (P + P.T)


def landmark_pos_covariances(x: jnp.ndarray, P: jnp.ndarray, capacity: int,
                             substitute_rho: jnp.ndarray,
                             repres: int = 2) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(pos [K,3], cov [K,3,3]) of each landmark's Euclidean position by
    first-order propagation through the spherical->XYZ map (reference
    GetSalientPoint3DPosWithUncertaintyNew :3889; identity map for XYZ
    slots)."""
    from surikatoko_tpu.models.monoslam import measure

    lms = x[_N:].reshape(capacity, 6)

    def one(slot_lm, slot_cov):
        f = lambda lm: measure.landmark_world_pos(lm, substitute_rho, repres)
        pos = f(slot_lm)
        J = jax.jacfwd(f)(slot_lm)
        return pos, J @ slot_cov @ J.T

    covs6 = jax.vmap(
        lambda k: jax.lax.dynamic_slice(P, (_N + k * 6, _N + k * 6), (6, 6))
    )(jnp.arange(capacity))
    return jax.vmap(one)(lms, covs6)


def bad_uncertainty_mask(x: jnp.ndarray, P: jnp.ndarray, capacity: int,
                         substitute_rho: jnp.ndarray,
                         repres: int = 2) -> jnp.ndarray:
    """True for landmarks whose 3D uncertainty ellipsoid is non-extractable
    (non-PSD / non-finite propagated covariance) — candidates for removal.

    Positive-definiteness via Sylvester's criterion (three leading minors)
    instead of eigendecomposition: closed-form, no K batched 3x3 eigh calls
    (hot: runs every frame)."""
    _, covs = landmark_pos_covariances(x, P, capacity, substitute_rho, repres)
    a, b, c = covs[:, 0, 0], covs[:, 0, 1], covs[:, 0, 2]
    d, e, f = covs[:, 1, 1], covs[:, 1, 2], covs[:, 2, 2]
    det2 = a * d - b * b
    det3 = (a * (d * f - e * e) - b * (b * f - e * c) + c * (b * e - d * c))
    finite = jnp.all(jnp.isfinite(covs.reshape(capacity, -1)), axis=-1)
    pd = (a > 0) & (det2 > 0) & (det3 > 0)
    return jnp.logical_not(jnp.logical_and(finite, pd))


def reset_camera_to_gt(state: MonoSlamState, gt_cam13: jnp.ndarray,
                       pos_std: float = 0.0, q_comp_std: float = 0.0,
                       vel_std: float = 0.0, ang_vel_std: float = 0.0
                       ) -> MonoSlamState:
    """Manual recovery — the reference's 'u' hotkey
    (SetEstimStateAndCovarToGroundTruth, davison-mono-slam.cpp:2117-2140):
    snap the camera state to ground truth, zero the camera-landmark
    cross-covariance, and reinitialize the camera covariance diagonal."""
    x = state.x.at[:_N].set(gt_cam13.astype(state.x.dtype))
    P = state.P
    P = P.at[:_N, :].set(0.0)
    P = P.at[:, :_N].set(0.0)
    diag = jnp.concatenate([
        jnp.full((3,), pos_std**2), jnp.full((4,), q_comp_std**2),
        jnp.full((3,), vel_std**2), jnp.full((3,), ang_vel_std**2),
    ]).astype(P.dtype)
    P = P.at[jnp.arange(_N), jnp.arange(_N)].set(diag)
    return state._replace(x=x, P=P)


def reset_state_to_gt(
    params, state: MonoSlamState, gt_cam13: jnp.ndarray,
    gt_pix: jnp.ndarray, gt_rho: jnp.ndarray, slot_mask: jnp.ndarray, *,
    impl: int = 2,
    cam_pos_std: float = 0.0, cam_q_comp_std: float = 0.0,
    cam_vel_std: float = 0.0, cam_ang_vel_std: float = 0.0,
    sal_pnt_first_cam_pos_std: float = 0.0, sal_pnt_azimuth_std: float = 0.0,
    sal_pnt_elevation_std: float = 0.0, sal_pnt_inv_dist_std: float = 0.0,
    sal_pnt_pos_std: tuple = (0.0, 0.0, 0.0),
) -> MonoSlamState:
    """FULL manual recovery — the reference's 'u' hotkey
    (SetEstimStateAndCovarToGroundTruth, davison-mono-slam.cpp:2117-2140):
    rebuild the whole state from ground truth (camera 13-state + every
    active landmark re-initialized from its GT pixel + inverse distance)
    and re-derive the covariance with one of the reference's two strategies:

    impl=1 (SetEstimStateCovarInEstimSpace :2015): zero P, camera diagonal
      from the cam_*_std flags, per-landmark DIAGONAL blocks from the
      sal_pnt_*_std_if_gt flags (spherical) / sal_pnt_pos_std (XYZ) —
      correlations ignored.
    impl=2 (SetEstimStateCovarLikeInAddNewSalPnt :2049): camera block as in
      impl 1, then each landmark's covariance computed exactly as if
      AddSalientPoint were called on it (A.67-A.79 propagation including
      cross-covariances to all preceding variables). The reference
      linearizes at each landmark's FIRST observing frame; here the caller
      supplies the linearization observation (gt_pix/gt_rho, typically the
      current frame) — same construction, explicit seam.

    gt_pix/gt_rho are [K,2]/[K] per SLOT; slot_mask marks the active slots
    to rebuild (others are zeroed and deactivated)."""
    from surikatoko_tpu.models.monoslam import landmarks as lm_mod
    from surikatoko_tpu.models.monoslam.state import REPRES_XYZ

    Kcap = state.capacity
    dtype = state.x.dtype
    gt_cam13 = gt_cam13.astype(dtype)

    cam_diag = jnp.concatenate([
        jnp.full((3,), cam_pos_std ** 2), jnp.full((4,), cam_q_comp_std ** 2),
        jnp.full((3,), cam_vel_std ** 2),
        jnp.full((3,), cam_ang_vel_std ** 2)]).astype(dtype)
    D = state.x.shape[0]
    x0 = jnp.zeros((D,), dtype).at[:_N].set(gt_cam13)
    P0 = jnp.zeros((D, D), dtype)
    P0 = P0.at[jnp.arange(_N), jnp.arange(_N)].set(cam_diag)

    if impl == 1:
        # states and diagonal blocks, no correlations
        y = jax.vmap(lambda p, r: lm_mod.new_landmark_state(
            params, gt_cam13[:7], p, r))(gt_pix, gt_rho.astype(dtype))
        if params.sal_pnt_repres == REPRES_XYZ:
            blk = jnp.concatenate([
                jnp.asarray(sal_pnt_pos_std, dtype) ** 2,
                jnp.zeros((3,), dtype)])
        else:
            blk = jnp.asarray([
                sal_pnt_first_cam_pos_std ** 2, sal_pnt_first_cam_pos_std ** 2,
                sal_pnt_first_cam_pos_std ** 2, sal_pnt_azimuth_std ** 2,
                sal_pnt_elevation_std ** 2, sal_pnt_inv_dist_std ** 2], dtype)

        def write1(carry, inp):
            x, P = carry
            k, yk, ok = inp
            off = _N + k * 6
            x_n = jax.lax.dynamic_update_slice(x, yk, (off,))
            P_n = jax.lax.dynamic_update_slice(
                P, jnp.diag(blk), (off, off))
            return (jnp.where(ok, x_n, x), jnp.where(ok, P_n, P)), None

        (x, P), _ = jax.lax.scan(
            write1, (x0, P0), (jnp.arange(Kcap), y, slot_mask))
    else:
        # like AddSalientPoint, slot-aligned (cross-covariances to all
        # previously written vars via new_landmark_covariance's J_cam P row)
        def write2(carry, inp):
            x, P = carry
            k, pix, rho, ok = inp
            y, auto, cross = lm_mod.new_landmark_covariance(
                params, x, P, pix, rho.astype(dtype),
                params.sal_pnt_init_inv_dist_std)
            off = _N + k * 6
            x_n = jax.lax.dynamic_update_slice(x, y, (off,))
            P_n = jax.lax.dynamic_update_slice(P, cross, (off, 0))
            P_n = jax.lax.dynamic_update_slice(P_n, cross.T, (0, off))
            P_n = jax.lax.dynamic_update_slice(P_n, auto, (off, off))
            return (jnp.where(ok, x_n, x), jnp.where(ok, P_n, P)), None

        (x, P), _ = jax.lax.scan(
            write2, (x0, P0),
            (jnp.arange(Kcap), gt_pix.astype(dtype), gt_rho, slot_mask))

    return state._replace(
        x=x, P=P, lm_active=jnp.asarray(slot_mask, bool),
        lm_unobserved=jnp.where(slot_mask, 0, state.lm_unobserved))


def check_state(state: MonoSlamState, atol: float = 1e-3) -> jnp.ndarray:
    """Cheap invariant check (quat unity, nonneg diag): scalar bool."""
    q_ok = jnp.abs(jnp.linalg.norm(state.x[3:7]) - 1.0) < atol
    diag_ok = jnp.all(jnp.diag(state.P) >= -atol)
    return jnp.logical_and(q_ok, diag_ok)

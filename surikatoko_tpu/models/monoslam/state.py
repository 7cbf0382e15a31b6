"""MonoSlam state layout: fixed-capacity pytree replacing the reference's
dynamically-resized state vector/covariance.

Layout (reference davison-mono-slam.h:21-36):
  camera x[0:13] = [r(3) tracker-frame position, q(4) wfc quaternion scalar-first,
                    v(3) linear velocity in tracker frame, w(3) angular velocity
                    in camera frame]
  landmark slot k: x[13+6k : 13+6k+6] = [first_cam_pos_w(3), azimuth theta,
                    elevation phi, inverse distance rho]  (spherical
                    inverse-depth, reference SAL_PNT_REPRES=2)

The tracker "world" frame is the first camera's frame (kTrackerOriginCamInd=0).

Unlike the reference (state grows/shrinks via conservativeResize), capacity is
static: K slots, D = 13+6K variables always. `lm_active` marks live slots;
inactive slots carry zero covariance rows/cols and identity-ish diagonal so
every dense kernel is shape-stable under jit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from surikatoko_tpu.geom.camera import CameraIntrinsics, MikhailDistortion

CAM_STATE_COMPS = 13
SAL_PNT_COMPS = 6
PROCESS_NOISE_COMPS = 6  # velocity + angular velocity white noise

# Salient-point representation (reference SAL_PNT_REPRES compile-time switch,
# suriko-engine/CMakeLists.txt:14-17, davison-mono-slam.h:39). This build
# keeps ONE 6-wide slot layout for both: XYZ uses comps [0:3] and pads [3:6]
# with zeros (zero covariance rows — dead weight a dense kernel doesn't
# notice), so both representations share every compiled kernel.
REPRES_XYZ = 1
REPRES_SPHERICAL = 2


class MonoSlamParams(NamedTuple):
    """Filter parameters (all jax scalars/arrays; static shape)."""

    cam: CameraIntrinsics
    dist: MikhailDistortion
    enable_distortion: bool          # static python bool (affects trace)
    dt: jnp.ndarray                  # seconds per frame
    process_noise_cov: jnp.ndarray   # [6,6] diag(sigma_v^2 *3, sigma_w^2 *3)
    measurm_noise_var: jnp.ndarray   # pixel measurement variance (scalar)
    sal_pnt_init_inv_dist: jnp.ndarray      # rho0 for new landmarks
    sal_pnt_init_inv_dist_std: jnp.ndarray  # sigma_rho for new landmarks
    sal_pnt_negative_inv_rho_substitute: jnp.ndarray  # clamp value (reference h:474)
    max_undetected_frames: jnp.ndarray      # delete policy (int)
    covar2d_to_ellipse_confidence: jnp.ndarray
    sal_pnt_repres: int = REPRES_SPHERICAL  # static python int (affects trace)
    # 1-point RANSAC gates (reference flags monoslam_1pransac_corner_max_
    # divergence_pix / monoslam_1pransac_high_innov_chisq_thr_pix2)
    ransac_corner_max_divergence_pix: jnp.ndarray | None = None  # None -> noise std
    ransac_high_innov_chi_square_thresh: jnp.ndarray | None = None  # None -> 9.21034
    # per-frame covariance diagonal inflation (f32 conditioning: keeps P
    # positive definite over thousands of chained downdates; the reference's
    # f64 never needed it — see fused_step). 0.0 = off.
    covar_diag_inflation: jnp.ndarray | None = None


class MonoSlamState(NamedTuple):
    x: jnp.ndarray               # [D]
    P: jnp.ndarray               # [D, D]
    lm_active: jnp.ndarray       # [K] bool
    lm_unobserved: jnp.ndarray   # [K] int32: consecutive frames without a match
    lm_generation: jnp.ndarray   # [K] int32: bumped on slot reuse (stable ids)
    frame_ind: jnp.ndarray       # int32

    @property
    def capacity(self) -> int:
        return self.lm_active.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[0]

    # --- camera state accessors ---
    @property
    def cam_pos(self) -> jnp.ndarray:
        return self.x[0:3]

    @property
    def cam_quat(self) -> jnp.ndarray:
        return self.x[3:7]

    @property
    def cam_vel(self) -> jnp.ndarray:
        return self.x[7:10]

    @property
    def cam_ang_vel(self) -> jnp.ndarray:
        return self.x[10:13]

    def landmarks(self) -> jnp.ndarray:
        """All landmark slot states as [K, 6]."""
        return self.x[CAM_STATE_COMPS:].reshape(-1, SAL_PNT_COMPS)


def make_params(
    cam: CameraIntrinsics,
    dist: MikhailDistortion | None = None,
    *,
    dt: float = 1.0,
    process_noise_lin_veloc_std: float = 0.15,
    process_noise_ang_veloc_std: float = 0.01,
    measurm_noise_std_pix: float = 1.0,
    sal_pnt_init_inv_dist: float = 0.1,
    sal_pnt_init_inv_dist_std: float = 1.0,
    sal_pnt_negative_inv_rho_substitute: float = 1e-4,
    max_undetected_frames: int = 0,   # 0 = never delete for being unobserved
    covar_diag_inflation: float = 0.0,
    covar2d_to_ellipse_confidence: float = 0.95,
    sal_pnt_repres: int = REPRES_SPHERICAL,
    ransac_corner_max_divergence_pix: float | None = None,
    ransac_high_innov_chi_square_thresh: float = 9.21034,
    dtype=None,
) -> MonoSlamParams:
    assert sal_pnt_repres in (REPRES_XYZ, REPRES_SPHERICAL), sal_pnt_repres
    dtype = dtype or jnp.result_type(float)
    q = jnp.concatenate([
        jnp.full((3,), process_noise_lin_veloc_std**2, dtype=dtype),
        jnp.full((3,), process_noise_ang_veloc_std**2, dtype=dtype),
    ])
    enable = dist is not None
    if dist is None:
        dist = MikhailDistortion(jnp.zeros((), dtype), jnp.zeros((), dtype))
    return MonoSlamParams(
        cam=cam,
        dist=dist,
        enable_distortion=enable,
        dt=jnp.asarray(dt, dtype),
        process_noise_cov=jnp.diag(q),
        measurm_noise_var=jnp.asarray(measurm_noise_std_pix**2, dtype),
        sal_pnt_init_inv_dist=jnp.asarray(sal_pnt_init_inv_dist, dtype),
        sal_pnt_init_inv_dist_std=jnp.asarray(sal_pnt_init_inv_dist_std, dtype),
        sal_pnt_negative_inv_rho_substitute=jnp.asarray(
            sal_pnt_negative_inv_rho_substitute, dtype),
        max_undetected_frames=jnp.asarray(max_undetected_frames, jnp.int32),
        covar2d_to_ellipse_confidence=jnp.asarray(covar2d_to_ellipse_confidence, dtype),
        sal_pnt_repres=sal_pnt_repres,
        ransac_corner_max_divergence_pix=(
            None if ransac_corner_max_divergence_pix is None
            else jnp.asarray(ransac_corner_max_divergence_pix, dtype)),
        ransac_high_innov_chi_square_thresh=jnp.asarray(
            ransac_high_innov_chi_square_thresh, dtype),
        # None when off: the fused steps skip the diagonal scatter entirely
        covar_diag_inflation=(None if covar_diag_inflation == 0.0
                              else jnp.asarray(covar_diag_inflation, dtype)),
    )


def init_state(
    capacity: int,
    *,
    cam_pos=(0.0, 0.0, 0.0),
    cam_quat=(1.0, 0.0, 0.0, 0.0),
    cam_vel=(0.0, 0.0, 0.0),
    cam_ang_vel=(0.0, 0.0, 0.0),
    cam_pos_std=0.0,
    cam_orient_q_comp_std=0.0,
    cam_vel_std=0.0,
    cam_ang_vel_std=0.0,
    dtype=None,
) -> MonoSlamState:
    """Initial state: camera at the tracker origin with the configured
    diagonal uncertainty (reference SetCameraStateCovar,
    davison-mono-slam.cpp:346-375 — zeros by default so the first camera
    anchors the gauge)."""
    dtype = dtype or jnp.result_type(float)
    D = CAM_STATE_COMPS + SAL_PNT_COMPS * capacity
    x = jnp.zeros((D,), dtype)
    x = x.at[0:3].set(jnp.asarray(cam_pos, dtype))
    x = x.at[3:7].set(jnp.asarray(cam_quat, dtype))
    x = x.at[7:10].set(jnp.asarray(cam_vel, dtype))
    x = x.at[10:13].set(jnp.asarray(cam_ang_vel, dtype))

    diag = jnp.zeros((D,), dtype)
    diag = diag.at[0:3].set(cam_pos_std**2)
    diag = diag.at[3:7].set(cam_orient_q_comp_std**2)
    diag = diag.at[7:10].set(cam_vel_std**2)
    diag = diag.at[10:13].set(cam_ang_vel_std**2)
    P = jnp.diag(diag)

    return MonoSlamState(
        x=x,
        P=P,
        lm_active=jnp.zeros((capacity,), bool),
        lm_unobserved=jnp.zeros((capacity,), jnp.int32),
        lm_generation=jnp.zeros((capacity,), jnp.int32),
        frame_ind=jnp.zeros((), jnp.int32),
    )

"""Landmark-sharded FULLY-ON-DEVICE imageseq closed loop: the flagship
perception pipeline (render -> ellipse-gated NCC template search -> fused
EKF update/health/predict) distributed over a device mesh — the multi-chip
twin of world/device_runner.make_imageseq_scan_runner (VERDICT r3 item 5).

Sharding (axis "lm", L = K / n_dev slots per device):

  render      each device splats ITS landmarks ([H,L]@[L,W] partial matmul),
              one psum("lm") assembles the frame — the render's matmul
              distributes with the landmarks
  ellipse     per-slot 2x2 innovation S_k = (H P H^T)_kk + R is LOCAL:
              A_k = H_k P needs only the replicated camera stripe + own
              covariance rows, and (H P H^T)_kk = A_k H_k^T touches only
              slot k's columns — no collective
  NCC search  embarrassingly parallel over slots: local predicted centers,
              local templates, replicated frame
  delete      local unobserved counters; the drop mask folds into the keep
              congruence via one tiny all_gather
  EKF         the sharded fused congruence (parallel/sharded_ekf
              _local_fused_kernel) REUSING the unmasked A rows computed for
              the ellipse — identical collective budget as the plain
              sharded fused step: one all_gather of the gain precursor

The whole multi-frame run is ONE shard_map around a lax.scan, so nothing
crosses the host between frames. Exact-parity with the single-device runner
(f64, 8 virtual CPU devices) is pinned by tests/test_parallel_imageseq.py;
the driver's dryrun_multichip executes it on the virtual mesh every round.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map

from surikatoko_tpu.geom import camera as cam_mod
from surikatoko_tpu.models.monoslam import measure
from surikatoko_tpu.models.monoslam.state import CAM_STATE_COMPS, MonoSlamParams
from surikatoko_tpu.parallel.sharded_ekf import _local_fused_kernel

_N = CAM_STATE_COMPS


def _render_local(params: MonoSlamParams, background, splat_amp, splat_sigma,
                  R, t, pts_loc):
    """Local partial render: this device's splats only (device_runner.
    render_frame's separable-splat contraction over the local slots).
    Returns the [H,W] partial sum to psum over "lm"."""
    H, W = background.shape
    dtype = background.dtype
    xc = pts_loc @ R.T + t
    dist = params.dist if params.enable_distortion else None
    pix = cam_mod.project_camera_point(params.cam, dist, xc)       # [L,2]
    vis = (xc[:, 2] > 1e-6) & jnp.all(jnp.isfinite(pix), axis=-1)
    pix = jnp.where(jnp.isfinite(pix), pix, -1e6)
    inv2s2 = 1.0 / (2.0 * splat_sigma * splat_sigma)
    xs = jnp.arange(W, dtype=dtype)
    ys = jnp.arange(H, dtype=dtype)
    ex = jnp.exp(-(xs[None, :] - pix[:, 0:1]) ** 2 * inv2s2)       # [L,W]
    ey = jnp.exp(-(ys[None, :] - pix[:, 1:2]) ** 2 * inv2s2)       # [L,H]
    a = splat_amp * vis.astype(dtype)
    return (ey * a[:, None]).T @ ex                                # [H,W]


def make_sharded_imageseq_runner(params: MonoSlamParams, capacity: int,
                                 mesh: Mesh, *, templ_width: int = 15,
                                 search_radius: int = 7,
                                 min_corr_coeff: float = 0.6,
                                 chi2_gate: float = 5.99146,
                                 subpixel: bool = False,
                                 recruit: bool = False,
                                 recruit_max: int = 8,
                                 detector_corners: int = 24,
                                 detector_quality: float = 0.05,
                                 detector_nms_radius: int = 5,
                                 recruit_min_dist: float = 14.0,
                                 target_active: int | None = None,
                                 recruit_depth: str = "prior"):
    """Returns a jitted (x, P, templates [K,T,T], lm_active [K],
    lm_unobserved [K], sc: ImageSeqDeviceScenario, frames [T]) ->
    (x, P, lm_active, lm_unobserved, (err [T], n_matched [T], cam_pos [T,3]))
    running the full imageseq closed loop landmark-sharded over ``mesh``'s
    "lm" axis. Scenario gt_points may hold MORE splats than the filter has
    slots (the churn worlds do: e.g. 1024 points at K=768); the only hard
    requirement is n_points % n_devices == 0 for the P("lm") shard of the
    distributed render.

    ``recruit=True`` closes the landmark LIFECYCLE multi-chip — the sharded
    twin of device_runner.make_imageseq_scan_runner(recruit=True) (reference
    hot path RecruitNewSalientPoints, davison-mono-slam.cpp:923/:1812/:2597).
    The recruit composition is genuinely distributed: the detector runs on
    the psum-assembled frame (replicated — it is one image), candidate
    suppression compares against ALL shards' tracked positions (one tiny
    all_gather of predicted centers), slot assignment gathers the per-shard
    free masks so every device agrees on the first-free order, and the
    recruited covariance rows splice into the sharded fused congruence
    (sharded_ekf._local_fused_kernel's recruit path) with the owner device
    writing rows and every device writing its own columns. The signature
    changes: pass lm_generation too, and get (x, P, templates, lm_active,
    lm_unobserved, lm_generation, (err, n_matched, cam_pos, n_recruited,
    n_active)) back — templates now evolve on device."""
    from surikatoko_tpu.models.monoslam.fused_step import (
        local_tracked_inv_depth, median_tracked_inv_depth)
    from surikatoko_tpu.ops.ncc import ncc_search
    from surikatoko_tpu.vision import features
    from surikatoko_tpu.world.device_runner import _gather_templates

    if recruit_depth not in ("prior", "median", "local"):
        raise ValueError(f"unknown recruit_depth {recruit_depth!r}")
    n_dev = mesh.devices.size
    assert capacity % n_dev == 0, (capacity, n_dev)
    L = capacity // n_dev

    def kernel(gt_R, gt_t, background, splat_amp, splat_sigma, pts_loc,
               x, P_cam, P_lm, templates_loc, active_loc, unobs_loc, gen_loc,
               frames):
        dtype = x.dtype
        dev = jax.lax.axis_index("lm")
        col0 = jnp.asarray(_N, jnp.int32) + dev.astype(jnp.int32) * (L * 6)
        r_var = params.measurm_noise_var.astype(dtype)

        def frame_body(carry, f):
            x, P_cam, P_lm, templates_loc, active_loc, unobs_loc, gen_loc \
                = carry

            # ---- distributed render: one psum assembles the frame ----
            part = _render_local(params, background, splat_amp, splat_sigma,
                                 gt_R[f], gt_t[f], pts_loc)
            img = jnp.clip(background + jax.lax.psum(part, "lm"),
                           0.0, 255.0)

            # ---- local perception products (h, Jacobians, A rows) ----
            lms_loc = jax.lax.dynamic_slice(
                x, (col0,), (L * 6,)).reshape(L, 6)
            h_loc, Hcam_un, Hlm_un = measure.batched_jacobians(
                params, x[:_N], lms_loc)
            row_ok = (jnp.all(jnp.isfinite(h_loc), axis=-1)
                      & jnp.all(jnp.isfinite(Hcam_un.reshape(L, -1)), axis=-1)
                      & jnp.all(jnp.isfinite(Hlm_un.reshape(L, -1)), axis=-1))
            h_loc = jnp.where(row_ok[:, None], h_loc, 0.0)
            Hcam_un = jnp.where(row_ok[:, None, None], Hcam_un, 0.0)
            Hlm_un = jnp.where(row_ok[:, None, None], Hlm_un, 0.0)
            A_un = (jnp.einsum("kij,jd->kid", Hcam_un, P_cam)
                    + jnp.einsum("kij,kjd->kid", Hlm_un, P_lm))  # [L,2,D]

            # ---- per-slot 2x2 innovation (search ellipse): LOCAL —
            # (H P H^T)_kk touches the camera stripe + slot k's own cols ----
            z = jnp.zeros((), jnp.int32)
            A_own = jax.lax.dynamic_slice(
                A_un, (z, z, col0), (L, 2, L * 6)).reshape(L, 2, L, 6)
            S2 = (jnp.einsum("kid,kjd->kij", A_un[:, :, :_N], Hcam_un)
                  + jnp.einsum("kikj,klj->kil", A_own, Hlm_un)
                  + r_var * jnp.eye(2, dtype=dtype))
            det = S2[:, 0, 0] * S2[:, 1, 1] - S2[:, 0, 1] * S2[:, 1, 0]
            det = jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
            sigma_inv = (jnp.stack([
                jnp.stack([S2[:, 1, 1], -S2[:, 0, 1]], -1),
                jnp.stack([-S2[:, 1, 0], S2[:, 0, 0]], -1)], -2)
                / det[:, None, None])

            # ---- NCC template search over LOCAL slots ----
            res = ncc_search(
                img, h_loc, templates_loc, active_loc,
                search_radius=search_radius,
                min_corr_coeff=min_corr_coeff,
                sigma_inv=sigma_inv, chi2_gate=chi2_gate,
                subpixel=subpixel)
            obs_loc = res.best_center
            mask_loc = res.matched & active_loc & row_ok

            # ---- delete-unobserved policy (local counters) ----
            unobs_loc = jnp.where(mask_loc, 0, unobs_loc + 1)
            drop_loc = ((params.max_undetected_frames > 0)
                        & (unobs_loc > params.max_undetected_frames)
                        & active_loc)
            active_loc = active_loc & ~drop_loc

            if recruit:
                # ---- distributed recruitment: detector on the assembled
                # frame (replicated), suppression vs ALL shards' tracked
                # positions, globally-consistent slot assignment ----
                cand_xy, cand_ok = features.detect_corners(
                    img, max_corners=detector_corners,
                    nms_radius=detector_nms_radius, border=templ_width,
                    quality_level=detector_quality)
                cur_pos_loc = jnp.where(res.matched[:, None], obs_loc, h_loc)
                cur_pos_all = jax.lax.all_gather(
                    cur_pos_loc, "lm", tiled=True)               # [K,2]
                active_all = jax.lax.all_gather(
                    active_loc, "lm", tiled=True)                # [K]
                cand_ok = features.filter_out_closest(
                    cand_xy, cand_ok, cur_pos_all, active_all,
                    recruit_min_dist)
                sel = jnp.argsort(
                    jnp.logical_not(cand_ok).astype(jnp.int32),
                    stable=True)[:recruit_max]
                new_pix = cand_xy[sel].astype(dtype)
                new_valid = cand_ok[sel]
                if target_active is not None:
                    n_act = jnp.sum(active_all.astype(jnp.int32))
                    budget = jnp.clip(target_active - n_act, 0, recruit_max)
                    new_valid = jnp.logical_and(
                        new_valid, jnp.arange(recruit_max) < budget)
                # scene-adaptive depth priors: x is replicated and
                # active_all / cur_pos_all already gathered, so both the
                # global median and the per-candidate LOCAL neighbourhood
                # median are computed identically on every device (bitwise
                # parity with the single-device runner)
                if recruit_depth == "median":
                    rho0 = median_tracked_inv_depth(params, x, active_all,
                                                    capacity)
                elif recruit_depth == "local":
                    rho0 = local_tracked_inv_depth(params, x, active_all,
                                                   capacity, new_pix,
                                                   cur_pos_all)
                else:
                    rho0 = None
                (x_next, P_cam_new, P_lm_new, resid_loc, x1,
                 slots) = _local_fused_kernel(
                    params, capacity, x, P_cam, P_lm, lms_loc, obs_loc,
                    mask_loc, precomputed=(h_loc, Hcam_un, Hlm_un, A_un),
                    deactivate_loc=drop_loc,
                    recruit=(new_pix, new_valid,
                             jnp.logical_not(active_loc), rho0))
                # local bookkeeping for slots this device owns
                slot0 = dev.astype(jnp.int32) * L
                owned = (slots >= 0) & (slots >= slot0) & (slots < slot0 + L)
                slot_loc = jnp.where(owned, slots - slot0, L)
                active_loc = active_loc.at[slot_loc].set(True, mode="drop")
                unobs_loc = unobs_loc.at[slot_loc].set(0, mode="drop")
                gen_loc = gen_loc.at[slot_loc].add(1, mode="drop")
                tmpl_new = _gather_templates(img, new_pix, templ_width)
                templates_loc = templates_loc.at[slot_loc].set(
                    tmpl_new.astype(templates_loc.dtype), mode="drop")
                n = jax.lax.psum(jnp.sum(mask_loc.astype(jnp.int32)), "lm")
                err = (jax.lax.psum(
                    jnp.sum(jnp.linalg.norm(resid_loc, axis=-1)), "lm")
                    / jnp.maximum(n, 1))
                n_rec = jnp.sum((slots >= 0).astype(jnp.int32))
                n_active = jax.lax.psum(
                    jnp.sum(active_loc.astype(jnp.int32)), "lm")
                carry = (x_next, P_cam_new, P_lm_new, templates_loc,
                         active_loc, unobs_loc, gen_loc)
                return carry, (err, n, x1[:3], n_rec, n_active)

            # ---- sharded fused update + health + predict, REUSING the
            # perception A rows (one all_gather of the gain precursor) ----
            x_next, P_cam_new, P_lm_new, resid_loc, x1 = _local_fused_kernel(
                params, capacity, x, P_cam, P_lm, lms_loc, obs_loc, mask_loc,
                precomputed=(h_loc, Hcam_un, Hlm_un, A_un),
                deactivate_loc=drop_loc)

            n = jax.lax.psum(jnp.sum(mask_loc.astype(jnp.int32)), "lm")
            err = (jax.lax.psum(
                jnp.sum(jnp.linalg.norm(resid_loc, axis=-1)), "lm")
                / jnp.maximum(n, 1))
            carry = (x_next, P_cam_new, P_lm_new, templates_loc,
                     active_loc, unobs_loc, gen_loc)
            return carry, (err, n, x1[:3])

        carry0 = (x, P_cam, P_lm, templates_loc, active_loc, unobs_loc,
                  gen_loc)
        (x, P_cam, P_lm, templates_loc, active_loc, unobs_loc,
         gen_loc), outs = jax.lax.scan(frame_body, carry0, frames)
        return (x, P_cam, P_lm, templates_loc, active_loc, unobs_loc,
                gen_loc, outs)

    out_scalar = (P(), P(), P(), P(), P()) if recruit else (P(), P(), P())
    smapped = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P("lm"),
                  P(), P(), P("lm"), P("lm"), P("lm"), P("lm"), P("lm"),
                  P()),
        out_specs=(P(), P(), P("lm"), P("lm"), P("lm"), P("lm"), P("lm"),
                   out_scalar),
        check_rep=False,
    )

    if recruit:
        @jax.jit
        def run_recruit(x, Pmat, templates, lm_active, lm_unobserved,
                        lm_generation, sc, frames):
            D = x.shape[0]
            P_cam = Pmat[:_N, :]
            P_lm = Pmat[_N:, :].reshape(capacity, 6, D)
            (x, P_cam, P_lm, templates, active, unobs, gen,
             outs) = smapped(
                sc.gt_cfw_R, sc.gt_cfw_t, sc.background, sc.splat_amp,
                sc.splat_sigma, sc.gt_points,
                x, P_cam, P_lm, templates, lm_active, lm_unobserved,
                lm_generation, frames)
            P_new = jnp.concatenate([P_cam, P_lm.reshape(-1, D)], axis=0)
            return x, P_new, templates, active, unobs, gen, outs

        return run_recruit

    @jax.jit
    def run(x, Pmat, templates, lm_active, lm_unobserved, sc, frames):
        D = x.shape[0]
        P_cam = Pmat[:_N, :]
        P_lm = Pmat[_N:, :].reshape(capacity, 6, D)
        gen0 = jnp.zeros((capacity,), jnp.int32)
        x, P_cam, P_lm, _tm, active, unobs, _gen, outs = smapped(
            sc.gt_cfw_R, sc.gt_cfw_t, sc.background, sc.splat_amp,
            sc.splat_sigma, sc.gt_points,
            x, P_cam, P_lm, templates, lm_active, lm_unobserved, gen0,
            frames)
        P_new = jnp.concatenate([P_cam, P_lm.reshape(-1, D)], axis=0)
        return x, P_new, active, unobs, outs

    return run

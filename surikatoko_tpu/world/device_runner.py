"""Fully on-device closed-loop scenario execution.

The host-driven runner (runner.py) matches the reference's architecture
(perception plug-in between frames); this module compiles the *entire*
closed loop — GT projection matcher, masked EKF update, health checks,
prediction — into one lax.scan program for throughput benchmarking and batch
evaluation sweeps (vmap over scenarios). The matcher here is the
DemoCornersMatcher's math on device: project GT points through GT poses,
gate by image bounds, add measurement noise from a folded-in PRNG.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from surikatoko_tpu.geom import camera as cam_mod
from surikatoko_tpu.models.monoslam import fused_step as fused_mod
from surikatoko_tpu.models.monoslam import landmarks as lm_mod
from surikatoko_tpu.models.monoslam import predict as predict_mod
from surikatoko_tpu.models.monoslam import update as update_mod
from surikatoko_tpu.models.monoslam import health as health_mod
from surikatoko_tpu.models.monoslam.state import CAM_STATE_COMPS, MonoSlamParams, MonoSlamState


class DeviceScenario(NamedTuple):
    gt_cfw_R: jnp.ndarray    # [F,3,3] GT camera-from-tracker
    gt_cfw_t: jnp.ndarray    # [F,3]
    gt_points: jnp.ndarray   # [N,3] tracker-frame world points (N == capacity)
    image_size: jnp.ndarray  # [2]
    noise_std: jnp.ndarray   # detection noise


def _project_gt(params: MonoSlamParams, sc: DeviceScenario, f: jnp.ndarray,
                key: jax.Array | None, noise: jnp.ndarray | None = None
                ) -> tuple[jnp.ndarray, jnp.ndarray]:
    R = sc.gt_cfw_R[f]
    t = sc.gt_cfw_t[f]
    xc = sc.gt_points @ R.T + t
    dist = params.dist if params.enable_distortion else None
    pix = cam_mod.project_camera_point(params.cam, dist, xc)
    if noise is None:
        noise = sc.noise_std * jax.random.normal(key, pix.shape, pix.dtype)
    pix = pix + noise
    w, h = sc.image_size[0], sc.image_size[1]
    vis = ((xc[:, 2] > 1e-6) & (pix[:, 0] >= 0) & (pix[:, 0] < w)
           & (pix[:, 1] >= 0) & (pix[:, 1] < h)
           & jnp.all(jnp.isfinite(pix), axis=-1))
    return pix, vis


def init_with_gt_landmarks(params: MonoSlamParams, sc: DeviceScenario,
                           state: MonoSlamState, key: jax.Array) -> MonoSlamState:
    """Bootstrap: add every visible GT point as a landmark at frame 0 with GT
    inverse depth (slot k <-> point k)."""
    pix, vis = _project_gt(params, sc, jnp.asarray(0), key)
    xc0 = sc.gt_points @ sc.gt_cfw_R[0].T + sc.gt_cfw_t[0]
    rho = 1.0 / jnp.maximum(jnp.linalg.norm(xc0, axis=-1), 1e-9)
    state, _ = lm_mod.add_landmarks(params, state, pix, vis, rho)
    return predict_mod.predict(params, state)


def make_scan_runner(params: MonoSlamParams, update_impl: int = 1):
    """Returns jitted (state, scenario, frame_indices [T], key) ->
    (state, per-frame residual norms [T], per-frame matched counts [T],
    per-frame camera positions [T,3]): T tracked frames as one scan."""

    def frame_body(sc: DeviceScenario, carry, f_and_noise):
        state, = carry
        f, noise = f_and_noise
        obs, vis = _project_gt(params, sc, f, None, noise)
        obs_mask = jnp.logical_and(vis, state.lm_active)
        if update_impl == 1:
            # update + nonneg clamp + rho substitution + renorm + predict as
            # one covariance congruence (fused_step.py): ~2 HBM passes over P
            x_next, P_next, resid, x_upd = (
                fused_mod.fused_update_health_predict(
                    params, state.x, state.P, obs, obs_mask))
            state = state._replace(x=x_next, P=P_next)
        else:
            # impls 2-4 (reference davison-mono-slam.cpp:900-915): sequential
            # per-observation / per-component EKF and 1-point RANSAC
            if update_impl == 2:
                x, P, resid = update_mod.one_obs_update(
                    params, state.x, state.P, obs, obs_mask)
            elif update_impl == 3:
                x, P, resid = update_mod.one_component_update(
                    params, state.x, state.P, obs, obs_mask)
            else:
                x, P, resid, _, _ = update_mod.one_point_ransac_update(
                    params, state.x, state.P, obs, obs_mask)
            P = health_mod.ensure_nonneg_variance(P)
            if params.sal_pnt_repres != 1:  # rho substitution: spherical-only
                x, _ = health_mod.substitute_negative_inv_rho(
                    x, params.sal_pnt_negative_inv_rho_substitute,
                    state.capacity)
            x_upd = x
            state = state._replace(x=x, P=P)
            # quat renorm + predict fused into one camera-stripe pass over P
            state = predict_mod.normalize_and_predict(params, state)
        n = jnp.sum(obs_mask.astype(jnp.int32))
        err = jnp.sum(jnp.linalg.norm(resid, axis=-1)) / jnp.maximum(n, 1)
        cam_pos = x_upd[:3]
        return (state,), (err, n, cam_pos)

    @jax.jit
    def run(state: MonoSlamState, sc: DeviceScenario,
            frames: jnp.ndarray, key: jax.Array):
        # one batched threefry for the whole chunk instead of a split+normal
        # chain inside every scan iteration (the PRNG was the single largest
        # fusion in the compiled frame body)
        K = sc.gt_points.shape[0]
        noise = sc.noise_std * jax.random.normal(
            key, (frames.shape[0], K, 2), sc.gt_points.dtype)
        (state,), (errs, nmatch, cam_pos) = jax.lax.scan(
            functools.partial(frame_body, sc), (state,), (frames, noise))
        return state, errs, nmatch, cam_pos

    return run


class ImageSeqDeviceScenario(NamedTuple):
    """On-device image-sequence scenario: frames are RENDERED on device."""
    gt_cfw_R: jnp.ndarray    # [F,3,3]
    gt_cfw_t: jnp.ndarray    # [F,3]
    gt_points: jnp.ndarray   # [N,3] tracker-frame (N == capacity)
    background: jnp.ndarray  # [H,W] static texture
    splat_amp: jnp.ndarray   # blob peak intensity
    splat_sigma: jnp.ndarray  # blob gaussian sigma (pixels)


def render_frame(params: MonoSlamParams, sc: ImageSeqDeviceScenario,
                 f: jnp.ndarray) -> jnp.ndarray:
    """Render one [H,W] frame on device: static background + a gaussian blob
    at every visible GT point's projection.

    The 2-D gaussian splat is separable, so the sum over landmarks is ONE
    outer-product contraction Ey^T diag(a) Ex — an [H,K]@[K,W] matmul —
    instead of K full-image exp evaluations (the naive [K,H,W] path moves
    ~30 MB through HBM; this moves ~0.3 MB and ~54k exps)."""
    H, W = sc.background.shape
    dtype = sc.background.dtype
    R = sc.gt_cfw_R[f]
    t = sc.gt_cfw_t[f]
    xc = sc.gt_points @ R.T + t
    dist = params.dist if params.enable_distortion else None
    pix = cam_mod.project_camera_point(params.cam, dist, xc)       # [K,2]
    vis = (xc[:, 2] > 1e-6) & jnp.all(jnp.isfinite(pix), axis=-1)
    pix = jnp.where(jnp.isfinite(pix), pix, -1e6)
    inv2s2 = 1.0 / (2.0 * sc.splat_sigma * sc.splat_sigma)
    xs = jnp.arange(W, dtype=dtype)
    ys = jnp.arange(H, dtype=dtype)
    ex = jnp.exp(-(xs[None, :] - pix[:, 0:1]) ** 2 * inv2s2)       # [K,W]
    ey = jnp.exp(-(ys[None, :] - pix[:, 1:2]) ** 2 * inv2s2)       # [K,H]
    a = sc.splat_amp * vis.astype(dtype)
    img = sc.background + (ey * a[:, None]).T @ ex                 # [H,W]
    return jnp.clip(img, 0.0, 255.0)


def _gather_templates(image: jnp.ndarray, centers: jnp.ndarray, T: int
                      ) -> jnp.ndarray:
    """[K,T,T] patches centered at (rounded, clamped) pixel centers."""
    H, W = image.shape
    half = (T - 1) // 2
    ci = jnp.round(centers).astype(jnp.int32) - half

    def one(tl):
        y = jnp.clip(tl[1], 0, H - T)
        x = jnp.clip(tl[0], 0, W - T)
        return jax.lax.dynamic_slice(image, (y, x), (T, T))

    return jax.vmap(one)(ci)


def init_imageseq(params: MonoSlamParams, sc: ImageSeqDeviceScenario,
                  state: MonoSlamState, templ_width: int,
                  max_bootstrap: int | None = None
                  ) -> tuple[MonoSlamState, jnp.ndarray]:
    """Bootstrap from the rendered frame 0: recruit visible GT points
    (GT inverse depth) and capture each one's [T,T] template from the image.

    ``max_bootstrap`` caps how many points are claimed (for churn scenarios
    where the world holds more splats than the filter has slots and the
    recruit loop acquires the rest on its own, with PRIOR depth). Templates
    are scattered by ASSIGNED SLOT, so the mapping stays correct even when
    some points are invisible or unclaimed."""
    img0 = render_frame(params, sc, jnp.asarray(0))
    R = sc.gt_cfw_R[0]
    t = sc.gt_cfw_t[0]
    xc0 = sc.gt_points @ R.T + t
    dist = params.dist if params.enable_distortion else None
    pix = cam_mod.project_camera_point(params.cam, dist, xc0)
    H, W = img0.shape
    vis = ((xc0[:, 2] > 1e-6) & (pix[:, 0] >= 0) & (pix[:, 0] < W)
           & (pix[:, 1] >= 0) & (pix[:, 1] < H))
    if max_bootstrap is not None:
        vis = jnp.logical_and(vis, jnp.cumsum(vis) <= max_bootstrap)
    rho = 1.0 / jnp.maximum(jnp.linalg.norm(xc0, axis=-1), 1e-9)
    state, slots = lm_mod.add_landmarks(params, state, pix, vis, rho)
    patches = _gather_templates(img0, pix, templ_width)
    templates = jnp.zeros((state.capacity, templ_width, templ_width),
                          img0.dtype)
    slot_safe = jnp.where(slots >= 0, slots, state.capacity)
    templates = templates.at[slot_safe].set(patches, mode="drop")
    return predict_mod.predict(params, state), templates


def make_imageseq_scan_runner(params: MonoSlamParams, *, templ_width: int = 15,
                              search_radius: int = 7,
                              min_corr_coeff: float = 0.6,
                              chi2_gate: float = 5.99146,
                              update_impl: int = 1,
                              subpixel: bool = False,
                              recruit: bool = False,
                              recruit_max: int = 8,
                              detector_corners: int = 24,
                              detector_quality: float = 0.05,
                              detector_nms_radius: int = 5,
                              recruit_min_dist: float = 14.0,
                              target_active: int | None = None,
                              recruit_depth: str = "prior"):
    """Fully on-device real-perception closed loop: render -> ellipse-gated
    NCC template search -> EKF update -> predict, one lax.scan
    over frames. The device analog of the reference's imageseq demo
    (ImageTemplCornersMatcher + ProcessFrame), with zero host round-trips.

    ``recruit=True`` closes the landmark LIFECYCLE on device: every frame a
    Shi-Tomasi pass over the rendered image proposes corners, candidates near
    tracked slots are suppressed (reference FilterOutClosest,
    demo-davison-mono-slam.cpp:828), up to ``recruit_max`` claim freed slots
    with PRIOR (non-GT) inverse depth through the fused recruit congruence
    (fused_step.fused_update_health_recruit_predict — ProcessFrame :923 ->
    RecruitNewSalientPoints :1812 -> AddSalientPoint :2597), and their [T,T]
    templates are cut from the live frame. With the delete-unobserved policy
    this runs steady-state add+delete churn, like the reference hot path.
    ``target_active`` throttles recruitment to keep the active count near a
    setpoint (None = refill whenever slots are free). ``recruit_depth``:
    "prior" = the configured flat inverse-depth prior (reference
    GetNewSphericalSalientPointState :2398 semantics); "median" = the
    GLOBAL median tracked inverse depth (fused_step.median_tracked_inv_depth
    — measured WORSE than the flat prior on the wide-sweep world, kept as an
    option); "local" = the per-candidate median inverse depth of the 8
    nearest tracked landmarks in pixel space
    (fused_step.local_tracked_inv_depth — the depth field is spatially
    smooth, so a recruit's depth is best predicted by its neighbours).
    Requires update_impl=1 (the fused path; impls 2-4 recruit host-side via
    MonoSlamFilter.process_frame).

    Returns jitted (state, templates, sc, frames [T]) -> (state, templates,
    per-frame (err, n_matched, cam_pos, n_recruited, n_active)); without
    recruit, templates pass through unchanged."""
    from surikatoko_tpu.models.monoslam import measure
    from surikatoko_tpu.ops.ncc import ncc_search
    from surikatoko_tpu.vision import features

    if recruit and update_impl != 1:
        raise ValueError("on-device recruitment requires update_impl=1")
    if recruit_depth not in ("prior", "median", "local"):
        raise ValueError(f"unknown recruit_depth {recruit_depth!r}")

    def frame_body(sc: ImageSeqDeviceScenario, carry, f):
        state, templates = carry
        with jax.named_scope("render"):
            img = render_frame(params, sc, f)

        # predicted projections + 2x2 innovation covariance (search ellipse,
        # reference GetSalientPointProjected2DPosWithUncertainty :3901).
        # A_un = H P and T_un = H P H^T are computed ONCE here and reused by
        # the fused update below (masking is an exact row/col scaling).
        with jax.named_scope("predict_ellipse"):
            h, Hcam, Hlm = measure.measurement_jacobians(params, state.x)
            Kcap = state.capacity
            # NaN-safety: a diverged landmark's Jacobian row can be
            # non-finite while UNMATCHED — and the precomputed fused update
            # scales rows by the mask, where 0*nan = nan would poison the
            # whole innovation system (the masked-slot NaN rule, see
            # geom/so3.exp). Zero such rows and force them unmatchable.
            row_ok = (jnp.all(jnp.isfinite(h), axis=-1)
                      & jnp.all(jnp.isfinite(Hcam.reshape(Kcap, -1)), axis=-1)
                      & jnp.all(jnp.isfinite(Hlm.reshape(Kcap, -1)), axis=-1))
            h = jnp.where(row_ok[:, None], h, 0.0)
            Hcam = jnp.where(row_ok[:, None, None], Hcam, 0.0)
            Hlm = jnp.where(row_ok[:, None, None], Hlm, 0.0)
            A_un = update_mod.hp_auto(Hcam, Hlm, state.P)    # [2K, D] = H P
            T_un = update_mod.aht_auto(A_un, Hcam, Hlm)      # [2K, 2K] = A H^T
            # per-slot 2x2 innovation: the diagonal 2x2 blocks of T_un + R
            T_blocks = T_un.reshape(Kcap, 2, Kcap, 2)
            S2 = (jnp.einsum("kikj->kij", T_blocks)
                  + params.measurm_noise_var * jnp.eye(2, dtype=state.x.dtype))
            det = (S2[:, 0, 0] * S2[:, 1, 1] - S2[:, 0, 1] * S2[:, 1, 0])
            det = jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
            sigma_inv = (jnp.stack([
                jnp.stack([S2[:, 1, 1], -S2[:, 0, 1]], -1),
                jnp.stack([-S2[:, 1, 0], S2[:, 0, 0]], -1)], -2)
                / det[:, None, None])

        with jax.named_scope("ncc_search"):
            res = ncc_search(
                img, h, templates, state.lm_active,
                search_radius=search_radius, min_corr_coeff=min_corr_coeff,
                sigma_inv=sigma_inv, chi2_gate=chi2_gate, subpixel=subpixel)
        obs = res.best_center
        obs_mask = (res.matched & state.lm_active & row_ok)

        # delete-unobserved policy (reference
        # RemoveLongTermUnobservedSalientPoints :799-840): long-unmatched
        # landmarks' covariance blocks inflate without bound and eventually
        # cost the f32 innovation its positive-definiteness; fold their
        # removal into the fused congruence (free)
        unobs = jnp.where(obs_mask, 0, state.lm_unobserved + 1)
        drop = ((params.max_undetected_frames > 0)
                & (unobs > params.max_undetected_frames)
                & state.lm_active)
        state = state._replace(lm_unobserved=unobs,
                               lm_active=state.lm_active & ~drop)

        if recruit:
            # ---- device-side recruitment (the reference's per-frame
            # RecruitNewSalientPoints): Shi-Tomasi over the rendered frame,
            # spatial suppression vs tracked slots, claim freed capacity with
            # PRIOR inverse depth, cut templates from the live image ----
            active_after = state.lm_active
            with jax.named_scope("detect_corners"):
                cand_xy, cand_ok = features.detect_corners(
                    img, max_corners=detector_corners,
                    nms_radius=detector_nms_radius, border=templ_width,
                    quality_level=detector_quality)
            cur_pos = jnp.where(res.matched[:, None], obs, h)
            cand_ok = features.filter_out_closest(
                cand_xy, cand_ok, cur_pos, active_after, recruit_min_dist)
            sel = jnp.argsort(jnp.logical_not(cand_ok).astype(jnp.int32),
                              stable=True)[:recruit_max]
            new_pix = cand_xy[sel].astype(state.x.dtype)
            new_valid = cand_ok[sel]
            if target_active is not None:
                n_act = jnp.sum(active_after.astype(jnp.int32))
                budget = jnp.clip(target_active - n_act, 0, recruit_max)
                new_valid = jnp.logical_and(
                    new_valid, jnp.arange(recruit_max) < budget)
            if recruit_depth == "median":
                rho0 = fused_mod.median_tracked_inv_depth(
                    params, state.x, active_after, Kcap)
            elif recruit_depth == "local":
                rho0 = fused_mod.local_tracked_inv_depth(
                    params, state.x, active_after, Kcap, new_pix, cur_pos)
            else:
                rho0 = None
            with jax.named_scope("fused_update"):
                x_next, P_next, resid, x_upd, slots = (
                    fused_mod.fused_update_health_recruit_predict(
                        params, state.x, state.P, obs, obs_mask,
                        new_pix, new_valid, jnp.logical_not(active_after),
                        precomputed=(h, A_un, T_un), deactivate_mask=drop,
                        rho0=rho0))
            slot_safe = jnp.where(slots >= 0, slots, Kcap)
            active = active_after.at[slot_safe].set(True, mode="drop")
            unobs2 = state.lm_unobserved.at[slot_safe].set(0, mode="drop")
            gen = state.lm_generation.at[slot_safe].add(1, mode="drop")
            tmpl_new = _gather_templates(img, new_pix, templ_width)
            templates = templates.at[slot_safe].set(
                tmpl_new.astype(templates.dtype), mode="drop")
            state = state._replace(x=x_next, P=P_next, lm_active=active,
                                   lm_unobserved=unobs2, lm_generation=gen)
            n = jnp.sum(obs_mask.astype(jnp.int32))
            err = jnp.sum(jnp.linalg.norm(resid, axis=-1)) / jnp.maximum(n, 1)
            n_rec = jnp.sum((slots >= 0).astype(jnp.int32))
            n_active = jnp.sum(active.astype(jnp.int32))
            return (state, templates), (err, n, x_upd[:3], n_rec, n_active)

        if update_impl == 1:
            with jax.named_scope("fused_update"):
                x_next, P_next, resid, x_upd = (
                    fused_mod.fused_update_health_predict(
                        params, state.x, state.P, obs, obs_mask,
                        precomputed=(h, A_un, T_un), deactivate_mask=drop))
            state = state._replace(x=x_next, P=P_next)
        else:
            # impls 2-4 (reference davison-mono-slam.cpp:900-915)
            if update_impl == 2:
                x, P, resid = update_mod.one_obs_update(
                    params, state.x, state.P, obs, obs_mask)
            elif update_impl == 3:
                x, P, resid = update_mod.one_component_update(
                    params, state.x, state.P, obs, obs_mask)
            else:
                x, P, resid, _, _ = update_mod.one_point_ransac_update(
                    params, state.x, state.P, obs, obs_mask)
            P = health_mod.ensure_nonneg_variance(P)
            if params.sal_pnt_repres != 1:
                x, _ = health_mod.substitute_negative_inv_rho(
                    x, params.sal_pnt_negative_inv_rho_substitute,
                    state.capacity)
            x_upd = x
            state = state._replace(x=x, P=P)
            state = predict_mod.normalize_and_predict(params, state)
        n = jnp.sum(obs_mask.astype(jnp.int32))
        err = jnp.sum(jnp.linalg.norm(resid, axis=-1)) / jnp.maximum(n, 1)
        return (state, templates), (err, n, x_upd[:3])

    @jax.jit
    def run(state: MonoSlamState, templates, sc: ImageSeqDeviceScenario,
            frames: jnp.ndarray):
        (state, templates), out = jax.lax.scan(
            functools.partial(frame_body, sc), (state, templates), frames)
        if recruit:
            return state, templates, out
        return state, out

    return run


def build_imageseq_scenario(capacity: int = 96, dtype=None,
                            image_size=(320, 240), splat_amp: float = 170.0,
                            splat_sigma: float = 1.8, seed: int = 0,
                            n_points: int | None = None,
                            bg_cell: int | None = None,
                            max_deviation: float = 0.6,
                            world: str = "grid"):
    """ImageSeqDeviceScenario over the oscillating scenario03 world.

    ``n_points`` decouples the world's splat count from the filter capacity
    (churn scenarios render MORE points than the filter can track, so the
    recruit loop always has something to acquire). ``bg_cell`` switches the
    background from per-pixel noise to a bilinearly-upsampled low-frequency
    field (cell size in pixels): locally smooth, so the Shi-Tomasi recruiter
    only fires on splats — a static per-pixel-noise texture would offer
    corner-like, trackable-but-bogus features pinned to the image plane."""
    import numpy as np

    dtype = dtype or jnp.float32
    base = build_oscillating_scenario(capacity=n_points or capacity,
                                      dtype=dtype,
                                      max_deviation=max_deviation,
                                      world=world)
    W, H = image_size
    rng = np.random.default_rng(seed)
    if bg_cell is None:
        bg = rng.uniform(20.0, 60.0, size=(H, W)).astype(np.float32)
    else:
        gh, gw = H // bg_cell + 2, W // bg_cell + 2
        g = rng.uniform(20.0, 60.0, (gh, gw))
        ys = np.arange(H) / bg_cell
        xs = np.arange(W) / bg_cell
        y0, x0 = ys.astype(int), xs.astype(int)
        fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
        bg = (g[y0][:, x0] * (1 - fy) * (1 - fx)
              + g[y0][:, x0 + 1] * (1 - fy) * fx
              + g[y0 + 1][:, x0] * fy * (1 - fx)
              + g[y0 + 1][:, x0 + 1] * fy * fx).astype(np.float32)
    return ImageSeqDeviceScenario(
        gt_cfw_R=base.gt_cfw_R, gt_cfw_t=base.gt_cfw_t,
        gt_points=base.gt_points,
        background=jnp.asarray(bg, dtype),
        splat_amp=jnp.asarray(splat_amp, dtype),
        splat_sigma=jnp.asarray(splat_sigma, dtype))


def build_oscillating_scenario(capacity: int = 32, dtype=None,
                               detection_noise_std: float = 0.5,
                               max_deviation: float = 0.6,
                               world: str = "grid",
                               world_halfwidth: float = 2.4,
                               seed: int = 0):
    """Scenario03-style DeviceScenario sized to `capacity` landmarks.
    Shared by bench.py and tests. ``max_deviation`` is the camera's lateral
    oscillation amplitude.

    ``world="grid"`` (default): the reference scenario's grid, replicated +
    jittered up to ``capacity`` — beyond the grid's 64 sites this stacks
    near-coincident duplicates, fine for GT-matcher benchmarks but
    degenerate for perception churn. ``world="wide"``: ``capacity`` DISTINCT
    points scattered over a strip ``world_halfwidth`` wider than the field
    of view, so the lateral sweep genuinely carries points in and out of
    view — the landmark-turnover regime the recruit/delete lifecycle
    benchmarks need."""
    import numpy as np

    from surikatoko_tpu.geom.se3 import SE3
    from surikatoko_tpu.world import scene_gen
    from surikatoko_tpu.world.runner import gt_poses_in_tracker_frame

    dtype = dtype or jnp.float32
    wb = scene_gen.WorldBounds(0.0, 0.9, 0.0, 0.9, 0.0, 0.9001)
    grid_pts = np.asarray(scene_gen.generate_grid_points(
        wb, (0.3, 0.3, 0.3), 0.2))
    center = grid_pts.mean(axis=0)
    if world == "wide":
        rng0 = np.random.default_rng(seed)
        points_world = np.stack([
            rng0.uniform(center[0] - world_halfwidth,
                         center[0] + world_halfwidth, capacity),
            rng0.uniform(0.0, 0.9, capacity),       # depth spread
            rng0.uniform(0.0, 0.9001, capacity),    # vertical (fully in FOV)
        ], axis=1)
    else:
        points_world = grid_pts
    gt_cfw_world = scene_gen.oscillate_right_and_left(
        center + np.array([0, -2.0, 0]), center, (0, 0, 1),
        max_deviation=max_deviation, periods_count=2, shots_per_period=160,
        const_view_dir=True)
    gt_cfw = gt_poses_in_tracker_frame(gt_cfw_world)
    tfw = SE3(gt_cfw_world.R[0], gt_cfw_world.t[0])
    pts = points_world @ np.asarray(tfw.R).T + np.asarray(tfw.t)
    n = len(pts)
    if n < capacity:
        pts = np.concatenate([pts] * (capacity // n + 1))[:capacity]
        pts = pts + np.random.default_rng(0).normal(scale=0.02, size=pts.shape)
    else:
        pts = pts[:capacity]
    return DeviceScenario(
        gt_cfw_R=jnp.asarray(np.asarray(gt_cfw.R), dtype),
        gt_cfw_t=jnp.asarray(np.asarray(gt_cfw.t), dtype),
        gt_points=jnp.asarray(pts, dtype),
        image_size=jnp.asarray([320.0, 240.0], dtype),
        noise_std=jnp.asarray(detection_noise_std, dtype))

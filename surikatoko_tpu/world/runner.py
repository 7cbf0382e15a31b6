"""Closed-loop virtual-scenario driver: the demo main loop
(demo-davison-mono-slam.cpp:1686-1942) as a reusable function shared by tests,
demos, and the benchmark."""

from __future__ import annotations

import inspect
from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from surikatoko_tpu.geom import quat as quat_mod
from surikatoko_tpu.geom.se3 import SE3
from surikatoko_tpu.models.monoslam.filter import MonoSlamFilter
from surikatoko_tpu.models.monoslam.state import MonoSlamState
from surikatoko_tpu.world.demo_matcher import DemoCornersMatcher


class ScenarioResult(NamedTuple):
    state: MonoSlamState
    stats: list
    cam_pos_err: np.ndarray       # [F] |r_est - r_gt|
    cam_pos_gt: np.ndarray        # [F,3]
    cam_pos_est: np.ndarray       # [F,3]


def init_tracker_state_from_gt(tracker: MonoSlamFilter, gt_cfw: SE3,
                               dt: float = 1.0,
                               with_velocity: bool = True,
                               with_ang_velocity: bool | None = None,
                               ) -> MonoSlamState:
    """First camera anchors the tracker frame (identity pose, zero covar);
    optionally seed GT initial linear/angular velocity — the reference's
    independent monoslam_cam_perfect_init_vel / _ang_vel switches feeding
    SetCameraVelocity (demo-davison-mono-slam.cpp:1497-1506)."""
    from surikatoko_tpu.world import scene_gen

    if with_ang_velocity is None:
        with_ang_velocity = with_velocity
    kwargs = {}
    if (with_velocity or with_ang_velocity) and gt_cfw.t.shape[0] >= 2:
        cfw0 = SE3(gt_cfw.R[0], gt_cfw.t[0])
        cfw1 = SE3(gt_cfw.R[1], gt_cfw.t[1])
        v, w = scene_gen.initial_camera_motion(cfw0, cfw1, dt)
        if with_velocity:
            kwargs["cam_vel"] = np.asarray(v)
        if with_ang_velocity:
            kwargs["cam_ang_vel"] = np.asarray(w)
    return tracker.init_state(**kwargs)


def gt_poses_in_tracker_frame(gt_cfw: SE3) -> SE3:
    """Re-express GT camera poses relative to the first camera: the tracker
    origin is camera 0 (reference kTrackerOriginCamInd=0,
    CurCamFromTrackerOrigin demo-davison-mono-slam.cpp:205)."""
    R0, t0 = gt_cfw.R[0], gt_cfw.t[0]
    tracker_from_world = SE3(R0, t0)
    wfT = tracker_from_world.inv()
    # cfw_k ∘ world_from_tracker = camera_k from tracker
    R = jnp.einsum("fij,jk->fik", gt_cfw.R, wfT.R)
    t = jnp.einsum("fij,j->fi", gt_cfw.R, wfT.t) + gt_cfw.t
    return SE3(R, t)


def run_scenario(
    tracker: MonoSlamFilter,
    matcher: DemoCornersMatcher,
    gt_cfw_tracker: SE3,
    n_frames: int | None = None,
    state: MonoSlamState | None = None,
) -> ScenarioResult:
    n_frames = n_frames or gt_cfw_tracker.t.shape[0]
    if state is None:
        state = init_tracker_state_from_gt(tracker, gt_cfw_tracker,
                                           dt=float(tracker.params.dt))
    stats_list = []
    pos_est, pos_gt = [], []
    for f in range(n_frames):
        obs, obs_mask = matcher.match_salient_points(state, f)
        new_pix, new_mask, gt_rho, frag_ids = matcher.recruit_new_salient_points(
            state, f, obs_mask)
        state, stats = tracker.process_frame(
            state, obs, obs_mask, new_pix, new_mask, gt_rho)
        matcher.on_landmarks_added(np.asarray(stats.new_slots), frag_ids, state)
        matcher.sync_removed(state)
        stats_list.append(stats)
        # estimated camera pose for THIS frame is in stats.cam_state
        pos_est.append(np.asarray(stats.cam_state[0:3]))
        # GT camera position in tracker frame = wfc.t of tracker-frame pose
        cfw = SE3(gt_cfw_tracker.R[f], gt_cfw_tracker.t[f])
        pos_gt.append(np.asarray(cfw.inv().t))
    pos_est = np.stack(pos_est)
    pos_gt = np.stack(pos_gt)
    err = np.linalg.norm(pos_est - pos_gt, axis=-1)
    return ScenarioResult(state, stats_list, err, pos_gt, pos_est)


def run_image_sequence(
    tracker: MonoSlamFilter,
    matcher,                      # ImageTemplCornersMatcher-like
    images,                       # iterable of [H,W] grayscale arrays
    state: MonoSlamState | None = None,
) -> tuple[MonoSlamState, list]:
    """Frame loop for the real-image perception path (the reference's
    imageseq scenario): analyze -> match -> recruit -> filter step."""
    if state is None:
        state = tracker.init_state()
    stats_list = []
    for f, img in enumerate(images):
        matcher.analyze_frame(np.asarray(img))
        obs, obs_mask = matcher.match_salient_points(state, f)
        new_pix, new_mask = matcher.recruit_new_salient_points(state, f, obs_mask)
        state, stats = tracker.process_frame(state, obs, obs_mask, new_pix, new_mask)
        matcher.on_landmarks_added(np.asarray(stats.new_slots),
                                   np.asarray(new_pix), state)
        matcher.sync_removed(state)
        stats_list.append(stats)
    return state, stats_list


def run_image_sequence_pipelined(
    tracker: MonoSlamFilter,
    matcher,                      # ImageTemplCornersMatcher-like
    images,                       # iterable of [H,W] grayscale arrays
    state: MonoSlamState | None = None,
) -> tuple[MonoSlamState, list]:
    """``run_image_sequence`` with match/update pipeline overlap.

    Bitwise-identical results to the sequential loop; only the *schedule*
    differs. The reference gets perception/filter overlap from a worker+UI
    thread split (demo-davison-mono-slam-ui.h:164); here it falls out of
    XLA's async dispatch — the trick is ordering the host loop so that all
    blocking fetches of frame f's results happen AFTER frame f+1's
    state-independent perception work is enqueued:

      dispatch EKF step(f)                      [device busy]
      prefetch frame f+1: host decode -> device upload -> Shi-Tomasi pass
                                                [host + queue fill, no block]
      fetch step(f)'s new_slots, cut templates  [first block; device has
                                                 already started f+1's work]

    The overlap hides decode + detection under device compute, and each
    stage's host readbacks are batched into single device_get calls
    (analysis/bench_pipelined.py times both schedules).
    """
    if state is None:
        state = tracker.init_state()
    stats_list = []
    it = iter(images)
    cur = next(it, None)
    if cur is None:
        return state, stats_list
    matcher.prefetch_frame(np.asarray(cur))
    f = 0
    while cur is not None:
        matcher.analyze_frame()                 # consume the prefetch
        obs, obs_mask = matcher.match_salient_points(state, f)
        new_pix, new_mask = matcher.recruit_new_salient_points(state, f, obs_mask)
        state, stats = tracker.process_frame(state, obs, obs_mask,
                                             new_pix, new_mask)
        cur = next(it, None)
        if cur is not None:                     # overlaps the step above
            matcher.prefetch_frame(np.asarray(cur))
        # ONE batched readback for the frame's host bookkeeping (every
        # separate fetch is a blocking host sync); the recruit pixels were
        # built host-side, so reuse the matcher's host copy
        new_slots_np, lm_active_np = jax.device_get(
            (stats.new_slots, state.lm_active))
        new_pix_np = getattr(matcher, "last_new_pix_np", None)
        if new_pix_np is None:
            new_pix_np = np.asarray(new_pix)
        matcher.on_landmarks_added(new_slots_np, new_pix_np, state)
        # duck-typed matchers may predate the prefetched-mask parameter; a
        # blind except TypeError would also swallow TypeErrors raised
        # INSIDE sync_removed, so dispatch on the signature instead
        if "lm_active_np" in inspect.signature(
                matcher.sync_removed).parameters:
            matcher.sync_removed(state, lm_active_np)
        else:
            matcher.sync_removed(state)
        stats_list.append(stats)
        f += 1
    return state, stats_list


def camera_orientation_error_deg(stats_cam_state: np.ndarray, cfw_gt: SE3) -> float:
    """Angle between estimated and GT camera orientation, degrees."""
    q_est = jnp.asarray(stats_cam_state[3:7])
    R_est = quat_mod.to_rotmat(q_est)           # wfc estimated
    R_gt = np.asarray(cfw_gt.R).T               # wfc GT
    dR = np.asarray(R_est) @ R_gt.T
    c = (np.trace(dR) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))

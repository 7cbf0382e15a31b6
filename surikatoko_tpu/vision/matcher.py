"""Real-image perception backend: template tracking + corner recruitment.

Equivalent of reference ``ImageTemplCornersMatcher``
(demo-davison-mono-slam.cpp:428-884): per-landmark NCC template tracking
gated by the predicted projected-uncertainty ellipse, recruitment of new
Shi-Tomasi corners with spatial suppression, template-jump sanity check.

Where the reference scans pixels one at a time per landmark (center-out
spiral + leftover rects), this matcher runs ONE batched ellipse-gated NCC
search for every landmark simultaneously (ops/ncc.py). Host-side state is
only the template patch store (templates live with slots, like the
reference's per-landmark cv::Mat templates).
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from surikatoko_tpu.geom import ellipse as ell_mod
from surikatoko_tpu.ops import ncc as ncc_mod
from surikatoko_tpu.vision import features, templ_match
from surikatoko_tpu.models.monoslam.filter import MonoSlamFilter
from surikatoko_tpu.models.monoslam.state import MonoSlamState


class ImageTemplCornersMatcher:
    def __init__(
        self,
        tracker: MonoSlamFilter,
        *,
        templ_width: int = 17,
        search_radius: int = 12,
        min_corr_coeff: float = 0.65,
        min_templ_corr_for_jump_check: float = 0.0,
        max_new_per_frame: int | None = None,
        min_distance_new_to_tracked: float = 20.0,
        detector_max_corners: int = 50,
        ellipse_confidence: float = 0.95,
        max_center_jump_pix: float | None = None,
        min_search_rect: int = 7,
    ):
        self.tracker = tracker
        self.templ_width = templ_width
        self.min_corr_coeff = min_corr_coeff
        self.max_new = max_new_per_frame or tracker.max_new_per_frame
        self.min_dist_new = min_distance_new_to_tracked
        self.detector_max_corners = detector_max_corners
        self.max_center_jump_pix = max_center_jump_pix
        chi2 = float(ell_mod.chi_square_quantile_2dof(ellipse_confidence))
        self._search = ncc_mod.make_ncc_search(
            search_radius, min_corr_coeff, chi2_gate=chi2,
            min_search_rect=min_search_rect)
        K = tracker.capacity
        self.templates = np.zeros((K, templ_width, templ_width), np.float32)
        self.templ_valid = np.zeros(K, bool)
        self.last_center = np.zeros((K, 2), np.float32)
        self.suppress_observations = False
        self.executed_match_templ_calls = 0   # search-efficiency counter
        # gate telemetry (reference executed_match_templ_calls semantics,
        # demo-davison-mono-slam.cpp:461: NCC evals a gated sequential scan
        # performs; the batched search pays the full window every time):
        # total full-window evals paid / what an ideal gated scan would pay
        # / matched slots whose best cell sat inside the strict ellipse
        self.templ_evals_window = 0
        self.templ_evals_gated = 0
        self.matched_in_ellipse = 0
        self.last_gate_stats: dict = {}
        self._window_cells = (2 * search_radius + 1) ** 2
        self._image = None
        self._image_np = None                 # host copy (template cutting)
        self._prefetched = None               # (image, corners, valid) futures
        self._detected = None                 # detection for current frame
        self.last_new_pix_np = np.zeros((self.max_new, 2))   # host copy of
        # the latest recruit candidates (saves a device round-trip when the
        # caller cuts templates; see run_image_sequence_pipelined)
        self._n_free_cache = (None, 0)        # (id(state), free slots)

    # ---- CornersMatcherBase.AnalyzeFrame ----
    def analyze_frame(self, image_gray: np.ndarray | None = None) -> None:
        """Make ``image_gray`` the current frame; with no argument, consume
        the buffers queued by :meth:`prefetch_frame` (pipelined loop)."""
        # new frame -> the free-slot cache from the previous frame's state
        # must not survive (a recycled object id could alias a NEW state)
        self._n_free_cache = (None, 0)
        if image_gray is None:
            assert self._prefetched is not None, "no prefetched frame"
            self._image, self._image_np, *det = self._prefetched
            self._detected = tuple(det)
            self._prefetched = None
        else:
            self._image_np = np.asarray(image_gray, np.float32)
            self._image = jnp.asarray(self._image_np)
            self._detected = None
            # drop any queued prefetch: a later argument-less analyze_frame
            # must not silently consume a frame older than this one
            self._prefetched = None

    def prefetch_frame(self, image_gray: np.ndarray) -> None:
        """Upload the NEXT frame and dispatch its (state-independent) corner
        detection without touching the current frame's buffers. Called right
        after the filter step for the current frame is enqueued, so the
        host->device transfer and the Shi-Tomasi pass overlap the EKF update
        still executing on device (the match/update pipeline the reference
        could only get from its worker/UI thread split,
        demo-davison-mono-slam-ui.h:164 — here it falls out of XLA's async
        dispatch; see world/runner.run_image_sequence_pipelined)."""
        img_np = np.asarray(image_gray, np.float32)
        img = jnp.asarray(img_np)
        corners, valid = features.detect_corners(
            img, max_corners=self.detector_max_corners,
            border=self.templ_width)
        self._prefetched = (img, img_np, corners, valid)

    # ---- CornersMatcherBase.MatchSalientPoints ----
    def match_salient_points(self, state: MonoSlamState, frame_ind: int
                             ) -> tuple[jnp.ndarray, jnp.ndarray]:
        K = self.tracker.capacity
        if self.suppress_observations or self._image is None:
            # no search ran: stale telemetry must not be attributed to
            # this frame by 'if matcher.last_gate_stats' consumers
            self.last_gate_stats = {}
            return jnp.zeros((K, 2)), jnp.zeros(K, bool)

        centers, cov2 = self.tracker.predicted_pixel_uncertainty(state)
        sigma_inv = jnp.linalg.inv(
            cov2 + 1e-9 * jnp.eye(2, dtype=cov2.dtype))
        active = jnp.asarray(self.templ_valid) & state.lm_active
        res = self._search(
            self._image,
            jnp.asarray(centers, jnp.float32),
            jnp.asarray(self.templates),
            active,
            sigma_inv=jnp.asarray(sigma_inv, jnp.float32),
        )
        # ONE batched readback for everything the host needs this stage:
        # each separate np.asarray fetch is a blocking host sync (same
        # pattern as the BA readbacks)
        matched, best, act_np, n_gated_np, in_ell_np, n_free = (
            jax.device_get((res.matched, res.best_center, active,
                            res.n_gated, res.in_ellipse,
                            jnp.sum(~state.lm_active))))
        self._n_free_cache = (id(state), int(n_free))
        self.executed_match_templ_calls += int(act_np.sum())
        gated = int(n_gated_np[act_np].sum())
        in_ell = int(in_ell_np[matched].sum())
        window = int(act_np.sum()) * self._window_cells
        self.templ_evals_window += window
        self.templ_evals_gated += gated
        self.matched_in_ellipse += in_ell
        self.last_gate_stats = {
            "active": int(act_np.sum()), "window_evals": window,
            "gated_evals": gated, "matched": int(matched.sum()),
            "matched_in_ellipse": in_ell}
        # template-jump sanity check (reference :723-737): a match far from
        # the previous template center is suspicious
        if self.max_center_jump_pix is not None:
            jump = np.linalg.norm(best - self.last_center, axis=1)
            matched &= ~(self.templ_valid & (jump > self.max_center_jump_pix))
        self.last_center[matched] = best[matched]
        return jnp.asarray(np.where(matched[:, None], best, 0.0)), jnp.asarray(matched)

    # ---- CornersMatcherBase.RecruitNewSalientPoints ----
    def recruit_new_salient_points(self, state: MonoSlamState, frame_ind: int,
                                   obs_mask) -> tuple[jnp.ndarray, jnp.ndarray]:
        M = self.max_new
        if self.suppress_observations or self._image is None:
            return jnp.zeros((M, 2)), jnp.zeros(M, bool)
        if self._detected is not None:      # dispatched by prefetch_frame
            corners, valid = self._detected
        else:
            corners, valid = features.detect_corners(
                self._image, max_corners=self.detector_max_corners,
                border=self.templ_width)
        # suppress candidates near currently tracked landmark projections
        proj = self.tracker.predicted_pixels(state)
        valid = features.filter_out_closest(
            corners, valid, jnp.asarray(proj, corners.dtype),
            state.lm_active, self.min_dist_new)
        # budget: free slots and per-frame cap. The free count rides the
        # match stage's batched readback when available (same state);
        # corners+valid fetch together — one round-trip for the stage
        cache_id, free = self._n_free_cache
        if cache_id == id(state):
            corners_np, valid_np = jax.device_get((corners, valid))
        else:
            corners_np, valid_np, n_free = jax.device_get(
                (corners, valid, jnp.sum(~state.lm_active)))
            free = int(n_free)
        budget = min(M, free)
        cand = corners_np[valid_np][:budget]
        new_pix = np.zeros((M, 2))
        new_mask = np.zeros(M, bool)
        new_pix[: len(cand)] = cand
        new_mask[: len(cand)] = True
        self.last_new_pix_np = new_pix
        return jnp.asarray(new_pix), jnp.asarray(new_mask)

    # ---- template store management ----
    def on_landmarks_added(self, slots: np.ndarray, new_pix: np.ndarray,
                           state: MonoSlamState) -> None:
        """Cut and cache the template patch of each newly added landmark
        (reference GetBlobTemplate)."""
        # the frame came FROM the host — cut templates from the host copy
        # instead of fetching the device buffer back
        img = (self._image_np if self._image_np is not None
               else np.asarray(self._image))
        T = self.templ_width
        half = (T - 1) // 2
        H, W = img.shape
        for s, pix in zip(np.asarray(slots), np.asarray(new_pix)):
            if s < 0:
                continue
            x = int(round(float(pix[0])))
            y = int(round(float(pix[1])))
            x = min(max(x, half), W - half - 1)
            y = min(max(y, half), H - half - 1)
            self.templates[s] = img[y - half: y + half + 1,
                                    x - half: x + half + 1]
            self.templ_valid[s] = True
            self.last_center[s] = (x, y)

    def sync_removed(self, state: MonoSlamState,
                     lm_active_np: np.ndarray | None = None) -> None:
        """Drop templates of deactivated slots; pass ``lm_active_np`` when
        the caller already fetched the mask (saves the round-trip)."""
        if lm_active_np is None:
            lm_active_np = np.asarray(state.lm_active)
        self.templ_valid &= lm_active_np


class KltCornersMatcher(ImageTemplCornersMatcher):
    """Optical-flow tracking variant: each landmark's last observed corner is
    tracked previous-frame -> current-frame with pyramidal Lucas-Kanade
    (vision/klt.py) and gated by the predicted projected-uncertainty ellipse
    (Mahalanobis chi-square on the innovation).

    This is the prototype's pipeline (py_proto/suriko/mvg.py:3331 —
    cv2.calcOpticalFlowPyrLK + consistency filters) brought into the same
    CornersMatcherBase seam as the NCC matcher; recruitment/template
    bookkeeping is inherited (templates are kept only as slot-occupancy
    markers and for optional jump checks)."""

    def __init__(self, tracker: MonoSlamFilter, *,
                 klt_levels: int = 3, klt_win: int = 7, klt_iters: int = 10,
                 ellipse_confidence: float = 0.95, **kwargs):
        super().__init__(tracker, ellipse_confidence=ellipse_confidence,
                         **kwargs)
        self.klt_levels = klt_levels
        self.klt_win = klt_win
        self.klt_iters = klt_iters
        self._chi2 = float(ell_mod.chi_square_quantile_2dof(ellipse_confidence))
        self._prev_image = None

    def analyze_frame(self, image_gray: np.ndarray | None = None) -> None:
        self._prev_image = self._image
        super().analyze_frame(image_gray)

    def match_salient_points(self, state: MonoSlamState, frame_ind: int
                             ) -> tuple[jnp.ndarray, jnp.ndarray]:
        from surikatoko_tpu.vision import klt

        K = self.tracker.capacity
        if (self.suppress_observations or self._image is None
                or self._prev_image is None):
            return jnp.zeros((K, 2)), jnp.zeros(K, bool)

        active = jnp.asarray(self.templ_valid) & state.lm_active
        res = klt.track_points(
            self._prev_image, self._image,
            jnp.asarray(self.last_center, jnp.float32), active,
            levels=self.klt_levels, win=self.klt_win, iters=self.klt_iters)

        # innovation gate against the predicted projection uncertainty
        centers, cov2 = self.tracker.predicted_pixel_uncertainty(state)
        sigma_inv = jnp.linalg.inv(cov2 + 1e-9 * jnp.eye(2, dtype=cov2.dtype))
        innov = res.points - centers.astype(res.points.dtype)
        maha = jnp.einsum("ki,kij,kj->k", innov,
                          sigma_inv.astype(res.points.dtype), innov)
        matched, best, n_act, n_free = jax.device_get(
            (res.status & active & (maha < self._chi2), res.points,
             jnp.sum(active), jnp.sum(~state.lm_active)))
        self._n_free_cache = (id(state), int(n_free))
        self.executed_match_templ_calls += int(n_act)
        self.last_center[matched] = best[matched]
        return jnp.asarray(np.where(matched[:, None], best, 0.0)), jnp.asarray(matched)

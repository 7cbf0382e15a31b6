"""Batched ellipse-gated NCC search over all landmarks at once.

The reference's per-frame perception hot loop (SURVEY §3.4): for each tracked
landmark, scan a search window around the predicted projection, evaluating a
TxT ZNCC at every candidate pixel (ImageTemplCornersMatcher::
MatchSalientPointTemplCenterInRect, demo-davison-mono-slam.cpp:465-579 —
center-out ring scans of scalar NCC calls). Here the whole thing is one
batched program: gather [K, P, P] search patches with dynamic slices, three
depthwise convolutions for the ZNCC surface, an ellipse-gate mask, and a
masked argmax — no control flow, every landmark in flight at once.

Contract:
  search(image [H,W] f32, centers [K,2] (x,y) predicted template centers,
         templates [K,T,T], active [K],
         sigma_inv [K,2,2] + chi2  (ellipse gate; None = full window))
  -> (best_center [K,2] f32, best_corr [K], matched [K])
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from surikatoko_tpu.vision import templ_match


class NccSearchResult(NamedTuple):
    best_center: jnp.ndarray   # [K,2] (x,y) of best template center
    best_corr: jnp.ndarray     # [K]
    matched: jnp.ndarray       # [K] bool (gate passed & corr above threshold)
    # search-efficiency telemetry (reference executed_match_templ_calls,
    # demo-davison-mono-slam.cpp:461,:689-698 — it counts the NCC evals its
    # sequential scan performed; the batched path always pays the full
    # window, so n_gated is what an ideally-gated scan WOULD evaluate and
    # n_gated / S^2 the gate hit-rate that decides if search_radius is
    # oversized):
    n_gated: jnp.ndarray       # [K] int32: candidate cells passing the gate
    in_ellipse: jnp.ndarray    # [K] bool: best cell inside the STRICT chi2
                               # ellipse (False = rescued by the
                               # min-search-rect floor)


def _gather_patches(image: jnp.ndarray, top_left: jnp.ndarray, P: int) -> jnp.ndarray:
    """[K,P,P] patches at integer top-left corners (clamped to the image)."""
    H, W = image.shape

    def one(tl):
        y = jnp.clip(tl[1], 0, H - P)
        x = jnp.clip(tl[0], 0, W - P)
        return jax.lax.dynamic_slice(image, (y, x), (P, P))

    return jax.vmap(one)(top_left)


def ncc_search(
    image: jnp.ndarray,
    centers: jnp.ndarray,          # [K,2] float (x,y) predicted centers
    templates: jnp.ndarray,        # [K,T,T]
    active: jnp.ndarray,           # [K] bool
    *,
    search_radius: int,            # static: candidate offsets in [-R, R]^2
    min_corr_coeff: float = 0.5,
    sigma_inv: jnp.ndarray | None = None,   # [K,2,2] pixel-cov inverse
    chi2_gate: float | None = None,
    templ_stats: templ_match.TemplateStats | None = None,
    min_search_rect: int = 7,      # reference monoslam_templ_min_search_rect_
                                   # width/height (clamp, default 7x7)
    subpixel: bool = False,
) -> NccSearchResult:
    """Find each landmark's best template placement near its prediction.

    ``subpixel=True`` refines the integer best cell by fitting 1-D parabolas
    through the ZNCC surface values at its 4-neighbours — taken from the
    surface the search ALREADY computed, so it costs a gather, not four
    more ZNCC evaluations per slot. The half-pixel quantization of an
    integer argmax is a ~0.29 px/axis RMS measurement error the reference
    simply eats (its scan is integer too, demo-davison-mono-slam.cpp:465).
    On the churned K=768 flagship its ATE effect sat within the config's
    +-0.02 code-perturbation noise, so the bench keeps it OFF; it remains
    the right tool where sub-pixel observations matter and the filter
    config is tuned for them. A best cell on the window edge keeps its
    integer center on that axis (surface neighbours only exist inside the
    window)."""
    K, T, _ = templates.shape
    R = search_radius
    S = 2 * R + 1
    P = S + T - 1
    H, W = image.shape
    dtype = image.dtype
    half = (T - 1) // 2

    centers_i = jnp.round(centers).astype(jnp.int32)
    # top-left of the search patch so that offset (R, R) = predicted center
    patch_tl = centers_i - (half + R)
    tl_clamped_x = jnp.clip(patch_tl[:, 0], 0, W - P)
    tl_clamped_y = jnp.clip(patch_tl[:, 1], 0, H - P)
    tl = jnp.stack([tl_clamped_x, tl_clamped_y], axis=1)

    patches = _gather_patches(image, tl, P)

    # candidate template-center pixel for each offset
    oy = jax.lax.broadcasted_iota(jnp.int32, (S, S), 0)
    ox = jax.lax.broadcasted_iota(jnp.int32, (S, S), 1)
    cand_x = tl[:, 0, None, None] + ox[None] + half     # [K,S,S]
    cand_y = tl[:, 1, None, None] + oy[None] + half

    gate = jnp.ones((K, S, S), bool)
    strict = jnp.ones((K, S, S), bool)
    if sigma_inv is not None and chi2_gate is not None:
        dx = cand_x.astype(dtype) - centers[:, 0, None, None]
        dy = cand_y.astype(dtype) - centers[:, 1, None, None]
        md = (sigma_inv[:, None, None, 0, 0] * dx * dx
              + 2.0 * sigma_inv[:, None, None, 0, 1] * dx * dy
              + sigma_inv[:, None, None, 1, 1] * dy * dy)
        strict = md <= chi2_gate
        # always keep the predicted center itself searchable (min search rect,
        # reference clamps the rect to at least min_search_rect^2: :623)
        rr = jnp.maximum(jnp.abs(ox[None] - R), jnp.abs(oy[None] - R))
        gate = jnp.logical_or(strict, rr <= (min_search_rect - 1) // 2)
    # candidates whose template would cross the image border are invalid
    inside = ((cand_x >= half) & (cand_x < W - half)
              & (cand_y >= half) & (cand_y < H - half))
    gate = jnp.logical_and(gate, inside)
    n_gated = jnp.sum(gate.reshape(K, S * S).astype(jnp.int32), axis=1)

    surf = templ_match.corr_coeff_surface(patches, templates, templ_stats)
    surf_g = jnp.where(gate, surf, -jnp.inf)
    flat = surf_g.reshape(K, S * S)
    best = jnp.argmax(flat, axis=1)
    best_corr = jnp.take_along_axis(flat, best[:, None], axis=1)[:, 0]
    if subpixel:
        # RAW (ungated) surface at best's x-1/x+1/y-1/y+1: row-wrap
        # garbage at window edges is masked below
        flat_raw = surf.reshape(K, S * S)
        nb_idx = jnp.clip(best[:, None]
                          + jnp.asarray([-1, 1, -S, S])[None, :],
                          0, S * S - 1)
        c_n = jnp.take_along_axis(flat_raw, nb_idx, axis=1)    # [K,4]
    bx = jnp.take_along_axis(cand_x.reshape(K, S * S), best[:, None], axis=1)[:, 0]
    by = jnp.take_along_axis(cand_y.reshape(K, S * S), best[:, None], axis=1)[:, 0]

    matched = jnp.logical_and(active, best_corr >= min_corr_coeff)
    matched = jnp.logical_and(matched, jnp.isfinite(best_corr))
    best_center = jnp.stack([bx, by], axis=1).astype(dtype)
    in_ellipse = jnp.take_along_axis(
        strict.reshape(K, S * S), best[:, None], axis=1)[:, 0]

    if subpixel:
        # parabola inputs come straight from the ZNCC surface the search
        # already computed. Surface neighbours only exist INSIDE the search
        # window, so a best cell on the window edge keeps its integer center
        # on that axis (it was a gate/window artifact anyway).
        bx_off = (best % S).astype(jnp.int32)
        by_off = (best // S).astype(jnp.int32)
        c0 = best_corr
        # 1-D parabola peak per axis; a true max has negative curvature —
        # clamp to the half-cell and fall back to the integer cell otherwise
        den_x = c_n[:, 0] - 2.0 * c0 + c_n[:, 1]
        den_y = c_n[:, 2] - 2.0 * c0 + c_n[:, 3]
        d_x = jnp.clip(0.5 * (c_n[:, 0] - c_n[:, 1])
                       / jnp.where(den_x < -1e-9, den_x, -1.0), -0.5, 0.5)
        d_y = jnp.clip(0.5 * (c_n[:, 2] - c_n[:, 3])
                       / jnp.where(den_y < -1e-9, den_y, -1.0), -0.5, 0.5)
        ok_x = ((den_x < -1e-9) & (bx_off > 0) & (bx_off < S - 1)
                & (bx - 1 >= half) & (bx + 1 < W - half))
        ok_y = ((den_y < -1e-9) & (by_off > 0) & (by_off < S - 1)
                & (by - 1 >= half) & (by + 1 < H - half))
        best_center = best_center + jnp.stack(
            [jnp.where(ok_x, d_x, 0.0),
             jnp.where(ok_y, d_y, 0.0)], axis=1).astype(dtype)

    return NccSearchResult(best_center=best_center, best_corr=best_corr,
                           matched=matched, n_gated=n_gated,
                           in_ellipse=in_ellipse)


def make_ncc_search(search_radius: int, min_corr_coeff: float = 0.5,
                    chi2_gate: float | None = None,
                    min_search_rect: int = 7, subpixel: bool = False):
    """jit-ready closure over the static parameters."""
    return jax.jit(functools.partial(
        ncc_search, search_radius=search_radius,
        min_corr_coeff=min_corr_coeff, chi2_gate=chi2_gate,
        min_search_rect=min_search_rect,
        subpixel=subpixel))

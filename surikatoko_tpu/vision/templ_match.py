"""Zero-normalized cross-correlation (ZNCC) template matching, batched.

Equivalent of reference templ-match.cpp:7-112 — but instead of per-pixel
scalar loops ("Mat.at is a hot-spot"), the whole search is three depthwise
convolutions over all landmarks at once:

  corr_prod(y,x) = conv(f, t - mean(t))      (the f-mean term cancels since
                                              sum(t - mean(t)) = 0)
  win_sum, win_sum2 = box-filter of f, f^2
  corr = corr_prod / (sqrt(win_sum2 - win_sum^2/N) * templ_sqrt_ssd)

This shape (K-channel depthwise conv over a [K, S+T-1, S+T-1] patch stack)
maps onto batched convolutions; ops/ncc.py wraps it with patch gathering,
ellipse gating and masked argmax.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class TemplateStats(NamedTuple):
    """Per-template cached stats (reference TemplMatchStats,
    davison-mono-slam.h:110)."""

    mean: jnp.ndarray                # [K]
    sqrt_sum_sqr_diff: jnp.ndarray   # [K]


def template_stats(templates: jnp.ndarray) -> TemplateStats:
    """templates [K,T,T] -> (mean [K], sqrt(sum((t-mean)^2)) [K])."""
    mean = jnp.mean(templates, axis=(-2, -1))
    d = templates - mean[:, None, None]
    return TemplateStats(mean=mean,
                         sqrt_sum_sqr_diff=jnp.sqrt(jnp.sum(d * d, axis=(-2, -1))))


def _depthwise_corr(patches: jnp.ndarray, kernels: jnp.ndarray) -> jnp.ndarray:
    """patches [K,P,P] (x) kernels [K,T,T] -> valid correlation [K,S,S]."""
    K = patches.shape[0]
    lhs = patches[None]                      # [1,K,P,P]
    rhs = kernels[:, None]                   # [K,1,T,T]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=K,
        preferred_element_type=patches.dtype,
    )
    return out[0]


def corr_coeff_surface(patches: jnp.ndarray, templates: jnp.ndarray,
                       stats: TemplateStats | None = None,
                       eps: float = 1e-12) -> jnp.ndarray:
    """ZNCC surface [K,S,S] for each landmark's search patch [K,P,P] against
    its template [K,T,T] (S = P - T + 1). Windows with ~zero variance get
    corr 0 (the reference returns 'undefined' there, templ-match.cpp:103)."""
    Kn, P, _ = patches.shape
    T = templates.shape[-1]
    n = T * T
    dtype = patches.dtype
    st = stats or template_stats(templates)

    t_centered = templates - st.mean[:, None, None]
    corr_prod = _depthwise_corr(patches, t_centered)

    ones = jnp.ones((Kn, T, T), dtype)
    win_sum = _depthwise_corr(patches, ones)
    win_sum2 = _depthwise_corr(patches * patches, ones)
    var_term = jnp.maximum(win_sum2 - win_sum * win_sum / n, 0.0)

    denom = jnp.sqrt(var_term) * st.sqrt_sum_sqr_diff[:, None, None]
    ok = denom > eps
    return jnp.where(ok, corr_prod / jnp.where(ok, denom, 1.0), 0.0)


def corr_coeff_single(image_roi: jnp.ndarray, template: jnp.ndarray) -> jnp.ndarray:
    """Scalar ZNCC of one window vs one template (reference CalcCorrCoeff)."""
    surf = corr_coeff_surface(image_roi[None], template[None])
    return surf[0, 0, 0]

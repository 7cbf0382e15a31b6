"""ops.ncc.ncc_search against a brute-force NumPy ZNCC scan.

For every landmark the reference walks the (2R+1)^2 candidate centres of its
search window one at a time, evaluates the zero-mean normalized
cross-correlation of the template with the image window there, and keeps the
best candidate whose template stays inside the image. The batched search must
pick the same cell with the same correlation, and its subpixel refinement
must equal the parabola fit through the four raw surface neighbours of that
cell.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from surikatoko_tpu.ops.ncc import ncc_search


def _zncc(win: np.ndarray, templ: np.ndarray) -> float:
    a = win - win.mean()
    b = templ - templ.mean()
    return float(np.sum(a * b) / np.sqrt(np.sum(a * a) * np.sum(b * b)))


def _brute_force(image, centers, templates, R, subpixel):
    H, W = image.shape
    K, T, _ = templates.shape
    S = 2 * R + 1
    P = S + T - 1
    half = (T - 1) // 2
    best_center = np.zeros((K, 2))
    best_corr = np.zeros(K)
    for k in range(K):
        cx, cy = np.round(centers[k]).astype(int)
        tlx = int(np.clip(cx - half - R, 0, W - P))
        tly = int(np.clip(cy - half - R, 0, H - P))
        surf = np.full((S, S), -np.inf)
        raw = np.zeros((S, S))
        for oy in range(S):
            for ox in range(S):
                y0, x0 = tly + oy, tlx + ox
                raw[oy, ox] = _zncc(image[y0:y0 + T, x0:x0 + T], templates[k])
                ccx, ccy = x0 + half, y0 + half
                if half <= ccx < W - half and half <= ccy < H - half:
                    surf[oy, ox] = raw[oy, ox]
        by, bx = np.unravel_index(np.argmax(surf), surf.shape)
        c0 = surf[by, bx]
        best_corr[k] = c0
        center = np.array([tlx + bx + half, tly + by + half], float)
        if subpixel:
            for axis, off, lim in ((0, bx, W), (1, by, H)):
                if not 0 < off < S - 1:
                    continue
                if axis == 0:
                    lo, hi = raw[by, bx - 1], raw[by, bx + 1]
                else:
                    lo, hi = raw[by - 1, bx], raw[by + 1, bx]
                den = lo - 2.0 * c0 + hi
                c = center[axis]
                if den < -1e-9 and c - 1 >= half and c + 1 < lim - half:
                    center[axis] += np.clip(0.5 * (lo - hi) / den, -0.5, 0.5)
        best_center[k] = center
    return best_center, best_corr


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("K,T,S", [(8, 9, 7), (5, 17, 25), (3, 9, 11)])
def test_ncc_search_matches_brute_force(rng, K, T, S, subpixel):
    H, W = 64, 80
    R = (S - 1) // 2
    # smooth-ish texture so the surfaces have interior peaks to refine
    image = rng.uniform(0, 255, size=(H, W))
    image = 0.5 * image + 0.25 * (np.roll(image, 1, 0) + np.roll(image, 1, 1))
    # templates cut near (not at) the predicted centres, plus noise; some
    # centres sit close to the border so the window clamp is exercised
    centers = rng.uniform((4, 4), (W - 5, H - 5), size=(K, 2))
    half = (T - 1) // 2
    templates = np.zeros((K, T, T))
    for k in range(K):
        x = int(np.clip(round(centers[k, 0]) + rng.integers(-2, 3),
                        half, W - half - 1))
        y = int(np.clip(round(centers[k, 1]) + rng.integers(-2, 3),
                        half, H - half - 1))
        templates[k] = (image[y - half:y + half + 1, x - half:x + half + 1]
                        + rng.normal(scale=5.0, size=(T, T)))

    res = ncc_search(jnp.asarray(image), jnp.asarray(centers),
                     jnp.asarray(templates), jnp.ones((K,), bool),
                     search_radius=R, min_corr_coeff=-1.0,
                     subpixel=subpixel)
    want_center, want_corr = _brute_force(image, centers, templates, R,
                                          subpixel)
    np.testing.assert_allclose(np.asarray(res.best_corr), want_corr,
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.best_center), want_center,
                               rtol=0, atol=1e-9)
    assert bool(np.all(np.asarray(res.matched)))
    assert np.all(np.asarray(res.n_gated) <= S * S)

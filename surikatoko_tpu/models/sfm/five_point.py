"""Minimal 5-point relative pose (essential matrix) solver.

Capability match for the reference prototype's Stewenius solver
(py_proto/suriko/ess_5point_stewenius.py — a pre-generated Grobner
coefficient table). This implementation derives everything at runtime
instead of shipping generated tables:

1. nullspace: E(x,y,z) = x E1 + y E2 + z E3 + E4 from the 5 epipolar
   equations (4-dim right nullspace of the 5x9 system);
2. the 10 cubic constraints (det E = 0 and 2 E E^T E - tr(E E^T) E = 0)
   are expanded into the 20 degree-<=3 monomials **numerically** — each
   polynomial's coefficients are recovered by evaluating it at generic
   sample points and solving a Vandermonde system (exact for cubics,
   no symbolic algebra);
3. Gauss-Jordan reduction of the 10x20 system to [I | A], then the 10x10
   action matrix of multiplication-by-x in the quotient ring; its
   eigenvectors evaluate the basis monomials at each of the <=10 solutions.

The 10x10 nonsymmetric eigendecomposition runs through jax.pure_callback
(numpy) — a general eig is not on every backend; the matrix is tiny so this
costs ~nothing
and the rest of the pipeline stays on device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# monomial exponent table, degree <= 3 in (x, y, z); ordered so the first 10
# (degree-3) columns are eliminated and the last 10 form the quotient basis:
# [x^3 x^2y xy^2 y^3 x^2z xyz y^2z xz^2 yz^2 z^3 | x^2 xy y^2 xz yz z^2 x y z 1]
_EXPS = np.array([
    (3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0), (2, 0, 1), (1, 1, 1),
    (0, 2, 1), (1, 0, 2), (0, 1, 2), (0, 0, 3),
    (2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1), (0, 0, 2),
    (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
])
# basis = columns 10..19: [x^2, xy, y^2, xz, yz, z^2, x, y, z, 1]
# multiplication by x maps basis -> [x^3, x^2y, xy^2, x^2z, xyz, xz^2, x^2, xy, xz, x]
_XB_TO_COL = [0, 1, 2, 4, 5, 7, 10, 11, 13, 16]  # column of x*basis[i] in _EXPS


def _monomials(pts: jnp.ndarray) -> jnp.ndarray:
    """[N,3] sample points -> [N,20] monomial values."""
    x, y, z = pts[:, 0:1], pts[:, 1:2], pts[:, 2:3]
    e = jnp.asarray(_EXPS, pts.dtype)
    return (x ** e[:, 0][None] * y ** e[:, 1][None] * z ** e[:, 2][None])


def _constraints_at(Es: jnp.ndarray) -> jnp.ndarray:
    """Evaluate the 10 cubic constraints at E: returns [10]."""
    EEt = Es @ Es.T
    T = 2.0 * (EEt @ Es) - jnp.trace(EEt) * Es
    return jnp.concatenate([jnp.linalg.det(Es)[None], T.reshape(-1)])


def five_point_essential(x1n: jnp.ndarray, x2n: jnp.ndarray
                         ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Essential-matrix candidates from exactly 5 correspondences in
    normalized (calibrated) coordinates [5,2] each.

    Returns (Es [10,3,3], valid [10]) — up to 10 real solutions; invalid
    slots (complex roots) are flagged False and filled with identity-like
    placeholders. Solutions satisfy x2_h^T E x1_h = 0 exactly.
    """
    dtype = x1n.dtype

    def homog(p):
        return jnp.concatenate([p, jnp.ones_like(p[:, :1])], axis=1)

    X1 = homog(x1n)
    X2 = homog(x2n)
    # epipolar rows: kron(x1, x2)? convention x2^T E x1 = sum E_ij x2_i x1_j
    A = jnp.einsum("ni,nj->nij", X2, X1).reshape(5, 9)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    E1, E2, E3, E4 = (Vt[-1].reshape(3, 3), Vt[-2].reshape(3, 3),
                      Vt[-3].reshape(3, 3), Vt[-4].reshape(3, 3))

    def E_of(p):
        return p[0] * E1 + p[1] * E2 + p[2] * E3 + E4

    # numerically expand the 10 constraint cubics over the 20 monomials
    # (fixed generic sample points: deterministic, well-conditioned)
    rngpts = np.asarray(
        np.random.default_rng(12345).normal(size=(40, 3)), dtype=np.float64)
    pts = jnp.asarray(rngpts, dtype)
    V = _monomials(pts)                                    # [40,20]
    vals = jax.vmap(lambda p: _constraints_at(E_of(p)))(pts)  # [40,10]
    coeffs, *_ = jnp.linalg.lstsq(V, vals)                # [20,10]
    M = coeffs.T                                           # [10,20]

    # Gauss-Jordan: M = [M1 | M2] -> A = M1^-1 M2 (degree-3 monomials in
    # terms of the basis)
    M1 = M[:, :10]
    M2 = M[:, 10:]
    Ared = jnp.linalg.solve(M1, M2)                        # [10,10]

    # action matrix of multiplication by x on the basis
    rows = []
    for i, col in enumerate(_XB_TO_COL):
        if col < 10:
            rows.append(-Ared[col])          # x*basis_i = deg-3 monomial -> -A row
        else:
            e = np.zeros(10)
            e[col - 10] = 1.0
            rows.append(jnp.asarray(e, dtype))
    Ax = jnp.stack(rows)                                    # [10,10]

    # eigenvectors of Ax^T evaluate the basis at the solutions; nonsymmetric
    # eig -> host callback on the tiny 10x10
    def host_eig(a):
        w, v = np.linalg.eig(np.asarray(a, np.complex128))
        return (np.ascontiguousarray(w.real.astype(np.float64)),
                np.ascontiguousarray(w.imag.astype(np.float64)),
                np.ascontiguousarray(v.real.astype(np.float64)),
                np.ascontiguousarray(v.imag.astype(np.float64)))

    shapes = (jax.ShapeDtypeStruct((10,), jnp.float64),
              jax.ShapeDtypeStruct((10,), jnp.float64),
              jax.ShapeDtypeStruct((10, 10), jnp.float64),
              jax.ShapeDtypeStruct((10, 10), jnp.float64))
    wr, wi, vr, vi = jax.pure_callback(
        host_eig, shapes, Ax.astype(jnp.float64), vmap_method="sequential")

    # real eigenvalues -> real solutions; basis vector v = [.., x, y, z, 1]
    vr = vr.T.astype(dtype)       # [10 eigvecs, 10 comps]
    wi = wi.astype(dtype)
    denom = vr[:, 9]
    safe = jnp.where(jnp.abs(denom) < 1e-12, 1.0, denom)
    xyz = vr[:, 6:9] / safe[:, None]
    valid = (jnp.abs(wi) < 1e-6) & (jnp.abs(denom) >= 1e-12)

    Es = jax.vmap(E_of)(xyz)
    norms = jnp.sqrt(jnp.sum(Es * Es, axis=(1, 2)))
    Es = Es / jnp.maximum(norms, 1e-30)[:, None, None]
    return Es, valid


def five_point_best(x1n: jnp.ndarray, x2n: jnp.ndarray,
                    x1_all: jnp.ndarray, x2_all: jnp.ndarray,
                    mask_all: jnp.ndarray) -> jnp.ndarray:
    """Pick the 5-point candidate with the lowest total Sampson error over a
    support set (for RANSAC scoring / disambiguation)."""
    from surikatoko_tpu.models.sfm.mvg import sampson_distance_sq

    Es, valid = five_point_essential(x1n, x2n)
    m = mask_all.astype(x1_all.dtype)

    def score(E):
        return jnp.sum(sampson_distance_sq(E, x1_all, x2_all) * m)

    scores = jax.vmap(score)(Es)
    scores = jnp.where(valid, scores, jnp.inf)
    return Es[jnp.argmin(scores)]

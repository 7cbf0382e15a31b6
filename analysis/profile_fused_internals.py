"""Micro-profile INSIDE fused_update_health_predict at the K=768 regime
(6.4 of the 8.6 ms frame, analysis/profile_imageseq_frame.py): which of the
step's large primitives — innovation Cholesky, the [2K, D+1] triangular
solve, the [D,2K]@[2K,D] Gram downdate, the diagonal-congruence mask pass —
actually owns the time, so optimization effort goes where the milliseconds
are.

    python analysis/profile_fused_internals.py [--capacity 768]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--capacity", type=int, default=768)
    ap.add_argument("--iters", type=int, default=60)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_default_matmul_precision", "highest")
    from jax.scipy.linalg import solve_triangular

    sys.path.insert(0, os.path.dirname(__file__))
    from roofline_schur import _time_compiled

    K = args.capacity
    D = 13 + 6 * K
    M = 2 * K
    dtype = jnp.float32
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    A2 = jax.random.normal(key, (M, D), dtype) * 0.1
    Pq = jax.random.normal(jax.random.PRNGKey(1), (D, D), dtype) * 0.01
    P = Pq @ Pq.T + 1e-3 * jnp.eye(D, dtype=dtype)
    S2 = A2 @ A2.T * 1e-2 + jnp.eye(M, dtype=dtype)
    C = jnp.linalg.cholesky(S2)
    keep = jnp.asarray(rng.uniform(size=D) > 0.01, dtype)
    B = solve_triangular(C, A2, lower=True)
    reps = 3
    print(f"K={K} D={D} M={M}", flush=True)

    def t(name, fn, args, flops=None):
        dt = _time_compiled(fn, args, reps)
        eff = f"  ({flops / dt / 1e12:5.1f} TFLOP/s)" if flops else ""
        print(f"{name:34s} {dt * 1e3:8.3f} ms{eff}", flush=True)
        return dt

    N = 1  # each op timed standalone (big enough not to need scan)

    t("cholesky(S2) [M,M]",
      lambda s: jnp.linalg.cholesky(s),
      (S2,),
      flops=M ** 3 / 3)
    t("trsm C \\ [A2|r]  [M, D+1]",
      lambda c, a: solve_triangular(c, a, lower=True),
      (C, jnp.concatenate([A2, A2[:, :1]], axis=1)),
      flops=M * M * (D + 1))
    t("gram downdate B^T B [D,D]",
      lambda b: b.T @ b,
      (B,),
      flops=2.0 * M * D * D)
    t("downdate w/ epilogue P*kk^T - B^T B",
      lambda b, p: p * (keep[:, None] * keep[None, :]) - b.T @ b,
      (B, P),
      flops=2.0 * M * D * D)
    t("mask pass alone P*kk^T",
      lambda p: p * (keep[:, None] * keep[None, :]),
      (P,))
    t("symmetrize 0.5*(X+X^T)",
      lambda p: 0.5 * (p + p.T),
      (P,))

    t("downdate, barrier-split GEMM",
      lambda b, p: p * (keep[:, None] * keep[None, :])
      - jax.lax.optimization_barrier(b.T @ b),
      (B, P),
      flops=2.0 * M * D * D)

    # the S^-1 alternative: two GEMMs instead of the big trsm
    t("Sinv = cho_solve(I) [M,M]",
      lambda c: solve_triangular(
          c, solve_triangular(c, jnp.eye(M, dtype=dtype), lower=True),
          lower=True, trans=1),
      (C,),
      flops=2.0 * M ** 3 / 2)
    Sinv = jnp.linalg.inv(S2)
    t("G = Sinv @ A2 [M,M]@[M,D]",
      lambda s, a: s @ a,
      (Sinv, A2),
      flops=2.0 * M * M * D)


if __name__ == "__main__":
    main()

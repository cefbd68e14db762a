"""GP solvers for celerite-style semiseparable covariance matrices.

- ``dense``: O(N^2) reference implementation (Cholesky on the full matrix);
  the independent ground truth that the fast solver is validated against
  (same contract celerite itself is validated with).
- ``semiseparable``: the O(N R^2) celerite factorization as a pure-JAX
  ``lax.scan`` — jit/vmap/grad-compatible, batched across devices.
"""
from mind_the_gaps_tpu.solver.dense import dense_log_likelihood, dense_covariance
from mind_the_gaps_tpu.solver.kalman import (
    kalman_log_likelihood,
    parallel_kalman_log_likelihood,
)
from mind_the_gaps_tpu.solver.semiseparable import (
    CeleriteMatrices,
    build_matrices,
    factor,
    log_likelihood,
    solve,
    predict_mean,
    predict,
    predict_at,
    inverse_diag,
)

__all__ = [
    "dense_log_likelihood",
    "dense_covariance",
    "CeleriteMatrices",
    "build_matrices",
    "factor",
    "log_likelihood",
    "solve",
    "predict_mean",
    "predict",
    "predict_at",
    "inverse_diag",
    "kalman_log_likelihood",
    "parallel_kalman_log_likelihood",
]

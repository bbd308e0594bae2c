"""Randomized truncated SVD in torch, on the matrix's device.

A copy of what scikit-learn 1.9.0's `sklearn.utils.extmath.randomized_svd`
(BSD-3-Clause, (c) the scikit-learn developers) does for a dense matrix at
its defaults, which the JAX package's factorization models call
(`embiggen_tpu/models/embedders/factorization.py::_randomized_svd`): the
card's host has no scikit-learn, so the port keeps its own copy.

- n_oversamples 10: the range is sampled with n_components + 10 columns.
- The random matrix is `RandomState(random_state).normal(size=(n_features,
  n_components + 10))`, drawn with numpy and cast to the matrix's dtype, so
  a seed gives scikit-learn's sketch.
- power_iteration_normalizer "auto": LU (`lu(permute_l=True)`) when n_iter
  > 2, none otherwise; then an economic QR, B = Qᵀ M and its SVD.
- transpose "auto": M is transposed when it has fewer rows than columns.
- svd_flip's sign rule: each column of U has its largest |entry| positive
  (based on V's rows when transposed).

LU with partial pivoting may pivot otherwise than LAPACK's on near ties;
the sampled range is the same, and the QR and SVD that follow do not
depend on its basis, up to the signs that svd_flip fixes.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

N_OVERSAMPLES = 10


@contextlib.contextmanager
def cusolver_linalg(device: torch.device):
    """Inside the block, CUDA linear algebra (LU, solves, QR, SVD) goes to
    cuSOLVER: PyTorch's default sends some LU factorizations to MAGMA,
    whose batched routines print a warning on each call."""
    if device.type != "cuda":
        yield
        return
    previous = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(previous)


def _lu_permuted(a: torch.Tensor) -> torch.Tensor:
    """scipy's `lu(a, permute_l=True)[0]`: P L of a = P L U, for an [m, k]
    matrix, without forming the [m, m] permutation."""
    lu, pivots = torch.linalg.lu_factor(a)
    low = torch.tril(lu[:, : min(a.shape)], -1)
    low.diagonal().fill_(1.0)
    # LAPACK's pivots swap row i with row pivots[i] - 1, in order.
    perm = np.arange(a.shape[0])
    for i, p in enumerate(pivots.cpu().numpy() - 1):
        perm[i], perm[p] = perm[p], perm[i]
    out = torch.empty_like(low)
    out[torch.from_numpy(perm).to(a.device)] = low
    return out


def _svd_flip(u: torch.Tensor, v: torch.Tensor,
              u_based_decision: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """svd_flip: the sign of each column of u (row of v) at its largest
    |entry| (the first such on ties) becomes positive in both."""
    if u_based_decision:
        rows = torch.argmax(u.abs(), dim=0)
        signs = torch.sign(u[rows, torch.arange(u.shape[1], device=u.device)])
    else:
        cols = torch.argmax(v.abs(), dim=1)
        signs = torch.sign(v[torch.arange(v.shape[0], device=v.device), cols])
    return u * signs[None, :], v * signs[:, None]


def randomized_svd(
    m: torch.Tensor, n_components: int, n_iter: int, random_state: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(U [n, k], s [k], Vt [k, f]) of a dense [n, f] float matrix, as
    `sklearn.utils.extmath.randomized_svd(m, n_components, n_iter=n_iter,
    random_state=random_state)` computes them, on `m`'s device."""
    with cusolver_linalg(m.device):
        return _randomized_svd(m, n_components, n_iter, random_state)


def _randomized_svd(m, n_components, n_iter, random_state):
    n_random = n_components + N_OVERSAMPLES
    transpose = m.shape[0] < m.shape[1]
    a = m.T if transpose else m
    q = np.random.RandomState(random_state).normal(size=(a.shape[1], n_random))
    q = torch.from_numpy(q.astype(np.float32) if a.dtype == torch.float32 else q)
    q = q.to(device=a.device, dtype=a.dtype)
    normalize = _lu_permuted if n_iter > 2 else (lambda x: x)
    for _ in range(n_iter):
        q = normalize(a @ q)
        q = normalize(a.T @ q)
    q, _ = torch.linalg.qr(a @ q, mode="reduced")
    u_hat, s, vt = torch.linalg.svd(q.T @ a, full_matrices=False)
    u = q @ u_hat
    u, vt = _svd_flip(u, vt, u_based_decision=not transpose)
    if transpose:
        return vt[:n_components].T, s[:n_components], u[:, :n_components].T
    return u[:, :n_components], s[:n_components], vt[:n_components]

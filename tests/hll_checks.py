"""The tolerance that HyperLogLog sketch features are held to, shared by the
CPU tests (the port against the JAX package), the card's tests and
`chip_smoke.py` (kernel K16b against its plain version).

An overlap is |s_i| + |d_j| - |s_i u d_j| of float32 cardinalities, each a
float32 sum of 2^-r whose order differs between the two versions, so a
feature can be off by a few units in the last place of the pair's largest
cardinality: the tolerance is RTOL times (1 + the cardinality of the union
of the pair's largest balls).

An estimate whose raw value lies within TIE of the 2.5 M threshold of linear
counting (with a zero register) may take the other branch in the other
version. A pair with such a near tie is held instead, in both versions, to
the features computed in float64 with each near-tie estimate taking either
branch: every feature depends on three estimates (its own overlap's, or a
difference's ball and the largest opposite ball's overlap), so it must lie
within the tolerance of one of its eight branch choices. Ties are rare, and
at most MAX_TIE_SHARE of the pairs may have one: at precision 12 on the
20M-arc slice graph, unions of 3-hop balls hold about 10,000 nodes against
2.5 M = 10,240, and 0.14% of 2^20 pairs had a near tie there (NVIDIA H100
80GB HBM3, 700 W; `chip_smoke.py` phase 21). The check runs in torch on the
sketches' device.
"""
import numpy as np
import torch

from embiggen_tpu_torch.ops import hll

RTOL = 1e-5
TIE = 1e-4
MAX_TIE_SHARE = 0.003


def estimates(regs: torch.Tensor, precision: int):
    """([..., 2] float64 cardinalities, [...] near ties) of [..., M]
    registers: the estimate of the branch float64 takes, then that of the
    other branch where the raw estimate is a near tie (the first again
    elsewhere)."""
    m = 1 << precision
    raw = hll._alpha_mm(precision) / torch.exp2(-regs.to(torch.float64)).sum(-1)
    zeros = (regs == 0).sum(-1).to(torch.float64)
    linear = m * torch.log(m / zeros.clamp(min=1e-9))
    takes_linear = (raw <= 2.5 * m) & (zeros > 0)
    tie = ((raw - 2.5 * m).abs() <= TIE * 2.5 * m) & (zeros > 0)
    chosen = torch.where(takes_linear, linear, raw)
    other = torch.where(tie, torch.where(takes_linear, raw, linear), chosen)
    return torch.stack([chosen, other], -1), tie


def branch_features(cs, cd, cu) -> torch.Tensor:
    """[B, H^2 + 2H, 8] features, as `hll._features_of_registers` forms
    them, of [B, H, 2] ball and [B, H, H, 2] union estimates under each
    choice of branch for the three estimates each feature reads."""
    b, h, _ = cs.shape
    # overlap[:, i, j, a, c, u]: |s_i| choice a, |d_j| choice c, union's u.
    overlap = torch.clamp(cs[:, :, None, :, None, None] + cd[:, None, :, None, :, None]
                          - cu[:, :, :, None, None, :], min=0.0)
    left = torch.clamp(cs[:, :, :, None, None] - overlap[:, :, h - 1], min=0.0)
    right = torch.clamp(cd[:, :, None, :, None] - overlap[:, h - 1], min=0.0)
    return torch.cat([overlap.reshape(b, h * h, 8), left.reshape(b, h, 8),
                      right.reshape(b, h, 8)], dim=1)


def feature_errors(sketches, src, dst, precision, got, want, elements=1 << 26):
    """(the largest error over its tolerance, pairs with a near tie) of
    [B, H^2 + 2H] features of the pairs (src, dst) over [N, H, M] sketches
    (a tensor; the rest tensors or arrays). A pair without a near tie holds
    `got` to `want`; a pair with one holds both to its float64 features
    under either branch of each tie. The features agree where the first is
    at most 1. Works in chunks of about `elements` union registers."""
    sk = sketches
    as_t = lambda a: torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,  # noqa: E731
                                     device=sk.device)
    src, dst = as_t(src).long(), as_t(dst).long()
    got, want = as_t(got).double(), as_t(want).double()
    _, h, m = sk.shape
    chunk = max(1, elements // (h * h * m))
    worst, ties = 0.0, 0
    for i in range(0, src.shape[0], chunk):
        s, d = sk[src[i:i + chunk]], sk[dst[i:i + chunk]]
        union = torch.maximum(s[:, :, None, :], d[:, None, :, :])
        (cs, s_tie), (cd, d_tie), (cu, u_tie) = (
            estimates(s, precision), estimates(d, precision), estimates(union, precision))
        tie = s_tie.any(1) | d_tie.any(1) | u_tie.flatten(1).any(1)
        tol = RTOL * (1.0 + cu[:, -1, -1, 0])[:, None]
        g, w = got[i:i + chunk], want[i:i + chunk]
        if bool((~tie).any()):
            worst = max(worst, float(((g - w).abs() / tol)[~tie].max()))
        if bool(tie.any()):
            cand = branch_features(cs[tie], cd[tie], cu[tie])
            for x in (g[tie], w[tie]):
                err = (x[:, :, None] - cand).abs().min(-1).values / tol[tie]
                worst = max(worst, float(err.max()))
        ties += int(tie.sum())
    return worst, ties

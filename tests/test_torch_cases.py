"""Operands for the port's curve-kernel tests: pairs (P, Q) with one lane of
every special kind.  Shared by tests/test_torch_ec_kernels.py (CPU, against
the JAX package) and tests/test_torch_gpu_kernels.py (GPU, kernels against
their plain versions); imports torch only and holds no test of its own.
"""

import torch

# lane -> kind of the pair (P, Q) it holds; lanes 8.. are ordinary
LANES = {"equal": 0, "opposite": 1, "q_infinity": 2, "p_infinity": 3,
         "both_infinity": 4, "y_zero_doubling": 5, "ordinary": 8}
PROJ_LANES = dict(LANES, equal_in_two_forms=6)


def proj_pairs(curve, proj):
    """(P, Q) for the projective addition from >= 9 distinct projective
    points, the special lanes first."""
    n = proj[0].shape[0]
    P = tuple(c.clone() for c in proj)
    Q = tuple(c.roll(1, 0).clone() for c in proj)
    zero = curve.zero((1,))
    negP = curve.neg(P)
    lam = proj[0][n - 1]              # any non-zero field element
    for k in range(3):
        Q[k][0] = P[k][0]
        Q[k][1] = negP[k][1]
        Q[k][2] = zero[k][0]
        P[k][3] = zero[k][0]
        P[k][4] = zero[k][0]
        Q[k][4] = zero[k][0]
        Q[k][6] = curve.F.mul(P[k][6], lam)
    P[1][5] = 0                       # fabricated: no such point exists
    for k in range(3):
        Q[k][5] = P[k][5]
    return P, Q


def affine_pairs(curve, aff):
    """(a_pt, b_pt) for the batched affine addition, each ((x, y), inf),
    from >= 9 distinct affine points."""
    n = aff[0].shape[0]
    x1, y1 = aff[0].clone(), aff[1].clone()
    x2, y2 = aff[0].roll(1, 0).clone(), aff[1].roll(1, 0).clone()
    inf1 = torch.zeros(n, dtype=torch.bool, device=x1.device)
    inf2 = torch.zeros(n, dtype=torch.bool, device=x1.device)
    x2[0], y2[0] = x1[0], y1[0]
    x2[1], y2[1] = x1[1], curve.F.neg(y1[1])
    inf2[2] = inf1[3] = inf1[4] = inf2[4] = True
    x2[2] = y2[2] = x1[3] = y1[3] = 0
    for t in (x1, y1, x2, y2):
        t[4] = 0
    y1[5] = 0
    x2[5], y2[5] = x1[5].clone(), y1[5].clone()
    return ((x1, y1), inf1), ((x2, y2), inf2)

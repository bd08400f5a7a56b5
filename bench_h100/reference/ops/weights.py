"""Fast-time averaging filter weights for the split-explicit coupling
(the port's own copy of roms_tpu/ops/weights.py).

Power-function shaped primary/secondary weights, second-order accurate,
iteratively centered at ndtfast and normalized in double precision
(reference: src/set_weights.F:7-175; POWER_FUNCTION branch with
p=2, q=4, r=0.25 — reference: set_weights.F:70-72).

Computed once at setup in NumPy float64 (the reference uses real*8 sums,
QUAD==8, reference: set_global_definitions.h:375-382); `nfast`, the
barotropic loop length, is a host int, so the loop never waits on the
device.
"""

from __future__ import annotations

import numpy as np


def set_weights(ndtfast: int):
    """Return (weight1, weight2, nfast): primary/secondary weights, each
    shape (nfast,), float64, normalized to sum to 1."""
    p, q, r = 2.0, 4.0, 0.25
    w1 = np.zeros(2 * ndtfast, dtype=np.float64)

    # --- primary shape function, scale iterated to center the centroid
    # (reference: set_weights.F:75-95)
    scale = (p + 1.0) * (p + q + 1.0) / ((p + 2.0) * (p + q + 2.0) * ndtfast)
    nfast = 0
    for _ in range(16):
        nfast = 0
        for i in range(1, 2 * ndtfast + 1):
            cff = scale * float(i)
            w1[i - 1] = cff ** p - cff ** (p + q) - r * cff
            if w1[i - 1] > 0.0:
                nfast = i
            if nfast > 0 and w1[i - 1] < 0.0:
                w1[i - 1] = 0.0
        s = w1[:nfast].sum()
        shft = (w1[:nfast] * np.arange(1, nfast + 1)).sum()
        scale = scale * shft / (s * ndtfast)

    # --- advect weights so the centroid sits exactly at ndtfast
    # (reference: set_weights.F:118-156)
    for _ in range(ndtfast):
        s = w1[:nfast].sum()
        shft = (w1[:nfast] * np.arange(1, nfast + 1)).sum() / s
        cff = float(ndtfast) - shft
        if cff > 1.0:
            nfast += 1
            w1[1:nfast] = w1[0:nfast - 1]
            w1[0] = 0.0
        elif cff > 0.0:
            sm = 1.0 - cff
            w1[1:nfast] = sm * w1[1:nfast] + cff * w1[0:nfast - 1]
            w1[0] = sm * w1[0]
        elif cff < -1.0:
            nfast -= 1
            w1[0:nfast] = w1[1:nfast + 1]
            w1[nfast] = 0.0
        elif cff < 0.0:
            sm = 1.0 + cff
            w1[0:nfast - 1] = sm * w1[0:nfast - 1] - cff * w1[1:nfast]
            w1[nfast - 1] = sm * w1[nfast - 1]

    # --- secondary weights: running partial sums (backward-Euler free
    # surface weighting; reference: set_weights.F:158-163)
    w2 = np.zeros_like(w1)
    for j in range(1, nfast + 1):
        w2[:j] += w1[j - 1]

    s1 = w1[:nfast].sum()
    s2 = w2[:nfast].sum()
    w1[:nfast] /= s1
    w2[:nfast] /= s2
    return w1[:nfast].copy(), w2[:nfast].copy(), nfast

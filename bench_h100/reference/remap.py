"""Conservative vertical remapping of source profiles onto model levels
(a copy of roms_tpu/remap.py; reference: src/vertical_remapping.F,
piecewise-parabolic reconstruction with implicit 4th-order interface
values, White & Adcroft 2008 Eq. 46).

Host-side numpy: runs at initialization / forcing-refresh time, once per
release column (reference: cdr_frc.F:437).
"""

from __future__ import annotations

import numpy as np


def _gauss_first(M: np.ndarray, b: np.ndarray) -> float:
    """Gaussian elimination to lower-triangular, returning x[0]
    (reference: vertical_remapping.F:265-296)."""
    M = M.copy()
    b = b.copy()
    ord_ = M.shape[0] - 1
    for i in range(ord_, 0, -1):
        for j in range(i):
            ratio = M[j, i] / M[i, i]
            M[j, :i + 1] -= ratio * M[i, :i + 1]
            b[j] -= ratio * b[i]
    return b[0] / M[0, 0]


def _boundary_extrap(H: np.ndarray, arr: np.ndarray, from_top: bool) -> float:
    """Cubic-polynomial boundary extrapolation over 4 cells
    (reference: vertical_remapping.F:221-258)."""
    n = H.size
    if n < 4:  # too few cells for the cubic fit; constant extrapolation
        return float(arr[-1] if from_top else arr[0])
    ord_ = 3
    M = np.zeros((ord_ + 1, ord_ + 1))
    B = np.zeros(ord_ + 1)
    h_b = 0.0
    h_t = H[n - 1] if from_top else H[0]
    for k in range(ord_ + 1):
        iH = 1.0 / (h_t - h_b)
        for kk in range(ord_ + 1):
            p = kk + 1
            M[k, kk] = (1.0 / p) * iH * (h_t ** p - h_b ** p)
        if from_top:
            B[k] = arr[n - 1 - k]
            h_b = h_b + H[n - 1 - k]
            if k + 1 <= ord_:
                h_t = h_t + H[n - 2 - k]
        else:
            B[k] = arr[k]
            h_b = h_b + H[k]
            if k + 1 <= ord_:
                h_t = h_t + H[k + 1]
    return _gauss_first(M, B)


def calc_interface_values(H: np.ndarray, arr: np.ndarray) -> np.ndarray:
    """Cell-center -> interface values, implicit 4th-order + Thomas solve
    (reference: vertical_remapping.F:195-358)."""
    n_src = H.size
    ts_bot = _boundary_extrap(H, arr, from_top=False)
    ts_top = _boundary_extrap(H, arr, from_top=True)

    n = n_src + 1
    a = np.zeros(n)
    b = np.ones(n)
    c = np.zeros(n)
    d = np.zeros(n)
    d[0] = ts_bot
    d[n - 1] = ts_top
    for k in range(1, n - 1):
        h0, h1 = H[k - 1], H[k]
        s = (h0 + h1)
        a[k] = h1 ** 2 / s ** 2
        c[k] = h0 ** 2 / s ** 2
        d1 = 2 * h1 ** 2 * (h1 ** 2 + 2 * h0 ** 2 + 3 * h0 * h1) / s ** 4
        d2 = 2 * h0 ** 2 * (h0 ** 2 + 2 * h1 ** 2 + 3 * h0 * h1) / s ** 4
        d[k] = d1 * arr[k - 1] + d2 * arr[k]

    cp = np.zeros(n)
    dp = np.zeros(n)
    cp[0] = c[0] / b[0]
    dp[0] = d[0] / b[0]
    for k in range(1, n - 1):
        den = b[k] - a[k] * cp[k - 1]
        cp[k] = c[k] / den
        dp[k] = (d[k] - a[k] * dp[k - 1]) / den
    out = np.zeros(n)
    out[n - 1] = d[n - 1]
    for k in range(n - 2, -1, -1):
        out[k] = dp[k] - cp[k] * out[k + 1]
    return out


def _integrate(a0, a1, a2, z0, z1):
    """Definite integral of the cell parabola on normalized coords
    (reference: vertical_remapping.F:182-193, with its 0.3333333333)."""
    one_third = 0.3333333333
    return (a0 * (z1 - z0) + 0.5 * a1 * (z1 ** 2 - z0 ** 2)
            + one_third * a2 * (z1 ** 3 - z0 ** 3))


def remap_src_to_grid(h_src: np.ndarray, t_src: np.ndarray,
                      h_tgt: np.ndarray) -> np.ndarray:
    """Conservatively remap cell-mean profile t_src on layers h_src onto
    layers h_tgt (reference: vertical_remapping.F:20-180).  Total tracer
    content sum(t*H) is preserved exactly (trailing conservation fix)."""
    h_src = np.asarray(h_src, np.float64)
    t_src = np.asarray(t_src, np.float64)
    h_tgt = np.asarray(h_tgt, np.float64)
    n_src, n_tgt = h_src.size, h_tgt.size

    iface = calc_interface_values(h_src, t_src)
    a0 = iface[:-1]
    a1 = 6 * t_src - 4 * iface[:-1] - 2 * iface[1:]
    a2 = 3 * (iface[:-1] + iface[1:] - 2 * t_src)
    total_t_src = float(np.sum(t_src * h_src))

    # stretch source layers to match the target column depth
    total_src = float(h_src.sum())
    total_tgt = float(h_tgt.sum())
    h_orig = h_src * (total_tgt / total_src)
    h_orig[-1] += total_tgt - h_orig.sum()
    z_if = np.concatenate([[0.0], np.cumsum(h_orig)])

    # locate target interfaces inside the (stretched) source column
    tgt_start = np.ones(n_tgt, np.int64)
    tgt_end = np.ones(n_tgt, np.int64)
    tgt_frac_start = np.zeros(n_tgt)
    tgt_frac_end = np.zeros(n_tgt)
    cur_tgt = h_tgt[0]
    cur_src = h_orig[0]
    cur_idx = 0  # 0-based
    tgt_start[0] = 0
    for k_new in range(n_tgt - 1):
        while cur_tgt > cur_src:
            cur_idx += 1
            cur_src += h_orig[cur_idx]
        tgt_end[k_new] = cur_idx
        tgt_start[k_new + 1] = cur_idx
        tgt_frac_end[k_new] = (cur_tgt - z_if[cur_idx]) / h_orig[cur_idx]
        tgt_frac_start[k_new + 1] = tgt_frac_end[k_new]
        cur_tgt += h_tgt[k_new + 1]
    tgt_end[n_tgt - 1] = n_src - 1
    tgt_frac_end[n_tgt - 1] = 1.0

    t_tmp = np.zeros(n_tgt)
    for k in range(n_tgt):
        di = 0.0
        for idx in range(tgt_start[k], tgt_end[k] + 1):
            if tgt_start[k] == tgt_end[k]:
                di = _integrate(a0[idx], a1[idx], a2[idx],
                                tgt_frac_start[k], tgt_frac_end[k]) * h_src[idx]
            elif idx == tgt_start[k]:
                di = _integrate(a0[idx], a1[idx], a2[idx],
                                tgt_frac_start[k], 1.0) * h_src[idx]
            elif idx < tgt_end[k]:
                di += _integrate(a0[idx], a1[idx], a2[idx], 0.0, 1.0) * h_src[idx]
            else:
                di += _integrate(a0[idx], a1[idx], a2[idx],
                                 0.0, tgt_frac_end[k]) * h_src[idx]
        t_tmp[k] = di / h_tgt[k]
    total_t_tgt = float(np.sum(t_tmp * h_tgt))

    # exact-conservation correction (reference: vertical_remapping.F:168-178)
    out = np.zeros(n_tgt)
    if total_t_tgt != 0.0:
        diff = total_t_tgt - total_t_src
        out = t_tmp - diff * (t_tmp / total_t_tgt)
    return out

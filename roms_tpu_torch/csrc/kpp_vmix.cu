// The vertical-mixing update (lmd_vmix interior coefficients plus both
// lmd_kpp boundary layers), one thread per (j, i) column, on NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel roms_tpu/ops/pallas_kpp.py (vmix_update,
// _kernel) and its epilogue: it computes what roms_tpu_torch/ops/kpp.py
// (interior_mix + lmd_kpp) computes, operation by operation:
//
//   interior (reference: lmd_vmix.F:150-404): shear Ri on the nz-1
//     interior W levels, the masked SMOOTH_RIG smoother, LMD_CONVEC,
//     bottom suppression, the ascending in-place vertical smoothing plus
//     background;
//   KPP (reference: lmd_kpp.F:153-651): the INT_AT_RHO_POINTS bulk
//     Richardson integral FC from the top, the surface search "largest k
//     with Cr < 0" and the bottom search "smallest k with Cr > 0" with
//     their interpolations, SMOOTH_HBL, the 0.5 time filter unless
//     first_step, wscale, the shape profiles, nonlocal ghat, the bottom
//     layer profile and the land mask.
//
// Three launches, each with one thread per column and threads along i,
// so every level's loads and stores coalesce (fields are (k, j, i)):
//
//   1. k_rig:     raw Ri on levels 1..nz-1 into scratch R;
//   2. k_column:  smoothed Ri (it reads R at +-2 cells, so the
//                 ownership-gated physical-edge fill of
//                 kpp._fill_phys_edges_2d is an index remap on those
//                 reads), Kv/Kt with the vertical smoothing straight into
//                 the outputs, FC into scratch, Cr into scratch, the two
//                 searches and the raw masked hbl/bbl into scratch HB;
//   3. k_profile: fill + smooth of hbl/bbl (again +-2 cells), the time
//                 filter, and the per-level profiles, updating Kv/Kt in
//                 place (each thread reads and writes its own column).
//
// Neighbours come from index arithmetic, (i + di + ix) % ix, which is the
// roll semantics of the JAX and plain versions, so every point, the
// outermost ghost lines included, gets the plain version's value.  The
// TPU kernel's wrap-padded row windows, its one-hot gathers and its
// exp/log cube root were Mosaic workarounds: here gathers are indexed
// loads and the cube root is cbrt.  Kt goes straight into row 0 of the
// (n_akt, nz+1, jy, ix) diffusivity, and again into row 1 when there is
// salinity (Ks == Kt without double diffusion).  Masks read as 1 when
// masking is off (NULL pointers).
//
// What bounds it on this card: device-memory bandwidth at the shapes of
// the main path (~40 flops per point and level against ~11 fields of
// nz-deep input and output); see PERF.md for the bound in bytes.  What
// this simple design leaves for later: the smoothers recompute their
// fluxes from R with ~60 neighbour loads per point and level that rely on
// L1/L2, and Kv/Kt/FC/Cr make a round trip through device memory between
// launches; a faster kernel keeps a tile with a 3-cell halo in shared
// memory and the column in registers.
//
// Entry points: roms_kpp_vmix_f32 / _f64, plain C, bound by ctypes from
// roms_tpu_torch/ops/cuda_kpp.py.  Each launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

// KPP and interior constants (reference: lmd_kpp.F:60-84, lmd_vmix.F:64-91)
constexpr double RICR = 0.15;
constexpr double RI_INV = 1.0 / RICR;
constexpr double EPSSFC = 0.1;
constexpr double NU0C = 0.1;
constexpr double C_EK = 258.0;
constexpr double ZETA_M = -0.2;
constexpr double A_M = 1.257;
constexpr double C_M = 8.360;
constexpr double ZETA_S = -1.0;
constexpr double A_S = -28.86;
constexpr double C_S = 98.96;
constexpr double EPS_KPP = 1.0e-20;
constexpr double RI0 = 0.7;
constexpr double NU0M = 1.0e-2;
constexpr double NU0S = 1.0e-2;
constexpr double NUWM = 1.0e-4;
constexpr double NUWS = 0.1e-4;
constexpr double LTURB = 10.0;
constexpr double PI = 3.141592653589793;

__device__ __forceinline__ float xsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double xsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float xcbrt(float x) { return cbrtf(x); }
__device__ __forceinline__ double xcbrt(double x) { return cbrt(x); }
__device__ __forceinline__ float xsin(float x) { return sinf(x); }
__device__ __forceinline__ double xsin(double x) { return sin(x); }
__device__ __forceinline__ float xlog(float x) { return logf(x); }
__device__ __forceinline__ double xlog(double x) { return log(x); }
__device__ __forceinline__ float xpow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double xpow(double x, double y) { return pow(x, y); }

template <typename T>
__device__ __forceinline__ T mx(T a, T b) { return a > b ? a : b; }

template <typename T>
__device__ __forceinline__ T mn(T a, T b) { return a < b ? a : b; }

template <typename T>
__device__ __forceinline__ T sq(T a) { return a * a; }

template <typename T>
struct Args {
  // inputs: 3D (k, j, i)
  const T *u, *v, *bvf, *z_r, *z_w, *hz, *swrf;
  // inputs: 2D (j, i); ts_s, stf_s NULL without salinity, masks NULL
  // without masking
  const T *ts_t, *ts_s, *stf_t, *stf_s, *srflx, *sustr, *svstr, *f;
  const T *rmask, *umask, *vmask, *hbls, *hbbl;
  // outputs: akt_s NULL without salinity; hbl2 (2, jy, ix)
  T *akv, *akt_t, *akt_s, *ghat, *hbl2;
  // scratch: R (nz-1 planes), FC (nz+1), CR (nz), HB (2)
  T *R, *FC, *CR, *HB;
  int nz, jy, ix;
  int masking, salinity, nonlin_eos, ew_periodic, ns_periodic;
  int own_w, own_e, own_s, own_n, first_step;
  double g, rho0, vk, zob, akv_bak, akt_bak, tcoef, scoef, cg, vtc;
};

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

template <typename T>
__device__ __forceinline__ T msk(const T* m, long c) {
  return m != nullptr ? m[c] : T(1);
}

// Zero-gradient physical-edge fill as an index remap (kpp._fill_phys_edges_2d:
// cols 0,1 <- 2 and ix-2, ix-1 <- ix-3 on owned non-periodic edges; rows
// likewise, applied after the columns, so the remap is separable).
template <typename T>
__device__ __forceinline__ int fill_i(int i, const Args<T>& a) {
  if (!a.ew_periodic) {
    if (a.own_w && i < 2) return 2;
    if (a.own_e && i >= a.ix - 2) return a.ix - 3;
  }
  return i;
}

template <typename T>
__device__ __forceinline__ int fill_j(int j, const Args<T>& a) {
  if (!a.ns_periodic) {
    if (a.own_s && j < 2) return 2;
    if (a.own_n && j >= a.jy - 2) return a.jy - 3;
  }
  return j;
}

// The masked isotropic smoother (kpp._smooth2d, cff=1/12, cff1=3/16) of
// the edge-filled plane w at (j, i), without the final rmask.
template <typename T>
__device__ T smooth_at(const T* __restrict__ w, int j, int i,
                       const Args<T>& a) {
  const int jy = a.jy, ix = a.ix;
  auto W = [&](int jj, int ii) {
    return w[(long)fill_j(wrap(jj, jy), a) * ix + fill_i(wrap(ii, ix), a)];
  };
  auto FX = [&](int jj, int ii) {     // (w - w[i-1]) * umask
    const int jw = wrap(jj, jy), iw = wrap(ii, ix);
    return (W(jw, iw) - W(jw, iw - 1)) * msk(a.umask, (long)jw * ix + iw);
  };
  auto FE1 = [&](int jj, int ii) {    // (w - w[j-1]) * vmask
    const int jw = wrap(jj, jy), iw = wrap(ii, ix);
    return (W(jw, iw) - W(jw - 1, iw)) * msk(a.vmask, (long)jw * ix + iw);
  };
  const T cff = T(1.0 / 12.0), cff1 = T(3.0 / 16.0);
  auto FE = [&](int jj, int ii) {
    return FE1(jj, ii) + cff * (FX(jj, ii + 1) + FX(jj - 1, ii) - FX(jj, ii)
                                - FX(jj - 1, ii + 1));
  };
  auto FX2 = [&](int jj, int ii) {
    return FX(jj, ii) + cff * (FE1(jj + 1, ii) + FE1(jj, ii - 1) - FE1(jj, ii)
                               - FE1(jj + 1, ii - 1));
  };
  return W(j, i) + cff1 * (FX2(j, i + 1) - FX2(j, i) + FE(j + 1, i) - FE(j, i));
}

// Surface buoyancy forcing Bo, its solar part Bosol and ustar at a column
// (alfabeta at the surface, reference: src/alfabeta.F; lmd_kpp.F:153-200).
template <typename T>
__device__ void surface_forcing(const Args<T>& a, long c, int j, int i,
                                T& Bo, T& Bosol, T& ustar) {
  const T g = T(a.g);
  T alpha, beta;
  if (!a.nonlin_eos) {
    alpha = T(a.tcoef);
    beta = a.salinity ? T(a.scoef) : T(0);
  } else {
    const T r01 = T(6.793952e-2), r02 = T(-9.095290e-3), r03 = T(1.001685e-4),
            r04 = T(-1.120083e-6), r05 = T(6.536332e-9);
    const T r10 = T(0.824493), r11 = T(-4.08990e-3), r12 = T(7.64380e-5),
            r13 = T(-8.24670e-7), r14 = T(5.38750e-9);
    const T rS0 = T(-5.72466e-3), rS1 = T(1.02270e-4), rS2 = T(-1.65460e-6),
            r20 = T(4.8314e-4);
    const T cff = T(1.0 / a.rho0);
    const T Tt = a.ts_t[c];
    T al = -(r01 + Tt * (T(2) * r02 + Tt * (T(3) * r03 + Tt * (T(4) * r04
                                                              + Tt * T(5) * r05))));
    if (a.salinity) {
      const T Ts = a.ts_s[c];
      const T sqrtTs = xsqrt(mx(T(0), Ts));
      al = al - Ts * (r11 + Tt * (T(2) * r12 + Tt * (T(3) * r13 + Tt * T(4) * r14))
                      + sqrtTs * (rS1 + Tt * T(2) * rS2));
      beta = cff * (r10 + Tt * (r11 + Tt * (r12 + Tt * (r13 + Tt * r14)))
                    + T(1.5) * (rS0 + Tt * (rS1 + Tt * rS2)) * sqrtTs
                    + T(2) * r20 * Ts);
    } else {
      beta = T(0);
    }
    alpha = cff * al;
  }
  const T srflx = a.srflx[c];
  Bo = g * (alpha * (a.stf_t[c] - srflx));
  if (a.salinity) Bo = Bo - g * beta * a.stf_s[c];
  Bosol = g * alpha * srflx;
  const int ip = wrap(i + 1, a.ix), jp = wrap(j + 1, a.jy);
  const T su = a.sustr[c], su1 = a.sustr[(long)j * a.ix + ip];
  const T sv = a.svstr[c], sv1 = a.svstr[(long)jp * a.ix + i];
  ustar = xsqrt(xsqrt(T(1.0 / 3.0) * (su * su + su1 * su1 + su * su1
                                      + sv * sv + sv1 * sv1 + sv * sv1)));
}

// ws (reference: lmd_wscale_ws_only.h) and wm (lmd_wscale_wm_and_ws.h)
template <typename T>
__device__ __forceinline__ T zetahat_of(T zscale, T bfsfc, T hbl, T rm,
                                        const Args<T>& a) {
  zscale = mn(zscale, hbl * T(EPSSFC));
  if (a.masking) zscale = zscale * rm;
  return T(a.vk) * zscale * bfsfc;
}

template <typename T>
__device__ __forceinline__ T w_stable(T ustar, T ustar3, T zetahat,
                                      const Args<T>& a) {
  return T(a.vk) * ustar * ustar3 / mx(ustar3 + T(5) * zetahat, T(EPS_KPP));
}

template <typename T>
__device__ __forceinline__ T ws_of(T zetahat, T ustar, T ustar3,
                                   const Args<T>& a) {
  if (zetahat >= T(0)) return w_stable(ustar, ustar3, zetahat, a);
  if (zetahat > T(ZETA_S) * ustar3)
    return T(a.vk) * xsqrt(mx((ustar3 - T(16) * zetahat) / mx(ustar, T(EPS_KPP)),
                              T(0)));
  return T(a.vk) * xcbrt(T(A_S) * ustar3 - T(C_S) * zetahat);
}

template <typename T>
__device__ __forceinline__ T wm_of(T zetahat, T ustar, T ustar3,
                                   const Args<T>& a) {
  if (zetahat >= T(0)) return w_stable(ustar, ustar3, zetahat, a);
  if (zetahat > T(ZETA_M) * ustar3)
    return T(a.vk) * xpow(mx(ustar * (ustar3 - T(16) * zetahat), T(0)),
                          T(0.25));
  return T(a.vk) * xcbrt(T(A_M) * ustar3 - T(C_M) * zetahat);
}

// ---------------------------------------------------------------- launch 1
template <typename T>
__global__ void k_rig(Args<T> a) {
  const long n2 = (long)a.jy * a.ix;
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n2) return;
  const int j = (int)(c / a.ix), i = (int)(c - (long)j * a.ix);
  const long cu = (long)j * a.ix + wrap(i + 1, a.ix);   // u at i+1
  const long cv = (long)wrap(j + 1, a.jy) * a.ix + i;   // v at j+1
  for (int k = 1; k < a.nz; ++k) {
    const long o = k * n2, om = (k - 1) * n2;
    const T cffz = T(0.5) / (a.z_r[o + c] - a.z_r[om + c]);
    const T dudz = cffz * (a.u[o + c] - a.u[om + c] + a.u[o + cu] - a.u[om + cu]);
    const T dvdz = cffz * (a.v[o + c] - a.v[om + c] + a.v[o + cv] - a.v[om + cv]);
    a.R[om + c] = a.bvf[o + c] / (T(RI0) * mx(dudz * dudz + dvdz * dvdz, T(1.0e-10)));
  }
}

// ---------------------------------------------------------------- launch 2
template <typename T>
__global__ void k_column(Args<T> a) {
  const long n2 = (long)a.jy * a.ix;
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n2) return;
  const int j = (int)(c / a.ix), i = (int)(c - (long)j * a.ix);
  const int nz = a.nz;
  const T rm = msk(a.rmask, c);
  const T zw0 = a.z_w[c], zw_top = a.z_w[nz * n2 + c];

  // interior Kv/Kt at level m+1 (m = 0..nz-2), before vertical smoothing
  auto interior = [&](int m, T& kv3, T& kt3) {
    const T rig = smooth_at(a.R + m * n2, j, i, a);
    const T cffr = mn(T(1), mx(T(0), rig));
    const T nu = T(1) - cffr * cffr;
    const T nu_sx = nu * nu * nu;
    kv3 = T(NUWM) + T(NU0M) * nu_sx;
    kt3 = T(NUWS) + T(NU0S) * nu_sx;
    if (rig < T(0)) {                               // LMD_CONVEC
      kv3 = kv3 + T(NU0C);
      kt3 = kt3 + T(NU0C);
    }
    const T dist = a.z_w[(m + 1) * n2 + c] - zw0;   // bottom suppression
    const T mult = dist < T(LTURB) ? xsin(T(0.5 * PI) * dist / T(LTURB)) : T(1);
    kv3 = kv3 * mult;
    kt3 = kt3 * mult;
  };

  // ascending in-place vertical smoothing + background (lmd_vmix.F:396-404):
  // level k reads the smoothed k-1 and the raw k+1 (the top pad at k = nz-1)
  {
    const T bv = T(a.akv_bak), bt = T(a.akt_bak);
    T rv, rt;                         // raw level k
    interior(0, rv, rt);
    T pv = rv + bv, pt = rt + bt;       // bottom pad
    a.akv[c] = pv;
    a.akt_t[c] = pt;
    for (int k = 1; k < nz; ++k) {
      T nv, nt;
      if (k < nz - 1) {
        interior(k, nv, nt);
      } else {
        nv = rv + bv;                                  // top pad
        nt = rt + bt;
      }
      pv = T(0.5) * rv + T(0.25) * pv + T(0.25) * nv + bv;
      pt = T(0.5) * rt + T(0.25) * pt + T(0.25) * nt + bt;
      a.akv[k * n2 + c] = pv;
      a.akt_t[k * n2 + c] = pt;
      if (k == nz - 1) {
        a.akv[nz * n2 + c] = nv;
        a.akt_t[nz * n2 + c] = nt;
      }
      rv = nv;
      rt = nt;
    }
  }

  // bulk Richardson integral FC at W-levels, from the top (lmd_kpp.F:202-236)
  const T hbl = a.hbls[c], bbl = a.hbbl[c];
  const long cu = (long)j * a.ix + wrap(i + 1, a.ix);
  const long cv = (long)wrap(j + 1, a.jy) * a.ix + i;
  const T f2 = a.f[c] * a.f[c];
  const T eh = sq(T(EPSSFC) * hbl), eb = sq(T(EPSSFC) * bbl);
  auto ur = [&](int k) { return T(0.5) * (a.u[k * n2 + c] + a.u[k * n2 + cu]); };
  auto vr = [&](int k) { return T(0.5) * (a.v[k * n2 + c] + a.v[k * n2 + cv]); };
  T acc = T(0);
  a.FC[nz * n2 + c] = acc;
  {
    T ur_hi = ur(nz - 1), vr_hi = vr(nz - 1);
    for (int k = nz - 1; k >= 1; --k) {
      const T ur_lo = ur(k - 1), vr_lo = vr(k - 1);
      const T du2 = sq(T(2) * (ur_hi - ur_lo)) + sq(T(2) * (vr_hi - vr_lo));
      const T hz2 = a.hz[k * n2 + c] + a.hz[(k - 1) * n2 + c];
      const T zw = a.z_w[k * n2 + c];
      const T cff_up = sq(zw_top - zw), cff_dn = sq(zw - zw0);
      const T kern = cff_up * cff_dn / ((cff_up + eh) * (cff_dn + eb));
      acc = acc + kern * (T(0.5) * du2 / hz2
                          - T(0.5) * hz2 * (T(RI_INV) * a.bvf[k * n2 + c]
                                            + T(C_EK) * f2));
      a.FC[k * n2 + c] = acc;
      ur_hi = ur_lo;
      vr_hi = vr_lo;
    }
  }
  const T hz0 = a.hz[c];
  const T z_bl0 = zw0 + T(0.25) * hz0;
  const T cu0 = sq(zw_top - z_bl0), cd0 = sq(z_bl0 - zw0);
  const T kern0 = cu0 * cd0 / ((cu0 + eh) * (cd0 + eb));
  const T fc0 = a.FC[n2 + c] + kern0 * (
      T(0.5) * (sq(T(2) * ur(0)) + sq(T(2) * vr(0))) / hz0
      - T(0.5) * hz0 * (T(RI_INV) * a.bvf[n2 + c] + T(C_EK) * f2));
  a.FC[c] = fc0;

  // surface boundary layer depth (lmd_kpp.F:238-275)
  T Bo, Bosol, ustar;
  surface_forcing(a, c, j, i, Bo, Bosol, ustar);
  const T ustar3 = ustar * ustar * ustar;
  const T vt = T(1.8 * a.vtc);
  int kbls = 0;                                       // largest k with Cr < 0
  for (int k = 1; k <= nz; ++k) {
    const int m = k - 1;                              // rho level
    const T swdk = xsqrt(a.swrf[k * n2 + c] * a.swrf[m * n2 + c]);
    const T zscale = zw_top - a.z_r[m * n2 + c];
    const T bfsfc = Bo + Bosol * (T(1) - swdk);
    const T ws = ws_of(zetahat_of(zscale, bfsfc, hbl, rm, a), ustar, ustar3, a);
    const T vtsq = vt * ws * xsqrt(mx(T(1.0e-5), a.bvf[m * n2 + c]));
    const T cr = a.FC[k * n2 + c] + vtsq;
    a.CR[m * n2 + c] = cr;
    if (cr < T(0)) kbls = k;
  }
  T hbl_new;
  if (kbls == 0) {
    hbl_new = zw_top - zw0;
  } else if (kbls == nz) {
    hbl_new = zw_top - a.z_r[(nz - 1) * n2 + c];
  } else {                         // interpolate between z_r(k) and z_r(k+1)
    const T cr_k = a.CR[(kbls - 1) * n2 + c], cr_k1 = a.CR[kbls * n2 + c];
    const T zr_k = a.z_r[(kbls - 1) * n2 + c], zr_k1 = a.z_r[kbls * n2 + c];
    hbl_new = zw_top - (zr_k * cr_k1 - zr_k1 * cr_k) / (cr_k1 - cr_k);
  }
  if (a.masking) hbl_new = hbl_new * rm;

  // bottom boundary layer depth (lmd_kpp.F:277-302)
  int kbbl = nz + 1;                                  // smallest k with Cr > 0
  for (int k = nz; k >= 1; --k)
    if (a.FC[k * n2 + c] - fc0 > T(0)) kbbl = k;
  T bbl_new;
  if (kbbl == nz + 1) {
    bbl_new = zw_top - zw0;
  } else if (kbbl == 1) {
    bbl_new = a.z_r[c] - zw0;
  } else {
    const T crb_k = a.FC[kbbl * n2 + c] - fc0;
    const T crb_km1 = a.FC[(kbbl - 1) * n2 + c] - fc0;
    const T zr_km1 = a.z_r[(kbbl - 2) * n2 + c], zr_kk = a.z_r[(kbbl - 1) * n2 + c];
    bbl_new = (zr_km1 * crb_k - zr_kk * crb_km1) / (crb_k - crb_km1) - zw0;
  }
  if (a.masking) bbl_new = bbl_new * rm;
  a.HB[c] = hbl_new;
  a.HB[n2 + c] = bbl_new;
}

// ---------------------------------------------------------------- launch 3
template <typename T>
__global__ void k_profile(Args<T> a) {
  const long n2 = (long)a.jy * a.ix;
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n2) return;
  const int j = (int)(c / a.ix), i = (int)(c - (long)j * a.ix);
  const int nz = a.nz;
  const T rm = msk(a.rmask, c);
  const T zw0 = a.z_w[c], zw_top = a.z_w[nz * n2 + c];

  // SMOOTH_HBL + time filter (lmd_kpp.F:312-349)
  T hbl = smooth_at(a.HB, j, i, a);
  T bbl = smooth_at(a.HB + n2, j, i, a);
  if (a.masking) {
    hbl = hbl * rm;
    bbl = bbl * rm;
  }
  if (!a.first_step) {
    hbl = T(0.5) * (hbl + a.hbls[c]);
    bbl = T(0.5) * (bbl + a.hbbl[c]);
  }
  a.hbl2[c] = hbl;
  a.hbl2[n2 + c] = bbl;

  // surface-layer shape profile (lmd_kpp.F:361-449)
  T Bo, Bosol, ustar;
  surface_forcing(a, c, j, i, Bo, Bosol, ustar);
  const T ustar3 = ustar * ustar * ustar;
  const T z_bl = zw_top - hbl;
  int kb2 = nz;                              // smallest k in 1..nz-1, z_w > z_bl
  for (int k = nz - 1; k >= 1; --k)
    if (a.z_w[k * n2 + c] > z_bl) kb2 = k;
  const T swk = a.swrf[kb2 * n2 + c], swkm1 = a.swrf[(kb2 - 1) * n2 + c];
  const T zwk = a.z_w[kb2 * n2 + c], zwkm1 = a.z_w[(kb2 - 1) * n2 + c];
  const T bfsfc_bl = swkm1 > T(0)
      ? Bo + Bosol * (T(1) - swkm1 * swk * (zwk - zwkm1)
                      / (swk * (zwk - z_bl) + swkm1 * (z_bl - zwkm1)))
      : Bo + Bosol;
  const T hbl_c = mx(hbl, T(EPS_KPP));
  const T cg = T(a.cg);

  // bottom-layer velocity scale (lmd_kpp.F:452-470)
  const long cu = (long)j * a.ix + wrap(i + 1, a.ix);
  const long cv = (long)wrap(j + 1, a.jy) * a.ix + i;
  const T u0 = a.u[c], su0 = a.u[cu], v0 = a.v[c], sv0 = a.v[cv];
  const T wmb = T(a.vk * a.vk) * xsqrt(T(1.0 / 3.0) * (
      u0 * u0 + su0 * su0 + u0 * su0 + v0 * v0 + sv0 * sv0 + v0 * sv0))
      / xlog(T(1) + T(0.5) * a.hz[c] / T(a.zob));
  const T zob = T(a.zob);
  const bool water = !a.masking || rm > T(0.5);

  for (int k = 0; k <= nz; ++k) {
    const long o = k * n2 + c;
    const T zw = a.z_w[o];
    T kv = a.akv[o], kt = a.akt_t[o], gh = T(0);
    const T ssgm = (zw_top - zw) / hbl_c;
    if (ssgm < T(1)) {
      const T zh = zetahat_of(zw_top - zw, bfsfc_bl, hbl, rm, a);
      const T wm = wm_of(zh, ustar, ustar3, a);
      const T ws = ws_of(zh, ustar, ustar3, a);
      T cff_bl = ssgm < T(0.07) ? T(0.5) * sq(ssgm - T(0.07)) / T(0.07) : T(0);
      cff_bl = cff_bl + ssgm * sq(T(1) - ssgm);
      const T amp = ssgm * ssgm;
      kv = xsqrt(sq(amp * kv) + sq(wm * hbl * cff_bl));
      kt = xsqrt(sq(amp * kt) + sq(ws * hbl * cff_bl));
      if (bfsfc_bl < T(0)) gh = -cg * ssgm * sq(T(1) - ssgm);
    }
    const T sgmb = (zw - zw0 + zob) / (bbl + zob);
    if (sgmb < T(1)) {                       // lmd_kpp.F:470-497
      const T b = sq(wmb * bbl * (sgmb * sq(T(1) - sgmb)));
      kv = xsqrt(kv * kv + b);
      kt = xsqrt(kt * kt + b);
    }
    if (!water) {                            // lmd_kpp.F:500-536
      kv = T(0);
      kt = T(0);
    }
    a.akv[o] = kv;
    a.akt_t[o] = kt;
    if (a.akt_s != nullptr) a.akt_s[o] = kt;
    a.ghat[o] = gh;
  }
}

template <typename T>
int launch(const void* const* p, const int* n, const double* d, void* stream) {
  Args<T> a;
  a.u = (const T*)p[0];
  a.v = (const T*)p[1];
  a.bvf = (const T*)p[2];
  a.z_r = (const T*)p[3];
  a.z_w = (const T*)p[4];
  a.hz = (const T*)p[5];
  a.swrf = (const T*)p[6];
  a.ts_t = (const T*)p[7];
  a.ts_s = (const T*)p[8];
  a.stf_t = (const T*)p[9];
  a.stf_s = (const T*)p[10];
  a.srflx = (const T*)p[11];
  a.sustr = (const T*)p[12];
  a.svstr = (const T*)p[13];
  a.f = (const T*)p[14];
  a.rmask = (const T*)p[15];
  a.umask = (const T*)p[16];
  a.vmask = (const T*)p[17];
  a.hbls = (const T*)p[18];
  a.hbbl = (const T*)p[19];
  a.akv = (T*)p[20];
  a.akt_t = (T*)p[21];
  a.akt_s = (T*)p[22];
  a.ghat = (T*)p[23];
  a.hbl2 = (T*)p[24];
  a.nz = n[0];
  a.jy = n[1];
  a.ix = n[2];
  a.masking = n[3];
  a.salinity = n[4];
  a.nonlin_eos = n[5];
  a.ew_periodic = n[6];
  a.ns_periodic = n[7];
  a.own_w = n[8];
  a.own_e = n[9];
  a.own_s = n[10];
  a.own_n = n[11];
  a.first_step = n[12];
  a.g = d[0];
  a.rho0 = d[1];
  a.vk = d[2];
  a.zob = d[3];
  a.akv_bak = d[4];
  a.akt_bak = d[5];
  a.tcoef = d[6];
  a.scoef = d[7];
  a.cg = d[8];
  a.vtc = d[9];
  const long n2 = (long)a.jy * a.ix;
  a.R = (T*)p[25];
  a.FC = a.R + (a.nz - 1) * n2;
  a.CR = a.FC + (a.nz + 1) * n2;
  a.HB = a.CR + a.nz * n2;

  const dim3 block(128);
  const dim3 grid((unsigned)((n2 + block.x - 1) / block.x));
  cudaStream_t s = (cudaStream_t)stream;
  k_rig<T><<<grid, block, 0, s>>>(a);
  k_column<T><<<grid, block, 0, s>>>(a);
  k_profile<T><<<grid, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// p: u, v, bvf, z_r, z_w, hz, swrf, ts_t, ts_s, stf_t, stf_s, srflx, sustr,
//    svstr, f, rmask, umask, vmask, hbls, hbbl, akv, akt_t, akt_s, ghat,
//    hbl2, scratch ((3*nz + 2) planes of jy*ix).
// n: nz, jy, ix, masking, salinity, nonlin_eos, ew_periodic, ns_periodic,
//    own_w, own_e, own_s, own_n, first_step.
// d: g, rho0, von_karman, zob, akv_bak, akt_bak, |tcoef|, |scoef|, cg, vtc.
extern "C" int roms_kpp_vmix_f32(const void* const* p, const int* n,
                                 const double* d, void* stream) {
  return launch<float>(p, n, d, stream);
}

extern "C" int roms_kpp_vmix_f64(const void* const* p, const int* n,
                                 const double* d, void* stream) {
  return launch<double>(p, n, d, stream);
}

// The vertical-mixing update (lmd_vmix interior coefficients plus both
// lmd_kpp boundary layers) on NVIDIA Hopper (sm_90a): tiles of columns
// with their level planes and FC columns on chip, in two launches.
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
//     layer profile, the land mask and the physical-edge fill of hbls and
//     hbbl.
//
// What bounds it on this card: device-memory bandwidth by bytes (~40
// flops per point and level against ~11 nz-deep fields in and out); in
// practice the latency of each column's serial level loops.  The design:
//
//  * Launch A (k_column), a block per tile of TI x TJ columns with LA
//    lanes of one thread a column, ascending through the levels LA at a
//    time: every level's work but the vertical smoothing is independent
//    of the other levels, so each lane takes one.  At its level a lane
//    computes raw Ri for the tile and a one-cell ring into shared memory,
//    then each u-face flux (fx, then fx2) and v-face flux (fe1, then fe)
//    of the SMOOTH_RIG smoother once, with the face masks loaded once per
//    tile, then each column's smoothed Ri, its raw interior Kv/Kt and its
//    FC increment, into shared memory.  Lane 0 runs the ascending vertical
//    smoothing over the chunk's levels and writes Kv/Kt once into akv and
//    akt[0], while the lanes go on to the next chunk.  The ring is an
//    index map, not a neighbour: a cell holds Ri at the column that
//    fill(wrap(.)) names (kpp._fill_phys_edges_2d after the roll: cols
//    0,1 <- 2 and ix-2, ix-1 <- ix-3 on owned non-periodic edges, rows
//    likewise, after the columns), so it is computed at that source
//    column from u, v, z_r and bvf, and the tile's own edge cells too.
//    Lane 0 then sums the FC increments from the top in the plain
//    version's order; each lane runs the surface search down its levels
//    to its first Cr < 0 (the largest k with Cr < 0 is the largest of
//    the lanes'); lane 0 runs the bottom search from the shared FC column
//    and writes the raw masked hbl/bbl into a (2, jy, ix) plane.
//  * Launch B (k_profile), a block per tile of TI x TJB columns with LZ
//    threads a column.  SMOOTH_HBL of hbl and bbl runs on the tile as in
//    launch A (ring planes at the same index map, each face once), then
//    the time filter; the lanes split the column's other scalars (the
//    surface forcing, the bottom velocity scale), search the levels for
//    the boundary layer's k in parallel, then each takes every LZ-th
//    level of the profiles, which need no other level, with UB levels'
//    loads issued together.  The hbls and hbbl outputs take the value at
//    the fill map's source, so their ghost lines come filled (at a ghost
//    point by indexed loads of the plane, smooth_at).
//
// Every point of the padded grid, the outermost ghost lines included,
// gets the plain version's value (periodic neighbours by index
// arithmetic, the roll semantics of the JAX and plain versions).  Kt goes
// into row 0 of the (n_akt, nz+1, jy, ix) diffusivity, and again into
// row 1 when there is salinity (Ks == Kt without double diffusion).
// Masks read as 1 when masking is off (NULL pointers).
//
// Shared memory of launch A: smem_elems(nz) elements of T, the FC column
// (nz-1 levels of TI*TJ columns) taking most of it: 49,600 B at nz=60 in
// float32.  The launch sizes both kernels' shared memory from nz (the
// wrapper, ops/cuda_kpp.py, caps nz at its NZ_MAX) and allows each that
// much once per device and size.
//
// Entry points: roms_kpp_vmix_f32 / _f64 launch both kernels on the given
// stream and return cudaGetLastError(); roms_kpp_vmix_occupancy reports
// each kernel's threads and shared memory per block, resident blocks per
// SM, registers and stack.  Plain C, bound by ctypes from
// roms_tpu_torch/ops/cuda_kpp.py.

#include <cuda_runtime.h>

#include "kernel_util.cuh"

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

// a tile of TI x TH points of a plane with its one-cell ring: the ring
// cells and the faces of the smoother (see tile_faces)
constexpr int TI = 32;                       // tile width: one warp
constexpr int EW = TI + 2;                   // ring row
template <int TH>
struct Tile {
  static constexpr int NE = EW * (TH + 2);          // ring cells
  static constexpr int NFX = (TH + 2) * (TI + 1);   // fx faces, their umask
  static constexpr int NFE1 = (TH + 1) * (TI + 2);  // fe1 faces, their vmask
  static constexpr int NFX2 = TH * (TI + 1);        // fx2 faces
  static constexpr int NFE = (TH + 1) * TI;         // fe faces
};

// launch A: tiles of TI x TJ columns; LA lanes of NC threads, one level
// each
constexpr int TJ = 4;
constexpr int NC = TI * TJ;                  // columns of a tile
constexpr int LA = 4;                        // levels in flight
constexpr int NTA = NC * LA;                 // threads of a block
constexpr int NE = Tile<TJ>::NE;
constexpr int NFX = Tile<TJ>::NFX;
constexpr int NFE1 = Tile<TJ>::NFE1;
// a lane's level: ring plane and the four face fluxes
constexpr int LS = NE + NFX + NFE1 + Tile<TJ>::NFX2 + Tile<TJ>::NFE;
constexpr int NRC = (NE + NC - 1) / NC;      // ring cells a thread

// launch B: tiles of TI x TJB columns, LZ threads a column
constexpr int TJB = 2;
constexpr int LZ = 4;
constexpr int NCB = TI * TJB;
constexpr int NTB = NCB * LZ;                // threads of a block
constexpr int UB = 8;                        // levels a lane loads at once

// launch B's dynamic shared memory: the tile's z_w columns
__host__ __device__ constexpr int smem_b_elems(int nz) {
  return (nz + 1) * NCB;
}

__host__ __device__ constexpr int smem_elems(int nz) {
  return NFX + NFE1 + LA * LS + 2 * LA * NC + (nz - 1) * NC;
}

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
  // outputs: akt_s NULL without salinity; hbls_out, hbbl_out with their
  // ghost lines filled
  T *akv, *akt_t, *akt_s, *ghat, *hbls_out, *hbbl_out;
  // between the launches: HB (2, jy, ix) raw masked hbl/bbl
  T* HB;
  int nz, jy, ix;
  int masking, salinity, nonlin_eos, ew_periodic, ns_periodic;
  int own_w, own_e, own_s, own_n, first_step;
  double g, rho0, vk, zob, akv_bak, akt_bak, tcoef, scoef, cg, vtc;
};

// i within one period either side of [0, n)
__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// any i into [0, n)
__device__ __forceinline__ int modn(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
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
// the edge-filled plane w at (j, i), without the final rmask, by indexed
// loads: launch B's SMOOTH_HBL at a ghost point's fill-map source.
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

// ------------------------------------------------- the smoother on a tile
// A plane's tile of TI x TH points at (j0, i0) with its one-cell ring in
// shared memory: W[y * EW + x] at (j0-1+y, i0-1+x); MU the umask at the
// fx faces, MU[y * (TI+1) + x] at (j0-1+y, i0+x); MV the vmask at the fe1
// faces, MV[y * (TI+2) + x] at (j0+y, i0-1+x), masks wrapped.  Threads
// t = 0..nt-1 share the work; each face flux is computed once.
template <int TH, typename T>
__device__ void tile_masks(const Args<T>& a, int j0, int i0, T* MU, T* MV,
                           int t, int nt) {
  for (int q = t; q < Tile<TH>::NFX; q += nt)
    MU[q] = msk(a.umask, (long)modn(j0 - 1 + q / (TI + 1), a.jy) * a.ix
                             + modn(i0 + q % (TI + 1), a.ix));
  for (int q = t; q < Tile<TH>::NFE1; q += nt)
    MV[q] = msk(a.vmask, (long)modn(j0 + q / (TI + 2), a.jy) * a.ix
                             + modn(i0 - 1 + q % (TI + 2), a.ix));
}

// step 1 of the smoother: fx = (w - w[i-1]) * umask, fe1 = (w - w[j-1]) *
// vmask (kpp._smooth2d)
template <int TH, typename T>
__device__ void tile_faces1(const T* W, const T* MU, const T* MV, T* FX,
                            T* FE1, int t, int nt) {
  for (int q = t; q < Tile<TH>::NFX; q += nt) {
    const int y = q / (TI + 1), x = q % (TI + 1);
    FX[q] = (W[y * EW + x + 1] - W[y * EW + x]) * MU[q];
  }
  for (int q = t; q < Tile<TH>::NFE1; q += nt) {
    const int y = q / (TI + 2), x = q % (TI + 2);
    FE1[q] = (W[(y + 1) * EW + x] - W[y * EW + x]) * MV[q];
  }
}

// step 2: fx2 and fe at (j0+y, i0+x)
template <int TH, typename T>
__device__ void tile_faces2(const T* FX, const T* FE1, T* FX2, T* FE, int t,
                            int nt) {
  const T cff = T(1.0 / 12.0);
  for (int q = t; q < Tile<TH>::NFX2; q += nt) {
    const int y = q / (TI + 1), x = q % (TI + 1);
    const T* e1 = FE1 + y * (TI + 2) + x;            // FE1(j, i-1)
    FX2[q] = FX[(y + 1) * (TI + 1) + x]
             + cff * (e1[TI + 2 + 1] + e1[0] - e1[1] - e1[TI + 2]);
  }
  for (int q = t; q < Tile<TH>::NFE; q += nt) {
    const int y = q / TI, x = q % TI;
    const T* f0 = FX + y * (TI + 1) + x;             // FX(j-1, i)
    FE[q] = FE1[y * (TI + 2) + x + 1]
            + cff * (f0[TI + 1 + 1] + f0[0] - f0[TI + 1] - f0[1]);
  }
}

// step 3: the smoothed value at (j0+tj, i0+ti), without the final rmask
template <int TH, typename T>
__device__ __forceinline__ T tile_smoothed(T w_own, const T* FX2,
                                           const T* FE, int tj, int ti) {
  return w_own + T(3.0 / 16.0) * (FX2[tj * (TI + 1) + ti + 1]
                                  - FX2[tj * (TI + 1) + ti]
                                  + FE[(tj + 1) * TI + ti] - FE[tj * TI + ti]);
}

// ---------------------------------------------------------------- launch A
template <typename T>
__global__ void __launch_bounds__(NTA, 2) k_column(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sMU = reinterpret_cast<T*>(smem_raw);  // umask at the fx faces
  T* const sMV = sMU + NFX;                        // vmask at the fe1 faces
  const int tid = threadIdx.x;
  const int l = tid / NC, q0 = tid % NC;           // lane, column of tile
  const int ti = q0 % TI, tj = q0 / TI;
  T* const sW = sMV + NFE1 + l * LS;               // this lane's level
  T* const sFX = sW + NE;
  T* const sFE1 = sFX + NFX;
  T* const sFX2 = sFE1 + NFE1;
  T* const sFE = sFX2 + Tile<TJ>::NFX2;
  T* const sKV = sMV + NFE1 + LA * LS;             // [lane][column] raw Kv
  T* const sKT = sKV + LA * NC;                    //               raw Kt
  T* const sFC = sKT + LA * NC;                    // [k-1][column]
  int* const sK = reinterpret_cast<int*>(sKV);     // after the sweep

  const int i0 = blockIdx.x * TI, j0 = blockIdx.y * TJ;
  const int jy = a.jy, ix = a.ix, nz = a.nz;
  const long n2 = (long)jy * ix;
  const int i = i0 + ti, j = j0 + tj;
  const bool valid = i < ix && j < jy;

  tile_masks<TJ>(a, j0, i0, sMU, sMV, tid, NTA);   // once per tile

  // ring cell e at (j0-1+e/EW, i0-1+e%EW) holds Ri at its fill-map source
  // (sj, si): offsets of that column, of its east u and its north v
  int so[NRC], se[NRC], sn[NRC];
#pragma unroll
  for (int r = 0; r < NRC; ++r) {
    const int e = q0 + r * NC;
    const int sj = fill_j(modn(j0 - 1 + e / EW, jy), a);
    const int si = fill_i(modn(i0 - 1 + e % EW, ix), a);
    so[r] = sj * ix + si;
    se[r] = sj * ix + wrap(si + 1, ix);
    sn[r] = wrap(sj + 1, jy) * ix + si;
  }

  const long c = valid ? (long)j * ix + i : 0;
  const long cu = valid ? (long)j * ix + wrap(i + 1, ix) : 0;
  const long cv = valid ? (long)wrap(j + 1, jy) * ix + i : 0;
  T zw0 = T(0), zw_top = T(0), hbl = T(0), bbl = T(0), f2 = T(0), rm = T(1);
  if (valid) {
    zw0 = a.z_w[c];
    zw_top = a.z_w[nz * n2 + c];
    hbl = a.hbls[c];
    bbl = a.hbbl[c];
    f2 = a.f[c] * a.f[c];
    rm = msk(a.rmask, c);
  }
  const T eh = sq(T(EPSSFC) * hbl), eb = sq(T(EPSSFC) * bbl);
  const T bv = T(a.akv_bak), bt = T(a.akt_bak);
  T rv = T(0), rt = T(0), pv = T(0), pt = T(0), bvf1 = T(0);

  // the ascending in-place vertical smoothing + background
  // (lmd_vmix.F:396-404), run by lane 0 over the raw levels m0..m0+LA-1
  // of a chunk: level m from the smoothed m-1 and the raw m and m+1
  auto smooth_chunk = [&](int m0) {
    if (l != 0 || !valid || m0 < 0) return;
    for (int d = 0; d < LA && m0 + d < nz - 1; ++d) {
      const int m = m0 + d;
      const T kv3 = sKV[d * NC + q0], kt3 = sKT[d * NC + q0];
      if (m == 0) {
        pv = kv3 + bv;                                // bottom pad
        pt = kt3 + bt;
      } else {
        pv = T(0.5) * rv + T(0.25) * pv + T(0.25) * kv3 + bv;
        pt = T(0.5) * rt + T(0.25) * pt + T(0.25) * kt3 + bt;
      }
      a.akv[(long)m * n2 + c] = pv;
      a.akt_t[(long)m * n2 + c] = pt;
      rv = kv3;
      rt = kt3;
    }
  };

  // the interior levels in chunks of LA, lane l at raw level m = m0 + l
  // (W level k = m + 1)
  for (int m0 = 0; m0 < nz - 1; m0 += LA) {
    const int m = m0 + l, k = m + 1;
    const bool act = m < nz - 1;
    const long o = (long)k * n2, om = o - n2;
    // 1. raw Ri of the ring plane at level k, from levels k and k-1
    if (act) {
#pragma unroll
      for (int r = 0; r < NRC; ++r) {
        const int e = q0 + r * NC;
        if (e < NE) {
          const int o1 = so[r], oe = se[r], on = sn[r];
          const T cffz = T(0.5) / (a.z_r[o + o1] - a.z_r[om + o1]);
          const T dudz = cffz * (a.u[o + o1] - a.u[om + o1] + a.u[o + oe]
                                 - a.u[om + oe]);
          const T dvdz = cffz * (a.v[o + o1] - a.v[om + o1] + a.v[o + on]
                                 - a.v[om + on]);
          sW[e] = a.bvf[o + o1] / (T(RI0) * mx(dudz * dudz + dvdz * dvdz,
                                               T(1.0e-10)));
        }
      }
    }
    // the column's own loads at k and k-1, used after the barriers
    T u_c = T(0), u_e = T(0), v_c = T(0), v_n = T(0), hz_k = T(0);
    T zw_k = T(0), bvf_k = T(0), um_c = T(0), um_e = T(0), vm_c = T(0);
    T vm_n = T(0), hz_m = T(0);
    if (act && valid) {
      u_c = a.u[o + c];
      u_e = a.u[o + cu];
      v_c = a.v[o + c];
      v_n = a.v[o + cv];
      hz_k = a.hz[o + c];
      zw_k = a.z_w[o + c];
      bvf_k = a.bvf[o + c];
      um_c = a.u[om + c];
      um_e = a.u[om + cu];
      vm_c = a.v[om + c];
      vm_n = a.v[om + cv];
      hz_m = a.hz[om + c];
    }
    __syncthreads();
    // the column's own raw Ri (the next chunk's step 1 may overwrite sW
    // before this thread's step 4)
    const T w_own = sW[(tj + 1) * EW + ti + 1];
    smooth_chunk(m0 - LA);
    // 2. fx and fe1 faces of this lane's level, each once
    if (act) tile_faces1<TJ>(sW, sMU, sMV, sFX, sFE1, q0, NC);
    __syncthreads();
    // 3. fx2 and fe faces
    if (act) tile_faces2<TJ>(sFX, sFE1, sFX2, sFE, q0, NC);
    __syncthreads();
    // 4. the column at level k: interior Kv/Kt before the vertical
    // smoothing, and the FC increment (lmd_kpp.F:202-236)
    if (act && valid) {
      const T rig = tile_smoothed<TJ>(w_own, sFX2, sFE, tj, ti);
      const T cffr = mn(T(1), mx(T(0), rig));
      const T nu = T(1) - cffr * cffr;
      const T nu_sx = nu * nu * nu;
      T kv3 = T(NUWM) + T(NU0M) * nu_sx;
      T kt3 = T(NUWS) + T(NU0S) * nu_sx;
      if (rig < T(0)) {                               // LMD_CONVEC
        kv3 = kv3 + T(NU0C);
        kt3 = kt3 + T(NU0C);
      }
      const T dist = zw_k - zw0;                      // bottom suppression
      const T mult = dist < T(LTURB) ? xsin(T(0.5 * PI) * dist / T(LTURB)) : T(1);
      sKV[l * NC + q0] = kv3 * mult;
      sKT[l * NC + q0] = kt3 * mult;

      const T ur_hi = T(0.5) * (u_c + u_e), vr_hi = T(0.5) * (v_c + v_n);
      const T ur_lo = T(0.5) * (um_c + um_e), vr_lo = T(0.5) * (vm_c + vm_n);
      const T du2 = sq(T(2) * (ur_hi - ur_lo)) + sq(T(2) * (vr_hi - vr_lo));
      const T hz2 = hz_k + hz_m;
      const T cff_up = sq(zw_top - zw_k), cff_dn = sq(zw_k - zw0);
      const T kern = cff_up * cff_dn / ((cff_up + eh) * (cff_dn + eb));
      sFC[m * NC + q0] = kern * (T(0.5) * du2 / hz2
                                 - T(0.5) * hz2 * (T(RI_INV) * bvf_k
                                                   + T(C_EK) * f2));
      if (m == 0) bvf1 = bvf_k;
    }
  }
  __syncthreads();

  // lane 0: the last chunk, the top pad (raw nz-1 + background), and FC
  // from the top in the plain version's order (FC[nz] = 0)
  smooth_chunk(((nz - 2) / LA) * LA);
  if (l == 0 && valid) {
    const T nv = rv + bv, nt = rt + bt;
    pv = T(0.5) * rv + T(0.25) * pv + T(0.25) * nv + bv;
    pt = T(0.5) * rt + T(0.25) * pt + T(0.25) * nt + bt;
    a.akv[(long)(nz - 1) * n2 + c] = pv;
    a.akt_t[(long)(nz - 1) * n2 + c] = pt;
    a.akv[(long)nz * n2 + c] = nv;
    a.akt_t[(long)nz * n2 + c] = nt;
    T acc = T(0);
    for (int k = nz - 1; k >= 1; --k) {
      acc = acc + sFC[(k - 1) * NC + q0];
      sFC[(k - 1) * NC + q0] = acc;
    }
  }
  __syncthreads();

  // surface boundary layer depth (lmd_kpp.F:238-275): Cr at k = 1..nz;
  // each lane walks its levels k = nz-l, nz-l-LA, .. down to its first
  // Cr < 0, the largest k of the lane with Cr < 0
  T Bo = T(0), Bosol = T(0), ustar = T(0);
  if (valid) surface_forcing(a, c, j, i, Bo, Bosol, ustar);
  const T ustar3 = ustar * ustar * ustar;
  const T vt = T(1.8 * a.vtc);
  auto fc = [&](int k) { return k < nz ? sFC[(k - 1) * NC + q0] : T(0); };
  auto cr_at = [&](int k) {
    const long o = (long)(k - 1) * n2 + c;            // rho level k-1
    const T swdk = xsqrt(a.swrf[o + n2] * a.swrf[o]);
    const T bfsfc = Bo + Bosol * (T(1) - swdk);
    const T ws = ws_of(zetahat_of(zw_top - a.z_r[o], bfsfc, hbl, rm, a),
                       ustar, ustar3, a);
    const T vtsq = vt * ws * xsqrt(mx(T(1.0e-5), a.bvf[o]));
    return fc(k) + vtsq;
  };
  int kl = 0;
  if (valid)
    for (int k = nz - l; k >= 1; k -= LA)
      if (cr_at(k) < T(0)) {
        kl = k;
        break;
      }
  sK[l * NC + q0] = kl;
  __syncthreads();
  if (l != 0 || !valid) return;          // no barrier below
  int kbls = sK[q0];
#pragma unroll
  for (int d = 1; d < LA; ++d) kbls = max(kbls, sK[d * NC + q0]);
  T hbl_new;
  if (kbls == 0) {
    hbl_new = zw_top - zw0;
  } else if (kbls == nz) {
    hbl_new = zw_top - a.z_r[(long)(nz - 1) * n2 + c];
  } else {                         // interpolate between z_r(k) and z_r(k+1)
    const T cr_k = cr_at(kbls), cr_k1 = cr_at(kbls + 1);
    const T zr_k = a.z_r[(long)(kbls - 1) * n2 + c];
    const T zr_k1 = a.z_r[(long)kbls * n2 + c];
    hbl_new = zw_top - (zr_k * cr_k1 - zr_k1 * cr_k) / (cr_k1 - cr_k);
  }
  if (a.masking) hbl_new = hbl_new * rm;

  // bottom boundary layer depth (lmd_kpp.F:277-302): smallest k with
  // FC[k] - fc0 > 0
  const T hz0 = a.hz[c];
  const T ur0 = T(0.5) * (a.u[c] + a.u[cu]), vr0 = T(0.5) * (a.v[c] + a.v[cv]);
  const T z_bl0 = zw0 + T(0.25) * hz0;
  const T cu0 = sq(zw_top - z_bl0), cd0 = sq(z_bl0 - zw0);
  const T kern0 = cu0 * cd0 / ((cu0 + eh) * (cd0 + eb));
  const T fc0 = fc(1) + kern0 * (
      T(0.5) * (sq(T(2) * ur0) + sq(T(2) * vr0)) / hz0
      - T(0.5) * hz0 * (T(RI_INV) * bvf1 + T(C_EK) * f2));
  int kbbl = nz + 1;
  for (int k = 1; k <= nz; ++k)
    if (fc(k) - fc0 > T(0)) {
      kbbl = k;
      break;
    }
  T bbl_new;
  if (kbbl == nz + 1) {
    bbl_new = zw_top - zw0;
  } else if (kbbl == 1) {
    bbl_new = a.z_r[c] - zw0;
  } else {
    const T crb_k = fc(kbbl) - fc0, crb_km1 = fc(kbbl - 1) - fc0;
    const T zr_km1 = a.z_r[(long)(kbbl - 2) * n2 + c];
    const T zr_kk = a.z_r[(long)(kbbl - 1) * n2 + c];
    bbl_new = (zr_km1 * crb_k - zr_kk * crb_km1) / (crb_k - crb_km1) - zw0;
  }
  if (a.masking) bbl_new = bbl_new * rm;
  a.HB[c] = hbl_new;
  a.HB[n2 + c] = bbl_new;
}

// ---------------------------------------------------------------- launch B
// the land mask and the time filter of SMOOTH_HBL's value h of plane p
// (0: hbl, 1: bbl) at column c (lmd_kpp.F:312-349)
template <typename T>
__device__ __forceinline__ T filter_hb(const Args<T>& a, int p, long c, T h) {
  if (a.masking) h = h * msk(a.rmask, c);
  if (!a.first_step) h = T(0.5) * (h + (p == 0 ? a.hbls : a.hbbl)[c]);
  return h;
}

template <typename T>
__global__ void __launch_bounds__(NTB) k_profile(Args<T> a) {
  using TB = Tile<TJB>;
  __shared__ T sS[6][NCB];     // hbl, bbl, Bo, Bosol, ustar, wmb
  __shared__ int sK[LZ][NCB];
  // SMOOTH_HBL of hbl and bbl (plane p = 0, 1) on the tile
  __shared__ T sW[2][TB::NE], sMU[TB::NFX], sMV[TB::NFE1];
  __shared__ T sFX[2][TB::NFX], sFE1[2][TB::NFE1];
  __shared__ T sFX2[2][TB::NFX2], sFE[2][TB::NFE];
  const int x = threadIdx.x, y = threadIdx.y, z = threadIdx.z;
  const int q = y * TI + x, t = z * NCB + q;
  const int i0 = blockIdx.x * TI, j0 = blockIdx.y * TJB;
  const int i = i0 + x, j = j0 + y;
  const bool valid = i < a.ix && j < a.jy;
  const int nz = a.nz;
  const long n2 = (long)a.jy * a.ix;
  const long c = valid ? (long)j * a.ix + i : 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sZW = reinterpret_cast<T*>(smem_raw);   // [k][column] z_w

  // the tile's z_w columns into shared memory, in flight during step 1
  for (int e = t; e < smem_b_elems(nz); e += NTB) {
    const int k = e / NCB, ie = i0 + e % TI, je = j0 + e % NCB / TI;
    if (ie < a.ix && je < a.jy)
      cp_async(sZW + e, a.z_w + (long)k * n2 + (long)je * a.ix + ie);
  }
  cp_async_commit();

  // 1. the column's scalars: the smoother's ring planes of the raw hbl and
  // bbl at the fill map's sources (as in launch A), its faces; the lanes
  // 2 and 3 meanwhile take the surface forcing and the bottom velocity
  // scale
  for (int e = t; e < 2 * TB::NE; e += NTB) {
    const int p = e / TB::NE, r = e % TB::NE;
    const int sj = fill_j(modn(j0 - 1 + r / EW, a.jy), a);
    const int si = fill_i(modn(i0 - 1 + r % EW, a.ix), a);
    sW[p][r] = a.HB[p * n2 + (long)sj * a.ix + si];
  }
  tile_masks<TJB>(a, j0, i0, sMU, sMV, t, NTB);
  if (valid) {
    if (z == 2) {
      surface_forcing(a, c, j, i, sS[2][q], sS[3][q], sS[4][q]);
    } else if (z == 3) {             // bottom-layer velocity scale
      const long cu = (long)j * a.ix + wrap(i + 1, a.ix);
      const long cv = (long)wrap(j + 1, a.jy) * a.ix + i;
      const T u0 = a.u[c], su0 = a.u[cu], v0 = a.v[c], sv0 = a.v[cv];
      sS[5][q] = T(a.vk * a.vk) * xsqrt(T(1.0 / 3.0) * (
          u0 * u0 + su0 * su0 + u0 * su0 + v0 * v0 + sv0 * sv0 + v0 * sv0))
          / xlog(T(1) + T(0.5) * a.hz[c] / T(a.zob));
    }
  }
  __syncthreads();
  if (z < 2) tile_faces1<TJB>(sW[z], sMU, sMV, sFX[z], sFE1[z], q, NCB);
  __syncthreads();
  if (z < 2) tile_faces2<TJB>(sFX[z], sFE1[z], sFX2[z], sFE[z], q, NCB);
  __syncthreads();
  if (valid && z < 2) {        // SMOOTH_HBL + time filter
    const T h = filter_hb(a, z, c, tile_smoothed<TJB>(
        sW[z][(y + 1) * EW + x + 1], sFX2[z], sFE[z], y, x));
    sS[z][q] = h;
    // hbls/hbbl with their physical-edge ghost lines filled
    // (lmd_kpp.F:545-581): the value at the fill map's source
    const int fj = fill_j(j, a), fi = fill_i(i, a);
    (z == 0 ? a.hbls_out : a.hbbl_out)[c] =
        (fj == j && fi == i) ? h
        : filter_hb(a, z, (long)fj * a.ix + fi,
                    smooth_at(a.HB + z * n2, fj, fi, a));
  }
  cp_async_wait<0>();
  __syncthreads();
  const T hbl = sS[0][q], bbl = sS[1][q];
  const T zw0 = sZW[q], zw_top = sZW[nz * NCB + q];
  const T z_bl = zw_top - hbl;

  // 2. smallest k in 1..nz-1 with z_w > z_bl, else nz, over the lanes
  int kmin = nz;
  if (valid)
    for (int k = 1 + z; k < nz; k += LZ)
      if (sZW[k * NCB + q] > z_bl) {
        kmin = k;
        break;
      }
  sK[z][q] = kmin;
  __syncthreads();
  if (!valid) return;                // no barrier below
  int kb2 = sK[0][q];
#pragma unroll
  for (int l = 1; l < LZ; ++l) kb2 = min(kb2, sK[l][q]);

  // surface-layer shape profile (lmd_kpp.F:361-449)
  const T Bo = sS[2][q], Bosol = sS[3][q], ustar = sS[4][q], wmb = sS[5][q];
  const T ustar3 = ustar * ustar * ustar;
  const T swk = a.swrf[(long)kb2 * n2 + c];
  const T swkm1 = a.swrf[(long)(kb2 - 1) * n2 + c];
  const T zwk = sZW[kb2 * NCB + q], zwkm1 = sZW[(kb2 - 1) * NCB + q];
  const T bfsfc_bl = swkm1 > T(0)
      ? Bo + Bosol * (T(1) - swkm1 * swk * (zwk - zwkm1)
                      / (swk * (zwk - z_bl) + swkm1 * (z_bl - zwkm1)))
      : Bo + Bosol;
  const T hbl_c = mx(hbl, T(EPS_KPP));
  const T cg = T(a.cg);
  const T zob = T(a.zob);
  const T rm = msk(a.rmask, c);
  const bool water = !a.masking || rm > T(0.5);

  // 3. every LZ-th level: interior coefficients -> profiles, UB levels'
  // loads issued together
  for (int k0 = z; k0 <= nz; k0 += UB * LZ) {
    T kvu[UB], ktu[UB];
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const long o = (long)(k0 + u * LZ) * n2 + c;
      if (k0 + u * LZ <= nz) {
        kvu[u] = a.akv[o];
        ktu[u] = a.akt_t[o];
      }
    }
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      if (k0 + u * LZ > nz) break;
      const long o = (long)(k0 + u * LZ) * n2 + c;
      const T zw = sZW[(k0 + u * LZ) * NCB + q];
      T kv = kvu[u], kt = ktu[u], gh = T(0);
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
}

template <typename T>
int smem_a(int nz) { return smem_elems(nz) * (int)sizeof(T); }
template <typename T>
int smem_b(int nz) { return smem_b_elems(nz) * (int)sizeof(T); }

// both kernels with their dynamic shared memory allowed for nz; false if
// refused
template <typename T>
bool prepared(int nz) {
  static int allowed_a[64] = {}, allowed_b[64] = {};
  return nz >= 2
      && allow_smem((const void*)k_column<T>, smem_a<T>(nz), allowed_a)
      && allow_smem((const void*)k_profile<T>, smem_b<T>(nz), allowed_b);
}

template <typename T>
int launch(const void* const* p, const int* n, const double* d, void* stream) {
  Args<T> a;
  const int nz = n[0], jy = n[1], ix = n[2];
  const long n2 = (long)jy * ix;
  const int itemp = n[13], isalt = n[14];
  const int salinity = n[4];
  const T* const t = (const T*)p[7];         // (nt, nz, jy, ix)
  const T* const stflx = (const T*)p[8];     // (nt, jy, ix)
  T* const akt = (T*)p[19];                  // (n_akt, nz+1, jy, ix)
  a.u = (const T*)p[0];
  a.v = (const T*)p[1];
  a.bvf = (const T*)p[2];
  a.z_r = (const T*)p[3];
  a.z_w = (const T*)p[4];
  a.hz = (const T*)p[5];
  a.swrf = (const T*)p[6];
  a.ts_t = t + ((long)itemp * nz + nz - 1) * n2;     // surface T and S
  a.ts_s = salinity ? t + ((long)isalt * nz + nz - 1) * n2 : nullptr;
  a.stf_t = stflx + itemp * n2;
  a.stf_s = salinity ? stflx + isalt * n2 : nullptr;
  a.srflx = (const T*)p[9];
  a.sustr = (const T*)p[10];
  a.svstr = (const T*)p[11];
  a.f = (const T*)p[12];
  a.rmask = (const T*)p[13];
  a.umask = (const T*)p[14];
  a.vmask = (const T*)p[15];
  a.hbls = (const T*)p[16];
  a.hbbl = (const T*)p[17];
  a.akv = (T*)p[18];
  a.akt_t = akt;
  a.akt_s = salinity ? akt + (nz + 1) * n2 : nullptr;
  a.ghat = (T*)p[20];
  a.hbls_out = (T*)p[21];
  a.hbbl_out = (T*)p[22];
  a.HB = (T*)p[23];
  a.nz = nz;
  a.jy = jy;
  a.ix = ix;
  a.masking = n[3];
  a.salinity = salinity;
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
  if (!prepared<T>(nz)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  k_column<T><<<dim3((ix + TI - 1) / TI, (jy + TJ - 1) / TJ), NTA,
                smem_a<T>(nz), s>>>(a);
  k_profile<T><<<dim3((ix + TI - 1) / TI, (jy + TJB - 1) / TJB),
                 dim3(TI, TJB, LZ), smem_b<T>(nz), s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int nz, int* out) {
  if (!prepared<T>(nz)) return (int)cudaErrorInvalidValue;
  const void* ks[2] = {(const void*)k_column<T>, (const void*)k_profile<T>};
  const int threads[2] = {NTA, NTB};
  const int shared[2] = {smem_a<T>(nz), smem_b<T>(nz)};
  for (int q = 0; q < 2; ++q) {
    int* o = out + 5 * q;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, ks[q]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &o[2], ks[q], threads[q], shared[q]);
    if (err != cudaSuccess) return (int)err;
    o[0] = threads[q];
    o[1] = shared[q];
    o[3] = attr.numRegs;
    o[4] = (int)attr.localSizeBytes;
  }
  return 0;
}

}  // namespace

// p: u, v, bvf, z_r, z_w, hz, swrf, t (nt, nz, jy, ix), stflx (nt, jy, ix),
//    srflx, sustr, svstr, f, rmask, umask, vmask, hbls, hbbl, akv,
//    akt (n_akt, nz+1, jy, ix), ghat, hbls_out, hbbl_out, HB (the
//    (2, jy, ix) plane between the launches); masks NULL without masking.
// n: nz, jy, ix, masking, salinity, nonlin_eos, ew_periodic, ns_periodic,
//    own_w, own_e, own_s, own_n, first_step, itemp, isalt.
// d: g, rho0, von_karman, zob, akv_bak, akt_bak, |tcoef|, |scoef|, cg, vtc.
extern "C" int roms_kpp_vmix_f32(const void* const* p, const int* n,
                                 const double* d, void* stream) {
  return launch<float>(p, n, d, stream);
}

extern "C" int roms_kpp_vmix_f64(const void* const* p, const int* n,
                                 const double* d, void* stream) {
  return launch<double>(p, n, d, stream);
}

// Both kernels' launch configurations for (f64, nz) on the current device:
// threads and shared-memory bytes per block, resident blocks per SM,
// registers and stack bytes per thread, of launch A into out[0..4] and of
// launch B into out[5..9].
extern "C" int roms_kpp_vmix_occupancy(int f64, int nz, int* out) {
  return f64 ? occupancy<double>(nz, out) : occupancy<float>(nz, out);
}

// The 3D momentum r.h.s. of one stage on NVIDIA Hopper (sm_90a): the
// Coriolis term, horizontal momentum advection and SPLINE_UV vertical
// momentum advection of u and v, in one launch that reads each input once
// and writes ru and rv once.
//
// Replaces no TPU kernel: the JAX package leaves this chain
// (roms_tpu/stepper.py:_uv_rhs) to XLA's fusion.  On the card the port's
// plain chain (ops/advection.py: coriolis_rhs, horiz_uv_adv_rhs and two
// vert_uv_rhs_spline) issued about 2,100 launches a call, a Python loop of
// 2D operations over the levels among them, and some 800 passes over
// whole (nz, jy, ix) arrays, rolls and edge-fix copies included.  The
// kernel follows src/compute_horiz_rhs_uv_terms.h and
// src/compute_vert_rhs_uv_terms.h as the plain version does, operation by
// operation:
//
//   ru = [Coriolis + CURVGRID metric] + [-(UFx - UFx(i-1)) - (UFe(j+1) - UFe)]
//        + [-(FC(k+1) - FC(k))],   FC = spline interface of u * Wavg,
//
// and rv alike, with the fluxes of CENTERED4 or UPSTREAM3 (AKIMA advects
// momentum as CENTERED4), the non-periodic edge rewrites of the second
// differences (fix_we / fix_ns) gated on the four ownership flags, the
// masked or unmasked stagger of We, and zero top and bottom fluxes.
//
// What bounds it on this card: by bytes, device memory (u, v, flx_u, flx_v
// and Hz read once, We once, a few 2D fields, ru and rv written: 0.87 GB
// at 920x480x60 in float32, 0.26 ms).  The design:
//
//  * Two threads a column: half 0 computes ru at the column's u-point,
//    half 1 rv at its v-point.  A half's arithmetic is the other's with
//    the axes exchanged (its own axis A: x for u, y for v; the other B),
//    so both run one code on per-thread offsets along A and B.
//  * Two sweeps a column, no barrier.  Sweep A (up) runs the spline's
//    forward elimination of the half's component with the staggered
//    heights and keeps cf and fc of every level in shared memory, laid out
//    [level][thread] (a warp's accesses fall in distinct banks).  Sweep B
//    (down) finishes the back substitution level by level, computes the
//    level's horizontal fluxes and Coriolis term from the neighbours it
//    reads, and writes the level of ru or rv.  A thread reads only its own
//    shared memory, so the block never synchronises; the wrapper picks the
//    tile rows per (type, nz) to keep the most threads resident
//    (ops/cuda_uv_rhs.py:launch_plan) and caps nz.
//  * Neighbours from the read-only cache.  A level's stencil (three cells
//    each way along A for the second differences and their edge rewrites,
//    and along B) is read through L1 with offsets fixed per thread; the
//    tile's threads share those lines, so device memory sees each input
//    about once a sweep (Hz, u and v twice: both sweeps read them).
//    Offsets wrap, (j + dj) mod jy and (i + di) mod ix: the roll semantics
//    of `shift`, ghost lines included.  The edge rewrites move a second
//    difference one cell along its axis; the per-thread shifts are fixed
//    before the sweeps.
//
// Entry points (the form of kernel_util.cuh): roms_uv_rhs_f32 / _f64
// launch on the given stream and return cudaGetLastError();
// roms_uv_rhs_occupancy reports a launch configuration.  Plain C, bound by
// ctypes through roms_tpu_torch/ops/_build.py.

#include <cuda_runtime.h>

#include "kernel_util.cuh"

namespace {

constexpr double DELTA_UV = 0.1666666666666667;  // pre_step3d4S.F:84
constexpr double GAMMA_UV = 0.3333333333333333;  // pre_step3d4S.F:86
constexpr int TI = 32;        // tile width along i: one warp a half row

// the most threads a block may have: 448 leaves float 144 registers a
// thread and 14 warps an SM (shared memory holds no more at nz = 60);
// double 255 registers
template <typename T>
struct Bounds {
  static constexpr int threads = sizeof(T) == 4 ? 448 : 256;
};

template <typename T>
struct Args {
  const T *u, *v, *flx_u, *flx_v, *hz, *we;
  const T *fomn, *dndx, *dmde, *umask, *vmask;
  T *ru, *rv;
  int nz, jy, ix;
  int cor, curv, adv, masking;
  int ew_periodic, ns_periodic, own_w, own_e, own_s, own_n;
};

// shared memory of one block of tj tile rows: cf and fc of nz levels for
// each of its 2 * TI * tj threads (ops/cuda_uv_rhs.py:smem_bytes mirrors
// it; the launch refuses a size that differs)
inline long smem_bytes(int tj, int nz, int es) {
  return 2L * nz * 2 * TI * tj * es;
}

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

template <typename T>
__device__ __forceinline__ T pos(T a) { return a > T(0) ? a : T(0); }

template <typename T>
__device__ __forceinline__ T neg(T a) { return a < T(0) ? a : T(0); }

// 1 / x, correctly rounded: the value of the division T(1) / x
__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }

// the edge-rewritten second difference at position c (-1, 0, 1) from the
// differences d[0..4] at -2..2: d[c + s] for the position's shift s
template <typename T>
__device__ __forceinline__ T fixed(const T* d, int c, int s) {
  return s > 0 ? d[c + 3] : (s < 0 ? d[c + 1] : d[c + 2]);
}

// the shift of a second difference at grid index p along an axis of n
// points: +1 where the low edge's rewrite (lo_dst <- lo_dst + 1) applies,
// -1 where the high edge's (n - 2 <- n - 3) does
__device__ __forceinline__ int edge_shift(int p, int n, bool periodic,
                                          bool own_lo, bool own_hi,
                                          int lo_dst) {
  if (periodic) return 0;
  if (own_lo && p == lo_dst) return 1;
  if (own_hi && p == n - 2) return -1;
  return 0;
}

// The second difference (d[-1] - 2 d[0]) + d[1] of s[0..6] (offsets -3..3)
// at -2..2.
template <typename T>
__device__ __forceinline__ void second_diffs(const T* s, T* d) {
#pragma unroll
  for (int c = 0; c < 5; ++c) d[c] = (s[c] - T(2) * s[c + 1]) + s[c + 2];
}

template <bool UP3, typename T>
__global__ void __launch_bounds__(Bounds<T>::threads)
uv_rhs_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ix = a.ix, jy = a.jy, nz = a.nz;
  const int i = blockIdx.x * TI + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ix || j >= jy) return;
  // half 0: ru at the u-point (j, i), axis A = x; half 1: rv, A = y
  const int h = threadIdx.z;
  const int nthr = TI * blockDim.y * 2;
  const int tid = threadIdx.x + TI * (threadIdx.y + blockDim.y * h);
  T* CF = reinterpret_cast<T*>(smem_raw) + tid;
  T* FC = CF + nz * nthr;
  const int plane = jy * ix;

  // offsets within a level of the points d = -3..3 along A and along B;
  // point (da, db) is at A[da + 3] + B[db + 3]
  int A[7], B[7];
#pragma unroll
  for (int d = 0; d < 7; ++d) {
    const int c = wrap(i + d - 3, ix), r = wrap(j + d - 3, jy) * ix;
    A[d] = h ? r : c;
    B[d] = h ? c : r;
  }
  // the shifts of the second differences along A at -1, 0, 1 (fix_we /
  // fix_ns with their default rows: 2 <- 3, n-2 <- n-3) and along B (u's
  // uee and v's vxx: 1 <- 2, n-2 <- n-3)
  const bool per_a = h ? a.ns_periodic : a.ew_periodic;
  const bool per_b = h ? a.ew_periodic : a.ns_periodic;
  const bool lo_a = h ? a.own_s : a.own_w, hi_a = h ? a.own_n : a.own_e;
  const bool lo_b = h ? a.own_w : a.own_s, hi_b = h ? a.own_e : a.own_n;
  const int na = h ? jy : ix, nb = h ? ix : jy;
  const int pa = h ? j : i, pb = h ? i : j;
  int sa[3], sb[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    sa[c] = edge_shift(wrap(pa + c - 1, na), na, per_a, lo_a, hi_a, 2);
    sb[c] = edge_shift(wrap(pb + c - 1, nb), nb, per_b, lo_b, hi_b, 1);
  }

  const T* q = h ? a.v : a.u;         // the half's component
  const T* p = h ? a.u : a.v;         // the other component
  const T* fa = h ? a.flx_v : a.flx_u;  // volume flux along A
  const T* fb = h ? a.flx_u : a.flx_v;  // volume flux along B
  const T* hz = a.hz;
  const T* we = a.we;
  T* out = h ? a.rv : a.ru;
  const int p00 = A[3] + B[3];

  // level-independent factors: the Coriolis parameter and metric terms at
  // (0, 0) and (-1, 0) along A, the half's mask at -1 and +1 along A
  T fomn[2], dndx[2] = {T(0), T(0)}, dmde[2] = {T(0), T(0)};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int o = A[3 - e] + B[3];
    fomn[e] = a.fomn[o];
    if (a.curv) {
      dndx[e] = a.dndx[o];
      dmde[e] = a.dmde[o];
    }
  }
  T m_m1 = T(0), m_p1 = T(0);
  if (a.masking) {
    const T* m = h ? a.vmask : a.umask;
    m_m1 = m[A[2] + B[3]];
    m_p1 = m[A[4] + B[3]];
  }

  // ---- sweep A (up): the spline's forward elimination
  //      (compute_vert_rhs_uv_terms.h:8-37) with the staggered heights
  //      dc = 9/16 (Hz + Hz(-1)) - 1/16 (Hz(+1) + Hz(-2)) along A
  T cf = T(1), fc = T(0), q_below = T(0), d_below = T(0);
  if (a.adv) {
#pragma unroll 4
    for (int k = 0; k < nz; ++k) {
      const int lo = k * plane;
      const T qk = q[lo + p00];
      const T dk = T(0.5625) * (hz[lo + p00] + hz[lo + A[2] + B[3]])
                   - T(0.0625) * (hz[lo + A[4] + B[3]] + hz[lo + A[1] + B[3]]);
      if (k == 0) {
        fc = T(2) * qk;
      } else {
        const T cff = rcp(T(2) * d_below + dk * (T(2) - cf));
        fc = cff * (T(3) * (d_below * qk + dk * q_below) - dk * fc);
        cf = cff * d_below;
      }
      CF[k * nthr] = cf;
      FC[k * nthr] = fc;
      q_below = qk;
      d_below = dk;
    }
  }
  // the interface value at the surface
  T iface_hi = a.adv ? (T(2) * q_below - fc) / (T(1) - cf) : T(0);
  T f_hi = T(0);                      // FC at the level above: 0 at the top

  // ---- sweep B (down): level k's r.h.s. from the stencil values that
  //      the previous step loaded; the step first loads level k - 1's
  struct Level {
    T qa[7];        // q along A, -3..3
    T qb[7];        // q along B, -3..3 (qb[3] unused: qa[3])
    T fa[7];        // the volume flux along A, along A -3..3
    T fb[2][4];     // the volume flux along B at B 0 and 1, along A -2..1
    T p[2][2];      // the other component at A 0 and -1, B 0 and 1
    T hz[2];        // Hz at A 0 and -1
    T w[4];         // We along A -2..1
  };
  auto load = [&](Level& L, int k) {
    const int lo = k * plane;
    const int b0 = lo + B[3];
#pragma unroll
    for (int d = 0; d < 7; ++d) {
      L.qa[d] = __ldg(q + b0 + A[d]);
      L.fa[d] = __ldg(fa + b0 + A[d]);
      if (d != 3) L.qb[d] = __ldg(q + lo + A[3] + B[d]);
    }
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int d = 0; d < 4; ++d) L.fb[b][d] = __ldg(fb + lo + A[d + 1] + B[b + 3]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = lo + A[3 - e];
      L.p[e][0] = __ldg(p + o + B[3]);
      L.p[e][1] = __ldg(p + o + B[4]);
      L.hz[e] = __ldg(hz + o + B[3]);
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) L.w[d] = __ldg(we + lo + A[d + 1] + B[3]);
  };
  Level cur;
  load(cur, nz - 1);
  for (int k = nz - 1; k >= 0; --k) {
    Level next;
    if (k > 0) load(next, k - 1);
    const T* qa = cur.qa;
    T r = T(0);
    if (a.cor) {
      // Coriolis and metric terms (compute_horiz_rhs_uv_terms.h:1-38) at
      // the two rho-points (e = 0: along A 0, e = 1: -1) around the point:
      // u's UFx = cff*(v + v(j+1)), v's VFe = cff*(u + u(i+1))
      T x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const T sp = cur.p[e][0] + cur.p[e][1];      // the other component
        const T sq = qa[3 - e] + qa[4 - e];         // the own, along A
        T cff = fomn[e];
        if (a.curv)
          cff = cff + T(0.5) * ((h ? sq : sp) * dndx[e]
                                - (h ? sp : sq) * dmde[e]);
        cff = T(0.5) * cur.hz[e] * cff;
        x[e] = cff * sp;
      }
      r = (h ? T(-0.5) : T(0.5)) * (x[0] + x[1]);
    }
    if (a.adv) {
      // horizontal advection (compute_horiz_rhs_uv_terms.h:42-291).
      // Along A, the diagonal flux (u's UFx, v's VFe) between c and c + 1
      const T* fav = cur.fa;
      T dq[5], dh[5], qxx[3], hxx[3];
      second_diffs(qa, dq);
      second_diffs(fav, dh);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        qxx[c] = fixed(dq, c - 1, sa[c]);
        hxx[c] = fixed(dh, c - 1, sa[c]);
      }
      T fl[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {   // c = 0: position -1, c = 1: 0
        const T cff = (fav[c + 2] + fav[c + 3])
                      - T(DELTA_UV) * (hxx[c] + hxx[c + 1]);
        const T sum = qa[c + 2] + qa[c + 3];
        if (UP3)
          fl[c] = T(0.25) * (cff * sum - T(GAMMA_UV) * (pos(cff) * qxx[c]
                                                        + neg(cff) * qxx[c + 1]));
        else
          fl[c] = T(0.25) * ((sum - T(DELTA_UV) * (qxx[c] + qxx[c + 1]))
                             * cff);
      }
      // across A, the off-diagonal flux (u's UFe, v's VFx) between b - 1
      // and b, with the other volume flux's second differences along A
      T qb[7], db[5], qbb[3];
#pragma unroll
      for (int d = 0; d < 7; ++d) qb[d] = d == 3 ? qa[3] : cur.qb[d];
      second_diffs(qb, db);
#pragma unroll
      for (int c = 0; c < 3; ++c) qbb[c] = fixed(db, c - 1, sb[c]);
      T gl[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const T* f4 = cur.fb[b];      // along A -2..1, B at b
        const T h0 = (f4[1] - T(2) * f4[2]) + f4[3];   // at A 0
        const T hm = (f4[0] - T(2) * f4[1]) + f4[2];   // at A -1
        const T cff = (f4[2] + f4[1]) - T(DELTA_UV) * (h0 + hm);
        const T sum = qb[b + 3] + qb[b + 2];
        if (UP3)
          gl[b] = T(0.25) * (cff * sum - T(GAMMA_UV) * (pos(cff) * qbb[b]
                                                        + neg(cff) * qbb[b + 1]));
        else
          gl[b] = T(0.25) * ((sum - T(DELTA_UV) * (qbb[b + 1] + qbb[b]))
                             * cff);
      }
      const T adv = -(fl[1] - fl[0]) - (gl[1] - gl[0]);
      // SPLINE_UV: the back substitution and FC = interface * Wavg, with
      // Wavg the half's stagger of We (masked: 1/8 of the neighbours'
      // differences, at wet faces only)
      const T iface = FC[k * nthr] - CF[k * nthr] * iface_hi;
      T f_lo = T(0);
      if (k > 0) {
        const T* w = cur.w;
        T wavg;
        if (a.masking)
          wavg = T(0.5) * ((w[2] + w[1])
                           - T(0.125) * ((w[3] - w[2]) * m_p1
                                         - (w[1] - w[0]) * m_m1));
        else
          wavg = T(0.5625) * (w[2] + w[1]) - T(0.0625) * (w[3] + w[0]);
        f_lo = iface * wavg;
      }
      r = r + adv;
      r = r + -(f_hi - f_lo);
      f_hi = f_lo;
      iface_hi = iface;
    }
    out[k * plane + p00] = r;
    cur = next;
  }
}

template <typename T>
using KernelFn = void (*)(Args<T>);

// the kernel for (type, scheme) with its dynamic shared memory allowed up
// to `smem` bytes; nullptr if the configuration is refused
template <typename T>
KernelFn<T> prepared(int upstream, int tj, int nz, int smem) {
  static int allowed[2][64] = {};
  if (nz < 2 || tj < 1 || 2 * TI * tj > Bounds<T>::threads ||
      smem != smem_bytes(tj, nz, sizeof(T)))
    return nullptr;
  KernelFn<T> k = upstream ? uv_rhs_kernel<true, T> : uv_rhs_kernel<false, T>;
  return allow_smem((const void*)k, smem, allowed[upstream ? 1 : 0])
      ? k : nullptr;
}

// p: u, v, flx_u, flx_v, hz, we, fomn, dndx and dmde (or NULL without
//    curv), umask, vmask, ru, rv.
// n: nz, jy, ix, upstream, cor, curv, adv, masking, ew_periodic,
//    ns_periodic, own_w, own_e, own_s, own_n, tj (tile rows), smem (bytes,
//    as ops/cuda_uv_rhs.py:smem_bytes gives them).  d: none.
// occupancy n: f64, upstream, tj, nz, smem.
constexpr Lengths LENGTHS = {13, 16, 0, 5, 5};

template <typename T>
int launch(const void* const* p, const int* n, const double*,
           void* stream) {
  n = launch_ints(LENGTHS, n);
  if (n == nullptr) return (int)cudaErrorInvalidValue;
  Args<T> a;
  a.u = (const T*)p[0];
  a.v = (const T*)p[1];
  a.flx_u = (const T*)p[2];
  a.flx_v = (const T*)p[3];
  a.hz = (const T*)p[4];
  a.we = (const T*)p[5];
  a.fomn = (const T*)p[6];
  a.dndx = (const T*)p[7];
  a.dmde = (const T*)p[8];
  a.umask = (const T*)p[9];
  a.vmask = (const T*)p[10];
  a.ru = (T*)p[11];
  a.rv = (T*)p[12];
  a.nz = n[0];
  a.jy = n[1];
  a.ix = n[2];
  const int upstream = n[3];
  a.cor = n[4];
  a.curv = n[5];
  a.adv = n[6];
  a.masking = n[7];
  a.ew_periodic = n[8];
  a.ns_periodic = n[9];
  a.own_w = n[10];
  a.own_e = n[11];
  a.own_s = n[12];
  a.own_n = n[13];
  const int tj = n[14], smem = n[15];
  if (a.jy < 6 || a.ix < 6 || (a.curv && (a.dndx == nullptr ||
                                          a.dmde == nullptr)))
    return (int)cudaErrorInvalidValue;
  KernelFn<T> k = prepared<T>(upstream, tj, a.nz, smem);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 block(TI, tj, 2);
  const dim3 grid((a.ix + TI - 1) / TI, (a.jy + tj - 1) / tj);
  k<<<grid, block, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int upstream, int tj, int nz, int smem, int* out) {
  return occupancy_of((const void*)prepared<T>(upstream, tj, nz, smem),
                      2 * TI * tj, smem, out);
}

}  // namespace

extern "C" int roms_uv_rhs_f32(const void* const* p, const int* n,
                               const double* d, void* stream) {
  return launch<float>(p, n, d, stream);
}

extern "C" int roms_uv_rhs_f64(const void* const* p, const int* n,
                               const double* d, void* stream) {
  return launch<double>(p, n, d, stream);
}

// The kernel's launch configuration for (f64, upstream) at tile rows tj,
// nz levels and `smem` bytes on the current device, into out[0..4].
extern "C" int roms_uv_rhs_occupancy(const int* n, int* out) {
  n = occupancy_ints(LENGTHS, n);
  if (n == nullptr) return (int)cudaErrorInvalidValue;
  return n[0] ? occupancy<double>(n[1], n[2], n[3], n[4], out)
              : occupancy<float>(n[1], n[2], n[3], n[4], out);
}

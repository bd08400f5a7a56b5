// One tracer stage (predictor or corrector) for all tracers on NVIDIA
// Hopper (sm_90a): a block owns a tile of TI x TJ columns of one tracer
// and keeps every per-level intermediate of its columns on chip.
//
// Replaces the TPU kernel roms_tpu/ops/pallas_tracer.py (tracer_stage,
// _kernel).  Per column, level by level:
//
//   t_new = IMPLICIT( hz_pre*(c_tk*tk + c_sec*t_sec)
//                     - dtau*pmn*div_h(FX, FE)
//                     - dtau*pmn*div_v(spline_iface * We)
//                     [+ dtau*stflx at the surface] )  [+ t3dmix tendency]
//
// with the horizontal fluxes of src/compute_horiz_tracer_fluxes.h
// (CENTERED4 / UPSTREAM3 / AKIMA, masking, and the non-periodic edge
// fixes gated on the four ownership flags), the SPLINE_TS vertical flux of
// src/compute_vert_tracer_fluxes.h (forward and backward sweeps), the
// surface flux, the implicit vertical diffusion + advection Thomas solve
// of pre_step3d4S.F:216-263 / step3d_t_ISO.F:1044-1100, and in corrector
// mode optionally the t3dmix lateral diffusion built from the same tk
// window (t3dmix_S.F:45-99).  The arithmetic follows the Pallas kernel
// and the plain PyTorch version operation by operation: bottom-up spline
// and Thomas elimination, top-down back substitution.
//
// Hz roles: pred (hz_a = Hz(n), hz_b = flx_div) uses hz_pre = hz_a + hz_b,
// spline weights hz_a and implicit heights hz_a - hz_b; corr (hz_a =
// Hz(n), hz_b = Hz(n+1)) uses hz_pre = hz_a and hz_b for both.  Tracer t
// takes the diffusivity row min(t, imix-1) (reference: tracers.F iTandS).
//
// What bounds it on this card: by bytes, device memory (each input read
// once, the output written once: ~2.0 GB at 384x192x60 with 34 tracers,
// 0.6 ms).  In practice, latency: each column is a chain of dependent level
// steps, and shared memory caps the columns an SM can hold, so the design
// keeps as many columns resident as it can and loads ahead of use.
//
//  * Columns on chip, two arrays deep.  The sweeps are ordered so that a
//    column needs only two per-level arrays in shared memory, laid out
//    [level][column] (a warp's accesses fall in distinct banks):
//      A (up)    the spline's forward elimination from the column's tk
//                and spline heights -> CF = cf, FC = fc;
//      B (down)  level tiles: face fluxes, r.h.s., t3dmix tendency; then
//                the spline's back substitution and the vertical
//                advection -> FC = the r.h.s.;
//      C (up)    the Thomas forward elimination -> CF = cf, FC = dc;
//      D (down)  back substitution, mask -> the output.
//    The arithmetic of each quantity is the plain version's; only the
//    loops are arranged differently.  At nz=60 in f32 a block of 32 x 4
//    columns takes ~70 KB, three blocks an SM.  The wrapper picks the tile
//    rows TJ per (type, nz) (ops/cuda_tracer.py:launch_plan) and caps nz.
//    With t3dmix the tendency waits in the output between sweeps B and D
//    (written in B, sweep D adds the column's value onto it), so t3dmix
//    costs no third array; nothing else goes to device memory.
//  * Two threads a column in sweep B, where the face work is: half 0 the
//    x faces and the column's vertical chain, half 1 the y faces, the
//    r.h.s. and the t3dmix tendency.  Half 0 alone runs sweeps A, C, D.
//  * Level tiles two levels ahead.  Sweep B streams each level's
//    (TJ+6) x (TI+6) tile of tk with a three-cell halo (and the rows of
//    Hz(n+1) that t3dmix reads) into a ring of three slots with cp.async;
//    each thread's own scalars (volume fluxes, Hz, t_sec, We) come one
//    level ahead in registers.  Halo indices wrap, (j + dj + jy) % jy and
//    (i + di + ix) % ix: the roll semantics of the JAX code's `shift`,
//    ghost lines included (a TMA tile load would zero-fill instead).
//    Elements are copied one by one (4 or 8 bytes), so a row pitch that is
//    not a multiple of 16 bytes needs nothing special.  Sweeps A and C
//    stream their column's inputs through per-thread cp.async rings in the
//    same memory, up to 8 levels ahead.
//  * Each face flux once, from shared memory at constant offsets.  Each
//    thread computes the west or south face of its point (the row's last
//    lane also the east face, the tile's last row also the north face).
//    The physical-edge extrapolation moves a difference one cell inwards;
//    the third halo cell keeps that inside the tile, and the warps that
//    have such a face take a path with those offsets.  Masks, diff2,
//    pmon_u and pnom_v enter each face as level-independent factors kept
//    in registers.
//  * Geometry once.  The tracer is the fastest grid index, so the blocks
//    of one tile for all tracers run together and share the tracer-free
//    fields (flx_u, flx_v, Hz, We, Wi, akt) through L2.
//
// Entry points: roms_tracer_stage_f32 / _f64 launch on the given stream
// and return cudaGetLastError(); roms_tracer_stage_occupancy reports a
// launch configuration's resident blocks per SM, registers and stack.
// Plain C, bound by ctypes from roms_tpu_torch/ops/cuda_tracer.py.

#include <cuda_runtime.h>

namespace {

enum Scheme { CENTERED4 = 0, UPSTREAM3 = 1, AKIMA = 2 };

constexpr double C_UP3_TS = 0.1666666666666666;   // compute_horiz_tracer_fluxes.h:106
constexpr double C_CEN4_TS = 0.3333333333333333;  // compute_horiz_tracer_fluxes.h:110
constexpr double EPSIL = 1.0e-33;
constexpr int TI = 32;        // tile width along i: one warp
constexpr int HALO = 3;       // tile halo: the stencil's two cells + one
                              // for the edge extrapolation's shift
constexpr int WI = TI + 2 * HALO;  // tile row with its halo
constexpr int NB = 3;         // ring slots of the level tiles
constexpr int NV = 4;         // fields of a sweep-C ring slot
constexpr int NO_SHIFT = 21;  // three packed face shifts of 0 (see shifts)

template <typename T>
struct Args {
  const T *tk, *t_sec, *flx_u, *flx_v, *hz_a, *hz_b, *we, *wi, *akt, *pmn;
  const T *rmask, *umask, *vmask, *stflx, *diff2, *pmon_u, *pnom_v;
  T* out;
  int nt, nz, jy, ix, imix;
  int corr, masking, ew_periodic, ns_periodic;
  int own_w, own_e, own_s, own_n, apply_mask;
  T dtau, c_tk, c_sec;
};

// Shared memory of one block of tj tile rows, offsets in elements of T:
// the face fluxes (x faces, tj rows of TI + 1, then y faces, tj + 1 rows
// of TI; again for t3dmix); two buffers of one level's r.h.s. before
// vertical advection; NB ring slots of one level's tiles (tk, and with
// mix the tj + 2 rows of Hz(n+1) the t3dmix faces read); the two
// per-level arrays of the tile's columns, nz levels each: CF (spline cf,
// then Thomas cf) and FC (spline fc, then the r.h.s., then Thomas dc).
// The column sweeps A and C reuse everything before CF.
// ops/cuda_tracer.py:smem_bytes mirrors this; the launch refuses a size
// that differs.
struct Layout {
  int wt, ncol, nfx, nf;
  int fa, fm, r1;
  int ring, slot, s_tile, s_hzt;
  int cf, fc, total;
};

__host__ __device__ constexpr Layout layout(int tj, int nz, bool mix) {
  Layout L{};
  L.wt = (tj + 2 * HALO) * WI;
  L.ncol = tj * TI;
  L.nfx = tj * (TI + 1);
  L.nf = L.nfx + (tj + 1) * TI;
  const int m = mix ? 1 : 0;
  int o = 0;
  L.fa = o; o += L.nf;
  L.fm = o; o += m * L.nf;
  L.r1 = o; o += 2 * L.ncol;
  int s = 0;
  L.s_tile = s; s += L.wt;
  L.s_hzt = s; s += m * (tj + 2) * WI;   // rows HALO - 1 .. HALO + tj
  L.slot = s;
  L.ring = o; o += NB * s;
  L.cf = o; o += nz * L.ncol;
  L.fc = o; o += nz * L.ncol;
  L.total = o;
  return L;
}

inline long smem_bytes(int tj, int nz, bool mix, int es) {
  return (long)layout(tj, nz, mix).total * es;
}

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

__device__ __forceinline__ int mod(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

template <typename T>
__device__ __forceinline__ T pos(T a) { return a > T(0) ? a : T(0); }

template <typename T>
__device__ __forceinline__ T neg(T a) { return a < T(0) ? a : T(0); }

// 1 / x, correctly rounded: the value of the division T(1) / x
__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }

// the largest power of two <= n, at most 8
__host__ __device__ constexpr int pow2_depth(int n) {
  return n >= 8 ? 8 : n >= 4 ? 4 : n >= 2 ? 2 : 1;
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(d), "l"(src), "n"(sizeof(T)) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// advective face flux from the two adjacent tracer values (t_c, t_m),
// the elementary differences at the face and its two neighbours, and
// the volume flux f
template <int S, typename T>
__device__ __forceinline__ T face_flux(T t_c, T t_m, T d_m, T d_c, T d_p,
                                       T f) {
  if (S == UPSTREAM3) {
    return T(0.5) * (t_c + t_m) * f
           - T(C_UP3_TS) * ((d_c - d_m) * pos(f) + (d_p - d_c) * neg(f));
  } else if (S == AKIMA) {
    const T cffp = T(2) * d_p * d_c;
    const T g_c = cffp > T(EPSIL) ? cffp / (d_p + d_c) : T(0);
    const T cffm = T(2) * d_c * d_m;
    const T g_m = cffm > T(EPSIL) ? cffm / (d_c + d_m) : T(0);
    return T(0.5) * (t_c + t_m - T(C_CEN4_TS) * (g_c - g_m)) * f;
  } else {
    const T g_c = T(0.5) * (d_p + d_c);
    const T g_m = T(0.5) * (d_c + d_m);
    return T(0.5) * (t_c + t_m - T(C_CEN4_TS) * (g_c - g_m)) * f;
  }
}

// One face of the tile.  Its plus-side point is tile index b (tile rows
// and columns count from the halo's corner); ST is the step across it (1:
// an x face at a u-point, WI: a y face at a v-point).  Its q-th
// elementary difference (a point minus its neighbour one step back) is at
// b + (q - 1) * ST, or, where the physical-edge extrapolation of
// compute_horiz_tracer_fluxes.h:74-83 / :155-164 replaces it, one step
// inwards: sh packs the three shifts (-1, 0 or +1 steps), each plus one,
// in two bits each.  With the three-cell halo every such point lies in
// the tile.  The level-independent factors stay in registers: the
// direction's mask at the three difference points, and for t3dmix
// 0.25 * (diff2(b) + diff2(b - ST)) * pmon_u or pnom_v (b) and the mask
// at b.
template <typename T>
struct Face {
  int b, sh;
  T m[3], mix_c, mix_m;
};

// the packed shifts of the face whose plus-side point is (jf, if_) in the
// grid
template <typename T>
__device__ __forceinline__ int shifts(const Args<T>& a, bool x, int jf,
                                      int if_) {
  int packed = 0;
  for (int q = 0; q < 3; ++q) {
    int shift = 0;
    if (x) {
      const int c = wrap(if_ + q - 1, a.ix);
      if (!a.ew_periodic) {
        if (a.own_w && c == 1) shift = 1;
        else if (a.own_e && c == a.ix - 1) shift = -1;
      }
    } else {
      const int r = wrap(jf + q - 1, a.jy);
      if (!a.ns_periodic) {
        if (a.own_s && r == 1) shift = 1;
        else if (a.own_n && r == a.jy - 1) shift = -1;
      }
    }
    packed |= (shift + 1) << (2 * q);
  }
  return packed;
}

// the face with plus-side tile index b and step st (1 or WI) of the tile
// whose corner is grid point (j0 - HALO, i0 - HALO); d2g: the tracer's
// diff2 plane (t3dmix)
template <bool MIX, typename T>
__device__ __forceinline__ Face<T> make_face(const Args<T>& a, int b,
                                             int st, int j0, int i0,
                                             const T* d2g) {
  auto g = [&](int tb) {      // the grid offset of tile index tb
    const int r = tb / WI, q = tb - r * WI;
    return mod(j0 - HALO + r, a.jy) * a.ix + mod(i0 - HALO + q, a.ix);
  };
  const bool x = st == 1;
  const T* mg = x ? a.umask : a.vmask;
  const int gb = g(b);
  Face<T> F;
  F.b = b;
  F.sh = shifts(a, x, gb / a.ix, gb % a.ix);
  for (int q = 0; q < 3; ++q)
    F.m[q] = mg[g(b + (q - 1 + ((F.sh >> (2 * q)) & 3) - 1) * st)];
  F.mix_c = T(0);
  F.mix_m = mg[gb];
  if (MIX)
    F.mix_c = T(0.25) * (d2g[gb] + d2g[g(b - st)])
              * (x ? a.pmon_u : a.pnom_v)[gb];
  return F;
}

// advective flux of face F at one level: tile = the level's tk tile, f =
// the volume flux.  Off a physical edge (EDGE false) every offset is a
// constant.
template <int S, int ST, bool EDGE, typename T>
__device__ __forceinline__ T adv_face(const T* tile, const Face<T>& F, T f,
                                      bool masking) {
  const T* tp = tile + F.b;
  T d[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    int o = (q - 1) * ST;
    if (EDGE) o += (((F.sh >> (2 * q)) & 3) - 1) * ST;
    d[q] = tp[o] - tp[o - ST];
    if (masking) d[q] = d[q] * F.m[q];
  }
  return face_flux<S>(tp[0], tp[-ST], d[0], d[1], d[2], f);
}

// t3dmix diffusive flux through face F (t3dmix_S.F:45-99) from the level's
// tk and Hz(n+1) tiles
template <int ST, typename T>
__device__ __forceinline__ T mix_face(const T* tile, const T* hzt,
                                      const Face<T>& F, bool masking) {
  const int b = F.b;
  T f = F.mix_c * (hzt[b] + hzt[b - ST]) * (tile[b] - tile[b - ST]);
  if (masking) f = f * F.mix_m;
  return f;
}

// a thread's faces, all of one direction: its primary face (x: west of
// its point; y: south) and, for the row's last lane (x) or the tile's
// last row (y), the extra face (east of the row; north of the column),
// with their indices in the face arrays
template <typename T>
struct Faces {
  Face<T> p, x;
  int po, xo;
  bool extra, masking;
};

// one level's face fluxes of direction ST into FA (and FM), from ring
// slot s and the faces' volume fluxes fp, fx
template <int S, bool MIX, bool E, int ST, typename T>
__device__ __forceinline__ void level_faces(const Faces<T>& f, const T* s,
                                            T fp, T fx, const Layout& L0,
                                            T* FA, T* FM) {
  const T* tile = s + L0.s_tile;
  FA[f.po] = adv_face<S, ST, E>(tile, f.p, fp, f.masking);
  if (f.extra) FA[f.xo] = adv_face<S, ST, E>(tile, f.x, fx, f.masking);
  if (MIX) {
    const T* hzt = s + L0.s_hzt - (HALO - 1) * WI;   // indexed as the tk tile
    FM[f.po] = mix_face<ST>(tile, hzt, f.p, f.masking);
    if (f.extra) FM[f.xo] = mix_face<ST>(tile, hzt, f.x, f.masking);
  }
}

// registers capped at 85 a thread (768 threads an SM), so that shared
// memory, not registers, limits the resident blocks
template <int S, bool MIX, int TJ, typename T>
__global__ void __launch_bounds__(2 * TI * TJ, 12 / TJ)
tracer_stage_kernel(const Args<T> a) {
  constexpr int NTHR = 2 * TI * TJ;
  constexpr Layout L0 = layout(TJ, 0, MIX);
  constexpr int NC = L0.ncol;
  constexpr int NE = (L0.wt + NTHR - 1) / NTHR;  // tile elements a thread copies
  // levels the column sweeps load ahead: as many slots of the tile's
  // columns as fit before CF (the face arrays, r.h.s. buffers and ring
  // are free then; two or NV fields a slot), a power of two, at most 8
  constexpr int RING = L0.cf;
  constexpr int D2 = pow2_depth(RING / (2 * NC));
  constexpr int DV = pow2_depth(RING / (NV * NC));
  static_assert(DV >= 2, "column ring too small");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nz = a.nz, ix = a.ix, jy = a.jy;
  const Layout L = layout(TJ, nz, MIX);
  const int t = blockIdx.x;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.z * TJ;
  // two threads a column in sweep B: half 0 takes the x faces and the
  // column's vertical chain, half 1 the y faces, the r.h.s. and the t3dmix
  // tendency; half 0 alone runs the column sweeps A, C and D
  const int tx = threadIdx.x, ty = threadIdx.y, h = threadIdx.z;
  const int c = ty * TI + tx;           // the thread's column in the tile
  const int tid = h * NC + c;
  // offsets within one tracer's field are ints (the wrapper checks that
  // (nz + 1) * jy * ix fits); the tracer's own pointers are formed once
  const int plane = jy * ix;
  const T* tk = a.tk + (long)t * nz * plane;
  const T* tsec = a.t_sec + (long)t * nz * plane;
  const bool masking = a.masking;

  T* FA = sm + L.fa;            // advective face fluxes
  T* FM = sm + L.fm;            // t3dmix face fluxes
  T* R1 = sm + L.r1;            // the r.h.s. before vertical advection
  T* ring = sm + L.ring;
  T* CF = sm + L.cf;
  T* FC = sm + L.fc;

  // the thread's point, wrapped (a thread past the ragged edge computes
  // the faces of the wrapped point, which its neighbour needs); only
  // active threads have a column of their own
  const int jw = mod(j0 + ty, jy), iw = mod(i0 + tx, ix);
  const bool active = i0 + tx < ix && j0 + ty < jy;
  const int col = jw * ix + iw;
  const int col_n = mod(j0 + TJ, jy) * ix + iw;
  const int col_e = jw * ix + mod(i0 + TI, ix);

  // global offsets (within a level) of the tile elements this thread
  // copies: element tid + e * NTHR, the halo wrapped
  // (with mix, bit e of hrow: the element lies in the Hz(n+1) tile's rows)
  int toff[NE];
  int hrow = 0;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int q = tid + e * NTHR;
    const int jj = q / WI, ii = q - jj * WI;
    toff[e] = mod(j0 - HALO + jj, jy) * ix + mod(i0 - HALO + ii, ix);
    if (jj >= HALO - 1 && jj <= HALO + TJ) hrow |= 1 << e;
  }
  // its faces; a warp takes the edge path if any of its faces is
  // extrapolated
  const int cc = (ty + HALO) * WI + tx + HALO;  // the point's tile index
  const T* d2g = MIX ? a.diff2 + (long)t * plane : nullptr;
  Faces<T> f;
  const int st = h ? WI : 1;
  f.extra = h ? ty == TJ - 1 : tx == TI - 1;
  f.p = make_face<MIX>(a, cc, st, j0, i0, d2g);
  f.x = make_face<MIX>(a, f.extra ? cc + st : cc, st, j0, i0, d2g);
  const int xo = ty * (TI + 1) + tx;    // the west face's index
  const int yo = L0.nfx + c;            // the south face's index
  f.po = h ? yo : xo;
  f.xo = f.po + (h ? TI : 1);
  f.masking = masking;
  const bool edge = __any_sync(0xffffffffu, f.p.sh != NO_SHIFT ||
                                             (f.extra && f.x.sh != NO_SHIFT));

  const T pm = a.pmn[col];
  const T dtau = a.dtau;
  T* out = a.out + (long)t * nz * plane + col;
  // half 0's column ring, everything before CF: slots of the tile's
  // columns, each thread reading only what it copied itself
  T* vr = sm + c;

  // ---- sweep A (up): the spline's forward elimination from the column's
  //      tk and spline heights (pred Hz(n), corr Hz(n+1))
  T cf_k = T(1), fc_k = T(0), t_below = T(0), hs_below = T(0);
  if (!h && active) {
    const T* tp = tk + col;             // the next level to load
    const T* hp = (a.corr ? a.hz_b : a.hz_a) + col;
    int left = nz, ws = 0, rs = 0;      // levels to load, write/read slot
    auto issue_a = [&]() {
      if (left > 0) {
        T* v = vr + ws * 2 * NC;
        cp_async(v, tp);
        cp_async(v + NC, hp);
        tp += plane;
        hp += plane;
        --left;
      }
      ws = (ws + 1) & (D2 - 1);
      cp_async_commit();
    };
    for (int k = 0; k < D2 - 1; ++k) issue_a();
    for (int k = 0; k < nz; ++k) {
      issue_a();
      cp_async_wait<D2 - 1>();
      const T* v = vr + rs * 2 * NC;
      rs = (rs + 1) & (D2 - 1);
      const T tc = v[0], hs = v[NC];
      if (k == 0) {
        cf_k = T(1);
        fc_k = T(2) * tc;
      } else {
        const T cff = rcp(T(2) * hs_below + hs * (T(2) - cf_k));
        fc_k = cff * (T(3) * (hs_below * tc + hs * t_below) - hs * fc_k);
        cf_k = cff * hs_below;
      }
      CF[k * NC + c] = cf_k;
      FC[k * NC + c] = fc_k;
      t_below = tc;
      hs_below = hs;
    }
    cp_async_wait<0>();
  }
  __syncthreads();              // sweep B reuses the ring

  // ---- sweep B (down): step m streams level k = nz-1-m's tiles into
  //      ring slot m % NB as one cp.async group, NB - 1 levels ahead (the
  //      thread's own scalars one step ahead, in registers), and computes
  //      its face fluxes, r.h.s. and t3dmix tendency; half 0 finishes the
  //      level of step m - 1 (spline interface, vertical advection,
  //      surface flux) into FC
  auto issue = [&](int m, int slot) {
    T* s = ring + slot * L0.slot;
    const int lo = (nz - 1 - m) * plane;
    const T* tl = tk + lo;
    const T* hl = a.hz_b + lo;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int q = tid + e * NTHR;
      if (e + 1 < NE || q < L0.wt) {
        cp_async(s + L0.s_tile + q, tl + toff[e]);
        if (MIX && (hrow >> e) & 1)
          cp_async(s + L0.s_hzt + q - (HALO - 1) * WI, hl + toff[e]);
      }
    }
    cp_async_commit();
  };
  // the thread's scalars of step m: half 0 the x faces' volume fluxes and
  // We; half 1 the y faces' volume fluxes, Hz(n), t_sec (and hz_b)
  struct Scalars {
    T fp, fx, w, ha, hb, ts;
  };
  auto scalars = [&](int m) {
    Scalars v{};
    const int lo = (nz - 1 - m) * plane;
    if (h) {
      v.fp = a.flx_v[lo + col];
      if (f.extra) v.fx = a.flx_v[lo + col_n];
      v.ha = a.hz_a[lo + col];
      if (!MIX) v.hb = a.hz_b[lo + col];
      v.ts = tsec[lo + col];
    } else {
      v.fp = a.flx_u[lo + col];
      if (f.extra) v.fx = a.flx_u[lo + col_e];
      v.w = a.we[lo + col];
    }
    return v;
  };
  Scalars next = scalars(0);
  for (int m = 0; m < NB - 1; ++m) {
    if (m < nz) issue(m, m);
    else cp_async_commit();
  }
  int rsl = 0, isl = NB - 1;            // ring slots of steps m, m + NB - 1
  T iface_above = (T(2) * t_below - fc_k) / (T(1) - cf_k);
  T we_hi = T(0), we_k = T(0);
  const T sflx = a.stflx != nullptr ? a.stflx[(long)t * plane + col] : T(0);
  for (int m = 0; m <= nz; ++m) {
    const T* s = ring + rsl * L0.slot;
    rsl = rsl == NB - 1 ? 0 : rsl + 1;
    const Scalars cur = next;
    if (m + 1 < nz) next = scalars(m + 1);
    if (m < nz) {
      // level k has arrived; every thread is done with step m - 1's
      // faces and with slot m - 1
      cp_async_wait<NB - 2>();
      __syncthreads();
      if (m + NB - 1 < nz) issue(m + NB - 1, isl);
      else cp_async_commit();
      isl = isl == NB - 1 ? 0 : isl + 1;
      if (h) {
        if (edge)
          level_faces<S, MIX, true, WI>(f, s, cur.fp, cur.fx, L0, FA, FM);
        else
          level_faces<S, MIX, false, WI>(f, s, cur.fp, cur.fx, L0, FA, FM);
      } else {
        if (edge)
          level_faces<S, MIX, true, 1>(f, s, cur.fp, cur.fx, L0, FA, FM);
        else
          level_faces<S, MIX, false, 1>(f, s, cur.fp, cur.fx, L0, FA, FM);
      }
    }
    __syncthreads();
    if (!active) continue;
    const int k = nz - 1 - m;
    if (h) {
      if (m == nz) continue;
      // half 1: the r.h.s. before vertical advection; the t3dmix
      // tendency, which waits in the output for sweep D
      const T ha = cur.ha;
      const T hb = MIX ? s[L0.s_hzt + cc - (HALO - 1) * WI] : cur.hb;
      const T tc = s[L0.s_tile + cc];
      const T ts = cur.ts;
      const T div = pm * (FA[xo + 1] - FA[xo] + FA[yo + TI] - FA[yo]);
      const T hz_pre = a.corr ? ha : ha + hb;
      R1[(m & 1) * NC + c] = hz_pre * (a.c_tk * tc + a.c_sec * ts)
                             - dtau * div;
      if (MIX) {
        const T divm = FM[xo + 1] - FM[xo] + FM[yo + TI] - FM[yo];
        out[k * plane] = dtau * pm * divm / hb;
      }
    } else {
      if (m > 0) {
        // half 0: level kp = k + 1, whose r.h.s. half 1 left in step m - 1
        const int kp = k + 1;
        const int o = kp * NC + c;
        const T iface = FC[o] - CF[o] * iface_above;
        const T hi = (kp == nz - 1) ? T(0) : iface_above * we_hi;
        const T lo = (kp == 0) ? T(0) : iface * we_k;
        T rhs = R1[((m - 1) & 1) * NC + c] - dtau * pm * (hi - lo);
        if (kp == nz - 1 && a.stflx != nullptr) rhs = rhs + dtau * sflx;
        FC[o] = rhs;
        iface_above = iface;
        we_hi = we_k;
      }
      if (m < nz) we_k = cur.w;
    }
  }
  cp_async_wait<0>();
  __syncthreads();              // the column sweeps reuse the ring
  if (h || !active) return;

  // ---- sweep C (up): implicit diffusion + advection, forward
  //      elimination, in place (FC: r.h.s. -> dc, CF: cf).  Step k reads
  //      the heights (pred: Hz(n) and flx_div), Akt and Wi of level k + 1
  //      through ring slot k % DV.
  const T dc0 = dtau * pm;
  const T* hza = a.hz_a + col;
  const T* hzb = a.hz_b + col;
  const T* akt = a.akt + (long)min(t, a.imix - 1) * (nz + 1) * plane + col;
  const T* wi = a.wi + col;
  int left = nz - 1, ws = 0, rs = 0;    // levels to load, write/read slot
  int ol = plane;                       // offset of the next level to load
  auto issue_up = [&]() {
    if (left > 0) {
      T* v = vr + ws * NV * NC;
      cp_async(v, hzb + ol);
      cp_async(v + NC, akt + ol);
      cp_async(v + 2 * NC, wi + ol);
      if (!a.corr) cp_async(v + 3 * NC, hza + ol);
      ol += plane;
      --left;
    }
    ws = (ws + 1) & (DV - 1);
    cp_async_commit();
  };
  for (int k = 0; k < DV - 1; ++k) issue_up();
  T hz_c = a.corr ? hzb[0] : hza[0] - hzb[0];
  T fcv_b = T(0), wp_b = T(0), wm_b = T(0), cf_b = T(0), dc_b = T(0);
  T r_o = FC[c];
  for (int k = 0; k < nz - 1; ++k) {
    issue_up();
    cp_async_wait<DV - 1>();
    const T* v = vr + rs * NV * NC;
    rs = (rs + 1) & (DV - 1);
    const T hz_up = a.corr ? v[0] : v[3 * NC] - v[0];
    const T ak = v[NC], wv = v[2 * NC];
    const T fcv = T(2) * dtau * ak / (hz_up + hz_c);
    const T w = dc0 * wv;
    const T wp = pos(w), wm = neg(w);
    T below = T(0), ext = T(0);
    if (k > 0) {
      below = fcv_b - wm_b - cf_b * (fcv_b + wp_b);
      ext = dc_b * (fcv_b + wp_b);
    }
    const int ok = k * NC + c;
    const T cff = rcp(hz_c + fcv + wp + below);
    cf_b = cff * (fcv - wm);
    dc_b = cff * (r_o + ext);
    r_o = FC[ok + NC];
    CF[ok] = cf_b;
    FC[ok] = dc_b;
    fcv_b = fcv;
    wp_b = wp;
    wm_b = wm;
    hz_c = hz_up;
  }
  cp_async_wait<0>();

  // ---- sweep D (down): back substitution, mask; with t3dmix the value is
  //      added onto the tendency parked in the output (one addition, as
  //      tv + tendency: a fire-and-forget reduction, no read back)
  const bool masked = a.apply_mask && masking;
  const T msk = masked ? a.rmask[col] : T(1);
  T tv = (r_o + dc_b * (fcv_b + wp_b))
         / (hz_c + fcv_b - wm_b - cf_b * (fcv_b + wp_b));
  for (int k = nz - 1; k >= 0; --k) {
    const int ok = k * NC + c;
    if (k < nz - 1) tv = FC[ok] + CF[ok] * tv;
    if (masked) tv = tv * msk;
    if (MIX) atomicAdd(out + k * plane, tv);
    else out[k * plane] = tv;
  }
}

template <typename T>
using KernelFn = void (*)(Args<T>);

template <typename T, int S, bool MIX>
KernelFn<T> kernel_for_tj(int tj) {
  switch (tj) {
    case 1: return tracer_stage_kernel<S, MIX, 1, T>;
    case 2: return tracer_stage_kernel<S, MIX, 2, T>;
    case 4: return tracer_stage_kernel<S, MIX, 4, T>;
    default: return nullptr;
  }
}

template <typename T, int S>
KernelFn<T> kernel_for_mix(int mix, int tj) {
  return mix ? kernel_for_tj<T, S, true>(tj) : kernel_for_tj<T, S, false>(tj);
}

// the kernel for (type, scheme, mix, tile rows), nullptr if none
template <typename T>
KernelFn<T> kernel_for(int scheme, int mix, int tj) {
  switch (scheme) {
    case CENTERED4: return kernel_for_mix<T, CENTERED4>(mix, tj);
    case UPSTREAM3: return kernel_for_mix<T, UPSTREAM3>(mix, tj);
    case AKIMA: return kernel_for_mix<T, AKIMA>(mix, tj);
    default: return nullptr;
  }
}

// the kernel for (type, scheme, mix, tile rows) with its dynamic shared
// memory allowed up to `smem` bytes; nullptr if the configuration is
// refused
template <typename T>
KernelFn<T> prepared(int scheme, int mix, int tj, int nz, int smem) {
  KernelFn<T> k = kernel_for<T>(scheme, mix, tj);
  if (k == nullptr || nz < 2 ||
      smem != smem_bytes(tj, nz, mix != 0, sizeof(T)))
    return nullptr;
  if (cudaFuncSetAttribute((const void*)k,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return nullptr;
  return k;
}

template <typename T>
int launch(const void* const* p, const int* n, const double* d,
           void* stream) {
  Args<T> a;
  a.tk = (const T*)p[0];
  a.t_sec = (const T*)p[1];
  a.flx_u = (const T*)p[2];
  a.flx_v = (const T*)p[3];
  a.hz_a = (const T*)p[4];
  a.hz_b = (const T*)p[5];
  a.we = (const T*)p[6];
  a.wi = (const T*)p[7];
  a.akt = (const T*)p[8];
  a.pmn = (const T*)p[9];
  a.rmask = (const T*)p[10];
  a.umask = (const T*)p[11];
  a.vmask = (const T*)p[12];
  a.stflx = (const T*)p[13];
  a.diff2 = (const T*)p[14];
  a.pmon_u = (const T*)p[15];
  a.pnom_v = (const T*)p[16];
  a.out = (T*)p[17];
  a.nt = n[0];
  a.nz = n[1];
  a.jy = n[2];
  a.ix = n[3];
  a.imix = n[4];
  const int scheme = n[5];
  a.corr = n[6];
  a.masking = n[7];
  a.ew_periodic = n[8];
  a.ns_periodic = n[9];
  a.own_w = n[10];
  a.own_e = n[11];
  a.own_s = n[12];
  a.own_n = n[13];
  a.apply_mask = n[14];
  const int tj = n[15], smem = n[16];
  a.dtau = (T)d[0];
  a.c_tk = (T)d[1];
  a.c_sec = (T)d[2];
  const int mix = a.diff2 != nullptr;
  KernelFn<T> k = prepared<T>(scheme, mix, tj, a.nz, smem);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 block(TI, tj, 2);
  const dim3 grid(a.nt, (a.ix + TI - 1) / TI, (a.jy + tj - 1) / tj);
  k<<<grid, block, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers: tk, t_sec, flx_u, flx_v, hz_a, hz_b, we, wi, akt, pmn, rmask,
// umask, vmask, stflx (or NULL), diff2 (or NULL: no t3dmix), pmon_u,
// pnom_v, out.  Ints: nt, nz, jy, ix, imix, scheme, corr, masking,
// ew_periodic, ns_periodic, own_w, own_e, own_s, own_n, apply_mask, tj
// (tile rows), smem (bytes, as ops/cuda_tracer.py:smem_bytes gives them).
// Doubles: dtau, c_tk, c_sec.
#define ROMS_TRACER_ENTRY(NAME, T)                                              \
  extern "C" int NAME(                                                          \
      const void* tk, const void* t_sec, const void* flx_u, const void* flx_v, \
      const void* hz_a, const void* hz_b, const void* we, const void* wi,      \
      const void* akt, const void* pmn, const void* rmask, const void* umask,  \
      const void* vmask, const void* stflx, const void* diff2,                 \
      const void* pmon_u, const void* pnom_v, void* out,                       \
      int nt, int nz, int jy, int ix, int imix, int scheme, int corr,          \
      int masking, int ew_periodic, int ns_periodic, int own_w, int own_e,     \
      int own_s, int own_n, int apply_mask, int tj, int smem, double dtau,     \
      double c_tk, double c_sec, void* stream) {                               \
    const void* p[18] = {tk, t_sec, flx_u, flx_v, hz_a, hz_b, we, wi, akt,    \
                         pmn, rmask, umask, vmask, stflx, diff2, pmon_u,       \
                         pnom_v, out};                                         \
    const int n[17] = {nt, nz, jy, ix, imix, scheme, corr, masking,           \
                       ew_periodic, ns_periodic, own_w, own_e, own_s, own_n,   \
                       apply_mask, tj, smem};                                  \
    const double d[3] = {dtau, c_tk, c_sec};                                  \
    return launch<T>(p, n, d, stream);                                         \
  }

ROMS_TRACER_ENTRY(roms_tracer_stage_f32, float)
ROMS_TRACER_ENTRY(roms_tracer_stage_f64, double)

// Resident blocks per SM, registers per thread and stack bytes per thread
// of the kernel for (f64, scheme, mix) at tile rows tj and `smem` bytes of
// shared memory, into out[0..2].
extern "C" int roms_tracer_stage_occupancy(int f64, int scheme, int mix,
                                           int tj, int nz, int smem,
                                           int* out) {
  const void* k = f64 ? (const void*)prepared<double>(scheme, mix, tj, nz, smem)
                      : (const void*)prepared<float>(scheme, mix, tj, nz, smem);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], k,
                                                      2 * TI * tj, smem);
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  return (int)err;
}

// One tracer stage (predictor or corrector) for all tracers, one thread
// per (tracer, j, i) column, on NVIDIA Hopper (sm_90a).
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
// operation by operation.
//
// Periodic neighbours come from index arithmetic, (j + dj + jy) % jy and
// (i + di + ix) % ix, which is exactly the roll semantics of the JAX
// code's `shift` and of the TPU kernel's wrap padding, without copies.
// Each thread recomputes the faces it shares with its neighbours.
//
// Hz roles: pred (hz_a = Hz(n), hz_b = flx_div) uses hz_pre = hz_a + hz_b,
// spline weights hz_a and implicit heights hz_a - hz_b; corr (hz_a =
// Hz(n), hz_b = Hz(n+1)) uses hz_pre = hz_a and hz_b for both.  Tracer t
// takes the diffusivity row min(t, imix-1) (reference: tracers.F iTandS).
//
// What bounds it on this card: device-memory bandwidth.  Each column
// moves several nz-deep fields (tk, t_sec, flx_u, flx_v, hz_a, hz_b, we,
// wi, akt, the output) at little arithmetic per byte.  Threads run along
// i, so every level's loads and stores coalesce.
//
// What this simple design leaves for later: per-level intermediates (the
// right-hand side in the output buffer; the spline and Thomas CF/DC in a
// scratch tensor laid out (2, nt, nz, jy, ix)) make round trips through
// device memory between the four vertical sweeps; nz is not limited.  A
// faster kernel keeps the column on chip and reads each input once, with
// shared-memory tiles for the horizontal stencil instead of the repeated
// neighbour loads, which today rely on L1/L2.
//
// Entry points: roms_tracer_stage_f32 / _f64, plain C, bound by ctypes
// from roms_tpu_torch/ops/cuda_tracer.py.  Each launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

enum Scheme { CENTERED4 = 0, UPSTREAM3 = 1, AKIMA = 2 };

constexpr double C_UP3_TS = 0.1666666666666666;   // compute_horiz_tracer_fluxes.h:106
constexpr double C_CEN4_TS = 0.3333333333333333;  // compute_horiz_tracer_fluxes.h:110
constexpr double EPSIL = 1.0e-33;

template <typename T>
struct Args {
  const T *tk, *t_sec, *flx_u, *flx_v, *hz_a, *hz_b, *we, *wi, *akt, *pmn;
  const T *rmask, *umask, *vmask, *stflx, *diff2, *pmon_u, *pnom_v;
  T *out, *cf, *dc;
  int nt, nz, jy, ix, imix;
  int corr, masking, ew_periodic, ns_periodic;
  int own_w, own_e, own_s, own_n, apply_mask;
  T dtau, c_tk, c_sec;
};

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

template <typename T>
__device__ __forceinline__ T pos(T a) { return a > T(0) ? a : T(0); }

template <typename T>
__device__ __forceinline__ T neg(T a) { return a < T(0) ? a : T(0); }

// elementary xi difference at u-point (j, i) of level plane tl
template <typename T>
__device__ T dx_raw(const Args<T>& a, const T* tl, int j, int i) {
  const int r = j * a.ix;
  T d = tl[r + i] - tl[r + wrap(i - 1, a.ix)];
  if (a.masking) d = d * a.umask[r + i];
  return d;
}

// ... with the physical-edge extrapolation (compute_horiz_tracer_fluxes.h:74-83)
template <typename T>
__device__ T dx_at(const Args<T>& a, const T* tl, int j, int i) {
  if (!a.ew_periodic) {
    if (a.own_w && i == 1) return dx_raw(a, tl, j, 2);
    if (a.own_e && i == a.ix - 1) return dx_raw(a, tl, j, a.ix - 2);
  }
  return dx_raw(a, tl, j, i);
}

// elementary eta difference at v-point (j, i)
template <typename T>
__device__ T de_raw(const Args<T>& a, const T* tl, int j, int i) {
  T d = tl[j * a.ix + i] - tl[wrap(j - 1, a.jy) * a.ix + i];
  if (a.masking) d = d * a.vmask[j * a.ix + i];
  return d;
}

// ... with the physical-edge extrapolation (compute_horiz_tracer_fluxes.h:155-164)
template <typename T>
__device__ T de_at(const Args<T>& a, const T* tl, int j, int i) {
  if (!a.ns_periodic) {
    if (a.own_s && j == 1) return de_raw(a, tl, 2, i);
    if (a.own_n && j == a.jy - 1) return de_raw(a, tl, a.jy - 2, i);
  }
  return de_raw(a, tl, j, i);
}

// advective face flux from the two adjacent tracer values (t_c, t_m),
// the elementary differences at the face and its two neighbours, and
// the volume flux f
template <int S, typename T>
__device__ T face_flux(T t_c, T t_m, T d_m, T d_c, T d_p, T f) {
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

// FX at u-point (j, i), i already wrapped
template <int S, typename T>
__device__ T xflux(const Args<T>& a, const T* tl, const T* fu, int j, int i) {
  const int im = wrap(i - 1, a.ix), ip = wrap(i + 1, a.ix);
  const int r = j * a.ix;
  return face_flux<S>(tl[r + i], tl[r + im], dx_at(a, tl, j, im),
                      dx_at(a, tl, j, i), dx_at(a, tl, j, ip), fu[r + i]);
}

// FE at v-point (j, i), j already wrapped
template <int S, typename T>
__device__ T yflux(const Args<T>& a, const T* tl, const T* fv, int j, int i) {
  const int jm = wrap(j - 1, a.jy), jp = wrap(j + 1, a.jy);
  return face_flux<S>(tl[j * a.ix + i], tl[jm * a.ix + i],
                      de_at(a, tl, jm, i), de_at(a, tl, j, i),
                      de_at(a, tl, jp, i), fv[j * a.ix + i]);
}

// t3dmix diffusive fluxes (t3dmix_S.F:45-99) from the tk window
template <typename T>
__device__ T mix_fx(const Args<T>& a, const T* d2, const T* hzm, const T* tl,
                    int j, int i) {
  const int r = j * a.ix, im = wrap(i - 1, a.ix);
  T f = T(0.25) * (d2[r + i] + d2[r + im]) * a.pmon_u[r + i]
        * (hzm[r + i] + hzm[r + im]) * (tl[r + i] - tl[r + im]);
  if (a.masking) f = f * a.umask[r + i];
  return f;
}

template <typename T>
__device__ T mix_fe(const Args<T>& a, const T* d2, const T* hzm, const T* tl,
                    int j, int i) {
  const int r = j * a.ix, rm = wrap(j - 1, a.jy) * a.ix;
  T f = T(0.25) * (d2[r + i] + d2[rm + i]) * a.pnom_v[r + i]
        * (hzm[r + i] + hzm[rm + i]) * (tl[r + i] - tl[rm + i]);
  if (a.masking) f = f * a.vmask[r + i];
  return f;
}

template <int S, typename T>
__global__ void tracer_stage_kernel(const Args<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int t = blockIdx.z;
  if (i >= a.ix) return;
  const int nz = a.nz;
  const long plane = (long)a.jy * a.ix;
  const long col = (long)j * a.ix + i;
  const long tb = (long)t * nz * plane;
  const T* tk = a.tk + tb;
  const T* tsec = a.t_sec + tb;
  T* out = a.out + tb;
  T* cf = a.cf + tb;
  T* dc = a.dc + tb;
  const T* akt = a.akt + (long)min(t, a.imix - 1) * (nz + 1) * plane;
  const int ip = wrap(i + 1, a.ix), jp = wrap(j + 1, a.jy);
  const T pm = a.pmn[col];
  const T dtau = a.dtau;

  // ---- sweep 1 (up): horizontal fluxes, divergence, rhs -> out;
  //      spline forward elimination -> cf, dc
  T cf_k = T(1), fc_k = T(0), t_below = T(0), hs_below = T(0);
  for (int k = 0; k < nz; ++k) {
    const long o = k * plane + col;
    const T* tl = tk + k * plane;
    const T* fu = a.flx_u + k * plane;
    const T* fv = a.flx_v + k * plane;
    const T fx0 = xflux<S>(a, tl, fu, j, i);
    const T fx1 = xflux<S>(a, tl, fu, j, ip);
    const T fe0 = yflux<S>(a, tl, fv, j, i);
    const T fe1 = yflux<S>(a, tl, fv, jp, i);
    const T div = pm * (fx1 - fx0 + fe1 - fe0);
    const T ha = a.hz_a[o], hb = a.hz_b[o];
    const T hz_pre = a.corr ? ha : ha + hb;
    const T hs = a.corr ? hb : ha;
    const T tc = tl[col];
    out[o] = hz_pre * (a.c_tk * tc + a.c_sec * tsec[o]) - dtau * div;
    if (k == 0) {
      cf_k = T(1);
      fc_k = T(2) * tc;
    } else {
      const T cff = T(1) / (T(2) * hs_below + hs * (T(2) - cf_k));
      fc_k = cff * (T(3) * (hs_below * tc + hs * t_below) - hs * fc_k);
      cf_k = cff * hs_below;
    }
    cf[o] = cf_k;
    dc[o] = fc_k;
    t_below = tc;
    hs_below = hs;
  }

  // ---- sweep 2 (down): spline interface values, vertical advective
  //      flux divergence, surface flux
  T iface_above = (T(2) * t_below - fc_k) / (T(1) - cf_k);
  for (int k = nz - 1; k >= 0; --k) {
    const long o = k * plane + col;
    const T iface = dc[o] - cf[o] * iface_above;
    const T hi = (k == nz - 1) ? T(0) : iface_above * a.we[o + plane];
    const T lo = (k == 0) ? T(0) : iface * a.we[o];
    T rhs = out[o] - dtau * pm * (hi - lo);
    if (k == nz - 1 && a.stflx != nullptr)
      rhs = rhs + dtau * a.stflx[t * plane + col];
    out[o] = rhs;
    iface_above = iface;
  }

  // ---- sweep 3 (up): implicit diffusion + advection, forward elimination
  const T dc0 = dtau * pm;
  auto hz_imp = [&](int k) {
    const long o = k * plane + col;
    return a.corr ? a.hz_b[o] : a.hz_a[o] - a.hz_b[o];
  };
  T hz_c = hz_imp(0);
  T fcv_b = T(0), wp_b = T(0), wm_b = T(0), cf_b = T(0), dc_b = T(0);
  for (int c = 0; c < nz - 1; ++c) {
    const long o = c * plane + col;
    const T hz_up = hz_imp(c + 1);
    const T fcv = T(2) * dtau * akt[o + plane] / (hz_up + hz_c);
    const T w = dc0 * a.wi[o + plane];
    const T wp = pos(w), wm = neg(w);
    T below = T(0), extra = T(0);
    if (c > 0) {
      below = fcv_b - wm_b - cf_b * (fcv_b + wp_b);
      extra = dc_b * (fcv_b + wp_b);
    }
    const T cff = T(1) / (hz_c + fcv + wp + below);
    cf_b = cff * (fcv - wm);
    dc_b = cff * (out[o] + extra);
    cf[o] = cf_b;
    dc[o] = dc_b;
    fcv_b = fcv;
    wp_b = wp;
    wm_b = wm;
    hz_c = hz_up;
  }

  // ---- sweep 4 (down): back substitution, mask, fused t3dmix tendency
  const bool masked = a.apply_mask && a.masking;
  const T msk = masked ? a.rmask[col] : T(1);
  const T* d2 = a.diff2 ? a.diff2 + t * plane : nullptr;
  T tv = (out[(nz - 1) * plane + col] + dc_b * (fcv_b + wp_b))
         / (hz_c + fcv_b - wm_b - cf_b * (fcv_b + wp_b));
  for (int c = nz - 1; c >= 0; --c) {
    const long o = c * plane + col;
    if (c < nz - 1) tv = dc[o] + cf[o] * tv;
    if (masked) tv = tv * msk;
    T res = tv;
    if (d2 != nullptr) {
      const T* tl = tk + c * plane;
      const T* hzm = a.hz_b + c * plane;
      const T divm = mix_fx(a, d2, hzm, tl, j, ip) - mix_fx(a, d2, hzm, tl, j, i)
                     + mix_fe(a, d2, hzm, tl, jp, i) - mix_fe(a, d2, hzm, tl, j, i);
      res = tv + dtau * pm * divm / a.hz_b[o];
    }
    out[o] = res;
  }
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
  const long field = (long)a.nt * a.nz * a.jy * a.ix;
  a.cf = (T*)p[18];
  a.dc = a.cf + field;
  a.dtau = (T)d[0];
  a.c_tk = (T)d[1];
  a.c_sec = (T)d[2];

  const dim3 block(128);
  const dim3 grid((a.ix + block.x - 1) / block.x, a.jy, a.nt);
  cudaStream_t s = (cudaStream_t)stream;
  switch (scheme) {
    case UPSTREAM3: tracer_stage_kernel<UPSTREAM3, T><<<grid, block, 0, s>>>(a); break;
    case AKIMA: tracer_stage_kernel<AKIMA, T><<<grid, block, 0, s>>>(a); break;
    case CENTERED4: tracer_stage_kernel<CENTERED4, T><<<grid, block, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers: tk, t_sec, flx_u, flx_v, hz_a, hz_b, we, wi, akt, pmn, rmask,
// umask, vmask, stflx (or NULL), diff2 (or NULL: no t3dmix), pmon_u,
// pnom_v, out, scratch (2 * nt*nz*jy*ix).  Ints: nt, nz, jy, ix, imix,
// scheme, corr, masking, ew_periodic, ns_periodic, own_w, own_e, own_s,
// own_n, apply_mask.  Doubles: dtau, c_tk, c_sec.
#define ROMS_TRACER_ENTRY(NAME, T)                                              \
  extern "C" int NAME(                                                          \
      const void* tk, const void* t_sec, const void* flx_u, const void* flx_v, \
      const void* hz_a, const void* hz_b, const void* we, const void* wi,      \
      const void* akt, const void* pmn, const void* rmask, const void* umask,  \
      const void* vmask, const void* stflx, const void* diff2,                 \
      const void* pmon_u, const void* pnom_v, void* out, void* scratch,        \
      int nt, int nz, int jy, int ix, int imix, int scheme, int corr,          \
      int masking, int ew_periodic, int ns_periodic, int own_w, int own_e,     \
      int own_s, int own_n, int apply_mask, double dtau, double c_tk,          \
      double c_sec, void* stream) {                                            \
    const void* p[19] = {tk, t_sec, flx_u, flx_v, hz_a, hz_b, we, wi, akt,    \
                         pmn, rmask, umask, vmask, stflx, diff2, pmon_u,       \
                         pnom_v, out, scratch};                                \
    const int n[15] = {nt, nz, jy, ix, imix, scheme, corr, masking,           \
                       ew_periodic, ns_periodic, own_w, own_e, own_s, own_n,   \
                       apply_mask};                                            \
    const double d[3] = {dtau, c_tk, c_sec};                                  \
    return launch<T>(p, n, d, stream);                                         \
  }

ROMS_TRACER_ENTRY(roms_tracer_stage_f32, float)
ROMS_TRACER_ENTRY(roms_tracer_stage_f64, double)

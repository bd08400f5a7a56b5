// Implicit vertical momentum solve for one velocity component on NVIDIA
// Hopper (sm_90a): a block owns SI consecutive (j, i) columns and keeps
// their whole Thomas elimination in shared memory.
//
// Replaces the TPU kernel roms_tpu/ops/pallas_solve.py (momentum_implicit,
// _kernel).  Per column it runs the Thomas elimination of the implicit
// vertical viscosity + implicit-W advection system, optional implicit
// bottom drag on the bottom diagonal and the surface stress on the top
// right-hand side (reference: pre_step3d4S.F:377-424 / step3d_uv1.F:146-206),
// with the arithmetic of ops/cuda_solve.py:momentum_implicit_plain
// expression by expression: a downward elimination (c = nz-1 .. 1), the
// bottom cell with drag, then the upward back substitution.
//
// What bounds it on this card: device-memory bandwidth by bytes (each
// column reads four nz-deep fields and three 2D fields and writes the
// solution, a handful of flops a byte); in practice the latency of each
// column's chain of dependent level steps.  The design:
//
//  * The column stays on chip.  CF and DC of the elimination go to shared
//    memory, laid out [level][column] (a warp's accesses fall in distinct
//    banks); the back substitution reads them there, and the solution is
//    written once.  No scratch in device memory.
//  * Loads in flight.  rhs, hz_face, akv_face and wi_face stream through a
//    per-thread cp.async ring of RING levels, issued RING - 1 levels ahead
//    of the elimination, so each thread keeps several levels' loads in
//    flight while the dependent chain runs.  A thread reads only what it
//    copied itself, so the ring needs no barrier.
//  * Columns are the flattened (j, i) index: neighbouring threads read
//    neighbouring addresses at every level, and only the last block of the
//    grid is ragged (its spare threads return at once).  A block is one
//    warp: shared memory caps the resident columns of an SM at about 11
//    warps' worth either way, and the small grain keeps the last wave of
//    blocks nearly full.
//
// Shared memory per block: (2 * nz + 4 * RING) * SI elements; at nz = 60
// in float32, 19,456 B.  The launch sizes it from nz (the wrapper,
// ops/cuda_solve.py, caps nz at its NZ_MAX) and allows the kernel that
// much once per device and size.
//
// Entry points (the form of kernel_util.cuh): roms_momentum_solve_f32 /
// _f64 launch on the given stream and return cudaGetLastError();
// roms_momentum_solve_occupancy reports the launch configuration.  Plain
// C, bound by ctypes through roms_tpu_torch/ops/_build.py.

#include <cuda_runtime.h>

#include "kernel_util.cuh"

namespace {

constexpr int SI = 32;     // columns of a block (one warp)
constexpr int RING = 8;    // levels of the per-thread load ring
constexpr int NF = 4;      // fields of a ring slot: rhs, hz, akv, wi

template <typename T>
__device__ __forceinline__ T pos(T a) { return a > T(0) ? a : T(0); }

template <typename T>
__device__ __forceinline__ T neg(T a) { return a < T(0) ? a : T(0); }

__host__ __device__ constexpr int smem_elems(int nz) {
  return (2 * nz + NF * RING) * SI;
}

template <typename T>
__global__ void __launch_bounds__(SI)
momentum_solve_kernel(const T* __restrict__ rhs, const T* __restrict__ hzf,
                      const T* __restrict__ akvf, const T* __restrict__ wif,
                      const T* __restrict__ dc0, const T* __restrict__ sstr,
                      const T* __restrict__ rd, T* __restrict__ out,
                      int nz, long n2, T dtau) {
  extern __shared__ unsigned char smem_raw[];
  T* const s = reinterpret_cast<T*>(smem_raw);
  const int t = threadIdx.x;
  const long col = (long)blockIdx.x * SI + t;
  if (col >= n2) return;
  T* const CF = s + t;                   // CF[c * SI], DC[c * SI]
  T* const DC = s + nz * SI + t;
  T* const ring = s + 2 * nz * SI + t;   // slot q, field f: [(q*NF+f)*SI]

  // group g carries level nz-1-g (a committed empty group past level 0)
  auto issue = [&](int g) {
    const int c = nz - 1 - g;
    if (c >= 0) {
      T* v = ring + (g % RING) * NF * SI;
      const long o = c * n2 + col;
      cp_async(v, rhs + o);
      cp_async(v + SI, hzf + o);
      cp_async(v + 2 * SI, akvf + o);
      cp_async(v + 3 * SI, wif + o);
    }
    cp_async_commit();
  };
  auto slot = [&](int c) { return ring + ((nz - 1 - c) % RING) * NF * SI; };
#pragma unroll
  for (int g = 0; g < RING; ++g) issue(g);

  const T d0 = dc0[col];
  // step g needs levels nz-1-g (all fields) and nz-2-g (hz): groups g and
  // g+1 complete of the RING + g committed
  cp_async_wait<RING - 2>();
  const T* lv = slot(nz - 1);
  const T* lo = slot(nz - 2);

  // top cell c = nz-1; fcv(m) = 2*dtau*akv[m+1] / (hz[m+1] + hz[m])
  T fc_up = T(2) * dtau * lv[2 * SI] / (lv[SI] + lo[SI]);
  T w = d0 * lv[3 * SI];
  T wp_up = pos(w), wm_up = neg(w);
  T cff = T(1) / (lv[SI] + fc_up - wm_up);
  T cf_c = cff * (fc_up + wp_up);
  T dc_c = cff * (lv[0] + dtau * sstr[col]);
  CF[(nz - 1) * SI] = cf_c;
  DC[(nz - 1) * SI] = dc_c;
  issue(RING);

  // downward elimination, cells c = nz-2 .. 1
  for (int c = nz - 2; c >= 1; --c) {
    cp_async_wait<RING - 2>();
    lv = slot(c);
    lo = slot(c - 1);
    const T hz_c = lv[SI];
    const T fc_lo = T(2) * dtau * lv[2 * SI] / (hz_c + lo[SI]);
    w = d0 * lv[3 * SI];
    const T wp_lo = pos(w), wm_lo = neg(w);
    cff = T(1) / (hz_c + fc_lo - wm_lo + fc_up + wp_up
                  - cf_c * (fc_up - wm_up));
    cf_c = cff * (fc_lo + wp_lo);
    dc_c = cff * (lv[0] + dc_c * (fc_up - wm_up));
    CF[c * SI] = cf_c;
    DC[c * SI] = dc_c;
    fc_up = fc_lo;
    wp_up = wp_lo;
    wm_up = wm_lo;
    issue(nz - 1 - c + RING);
  }

  // bottom cell (with implicit drag), then upward back substitution
  cp_async_wait<RING - 2>();
  lv = slot(0);
  T denom = lv[SI] + fc_up + wp_up - cf_c * (fc_up - wm_up);
  if (rd != nullptr) denom = denom + dtau * rd[col];
  T below = (lv[0] + dc_c * (fc_up - wm_up)) / denom;
  cp_async_wait<0>();
  out[col] = below;
  for (int c = 1; c < nz; ++c) {
    below = DC[c * SI] + CF[c * SI] * below;
    out[c * n2 + col] = below;
  }
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, const T*, const T*, const T*,
                          const T*, const T*, T*, int, long, T);

// the kernel with its dynamic shared memory allowed for nz; nullptr if
// refused
template <typename T>
KernelFn<T> prepared(int nz) {
  static int allowed[64] = {};
  KernelFn<T> k = momentum_solve_kernel<T>;
  return nz >= 2 && allow_smem((const void*)k, smem_elems(nz) * (int)sizeof(T),
                               allowed)
      ? k : nullptr;
}

// p: rhs, hz_face, akv_face, wi_face, dc0, sstr, bottom drag (or NULL),
//    out.  n: nz, jy, ix.  d: dtau.  occupancy n: f64, nz.
constexpr Lengths LENGTHS = {8, 3, 1, 2, 5};

template <typename T>
int launch(const void* const* p, const int* n, const double* d,
           void* stream) {
  n = launch_ints(LENGTHS, n);
  if (n == nullptr) return (int)cudaErrorInvalidValue;
  const int nz = n[0];
  KernelFn<T> k = prepared<T>(nz);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const long n2 = (long)n[1] * n[2];
  const dim3 grid((unsigned)((n2 + SI - 1) / SI));
  k<<<grid, SI, smem_elems(nz) * sizeof(T), (cudaStream_t)stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (T*)p[7], nz, n2,
      (T)d[0]);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int nz, int* out) {
  return occupancy_of((const void*)prepared<T>(nz), SI,
                      smem_elems(nz) * (int)sizeof(T), out);
}

}  // namespace

extern "C" int roms_momentum_solve_f32(const void* const* p, const int* n,
                                       const double* d, void* stream) {
  return launch<float>(p, n, d, stream);
}

extern "C" int roms_momentum_solve_f64(const void* const* p, const int* n,
                                       const double* d, void* stream) {
  return launch<double>(p, n, d, stream);
}

// The kernel's launch configuration for (f64, nz) on the current device,
// into out[0..4].
extern "C" int roms_momentum_solve_occupancy(const int* n, int* out) {
  n = occupancy_ints(LENGTHS, n);
  if (n == nullptr) return (int)cudaErrorInvalidValue;
  return n[0] ? occupancy<double>(n[1], out) : occupancy<float>(n[1], out);
}

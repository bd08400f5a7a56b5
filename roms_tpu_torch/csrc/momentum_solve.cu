// Implicit vertical momentum solve for one velocity component, one
// thread per (j, i) column, on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel roms_tpu/ops/pallas_solve.py (momentum_implicit,
// _kernel).  Per column it runs the Thomas elimination of the implicit
// vertical viscosity + implicit-W advection system, optional implicit
// bottom drag on the bottom diagonal and the surface stress on the top
// right-hand side (reference: pre_step3d4S.F:377-424 / step3d_uv1.F:146-206),
// transcribing the arithmetic of roms_tpu/ops/vmix.py:momentum_implicit
// 1:1: a downward elimination (c = nz-1 .. 1), then the upward back
// substitution.
//
// What bounds it on this card: device-memory bandwidth.  Each column
// reads four nz-deep fields (rhs, hz_face, akv_face, wi_face) and three
// 2D fields, and writes the solution, at a handful of flops per byte.
// Threads run along i, so every level's loads and stores coalesce (the
// stride between levels is jy*ix).
//
// What this simple design leaves for later: the elimination's CF lives
// in a scratch tensor and DC in the output buffer, so the solution makes
// a round trip through device memory between the two sweeps; keeping the
// column in registers or shared memory would halve the traffic.  No row
// padding is needed (the TPU kernel's BJ blocking does not carry over):
// the ragged edge of the grid is guarded by a bounds check.
//
// Entry points: roms_momentum_solve_f32 / _f64, plain C, bound by ctypes
// from roms_tpu_torch/ops/cuda_solve.py.  Each launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T pos(T a) { return a > T(0) ? a : T(0); }

template <typename T>
__device__ __forceinline__ T neg(T a) { return a < T(0) ? a : T(0); }

template <typename T>
__global__ void momentum_solve_kernel(
    const T* __restrict__ rhs, const T* __restrict__ hzf,
    const T* __restrict__ akvf, const T* __restrict__ wif,
    const T* __restrict__ dc0, const T* __restrict__ sstr,
    const T* __restrict__ rd, T* __restrict__ out, T* __restrict__ cf,
    int nz, int jy, int ix, T dtau) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (i >= ix || j >= jy) return;
  const long plane = (long)jy * ix;
  const long col = (long)j * ix + i;
  const T d0 = dc0[col];

  // coefficients of interface m+1 (fcv[m], wc[m] of the JAX code)
  auto fcv = [&](int m) {
    return T(2) * dtau * akvf[(m + 1) * plane + col]
           / (hzf[(m + 1) * plane + col] + hzf[m * plane + col]);
  };

  // top cell c = nz-1
  T fc_up = fcv(nz - 2);
  T w = d0 * wif[(nz - 1) * plane + col];
  T wp_up = pos(w), wm_up = neg(w);
  T cff = T(1) / (hzf[(nz - 1) * plane + col] + fc_up - wm_up);
  T cf_c = cff * (fc_up + wp_up);
  T dc_c = cff * (rhs[(nz - 1) * plane + col] + dtau * sstr[col]);
  cf[(nz - 1) * plane + col] = cf_c;
  out[(nz - 1) * plane + col] = dc_c;

  // downward elimination, cells c = nz-2 .. 1
  for (int c = nz - 2; c >= 1; --c) {
    const long o = c * plane + col;
    const T fc_lo = fcv(c - 1);
    w = d0 * wif[c * plane + col];
    const T wp_lo = pos(w), wm_lo = neg(w);
    cff = T(1) / (hzf[o] + fc_lo - wm_lo + fc_up + wp_up
                  - cf_c * (fc_up - wm_up));
    cf_c = cff * (fc_lo + wp_lo);
    dc_c = cff * (rhs[o] + dc_c * (fc_up - wm_up));
    cf[o] = cf_c;
    out[o] = dc_c;
    fc_up = fc_lo;
    wp_up = wp_lo;
    wm_up = wm_lo;
  }

  // bottom cell (with implicit drag), then upward back substitution
  T denom = hzf[col] + fc_up + wp_up - cf_c * (fc_up - wm_up);
  if (rd != nullptr) denom = denom + dtau * rd[col];
  T below = (rhs[col] + dc_c * (fc_up - wm_up)) / denom;
  out[col] = below;
  for (int c = 1; c < nz; ++c) {
    const long o = c * plane + col;
    below = out[o] + cf[o] * below;
    out[o] = below;
  }
}

template <typename T>
int launch(const void* rhs, const void* hzf, const void* akvf,
           const void* wif, const void* dc0, const void* sstr,
           const void* rd, void* out, void* cf, int nz, int jy, int ix,
           double dtau, void* stream) {
  const dim3 block(128);
  const dim3 grid((ix + block.x - 1) / block.x, jy);
  momentum_solve_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)rhs, (const T*)hzf, (const T*)akvf, (const T*)wif,
      (const T*)dc0, (const T*)sstr, (const T*)rd, (T*)out, (T*)cf,
      nz, jy, ix, (T)dtau);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int roms_momentum_solve_f32(
    const void* rhs, const void* hzf, const void* akvf, const void* wif,
    const void* dc0, const void* sstr, const void* rd, void* out, void* cf,
    int nz, int jy, int ix, double dtau, void* stream) {
  return launch<float>(rhs, hzf, akvf, wif, dc0, sstr, rd, out, cf, nz, jy,
                       ix, dtau, stream);
}

extern "C" int roms_momentum_solve_f64(
    const void* rhs, const void* hzf, const void* akvf, const void* wif,
    const void* dc0, const void* sstr, const void* rd, void* out, void* cf,
    int nz, int jy, int ix, double dtau, void* stream) {
  return launch<double>(rhs, hzf, akvf, wif, dc0, sstr, rd, out, cf, nz, jy,
                        ix, dtau, stream);
}

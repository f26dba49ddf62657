// Hand-written Hopper (sm_90a) kernels for hex8 element batches of a mesh
// of general topology (no lattice in the connectivity).
//
// B6 solid_force    replaces fourc_tpu/ops/solid_pallas.py:173 _fwd_kernel
// B7 solid_tangent  replaces fourc_tpu/ops/solid_pallas.py:184 _jvp_kernel
//
// Contract, as the TPU kernels': element batch in, element batch out.
// X, u[, v] and the output are (24, E) arrays, row a*3+i = component i of
// local node a, one column per element.  The gather u[conn] before and the
// assembly into the nodes after are index operations of the caller.
//
// What bounds them on the H100 and what the design does about it: about
// 7-12k flops per element (8 Gauss points of 3x3 algebra, Jacobians
// included) against 288-384 bytes, compute bound in registers, like B4/B5,
// whose Gauss loops they share (lattice_common.cuh: force_gen_element,
// tangent_gen_element).  One thread per element; with the (24, E) layout
// thread e reads and writes address row*E + e, so every row access of a
// warp is one coalesced line.  E need not be a multiple of anything: the
// last block masks its tail (the TPU kernel padded E to tiles of 512 and
// guarded det J of the zero padding; only real elements are visited here).
// The hex8 dN, weight and N tables sit in shared memory, loaded from device
// pointers.  Like B4/B5, B6 can add the consistent mass of u
// (mcoef * sum_g wdet N N^T u) or compute only that (stiff = 0, needs only
// det J), and B7 fuses mcoef * M v into the tangent pass.
//
// Each extern "C" entry point launches on the caller's stream, never
// synchronises, allocates nothing and returns cudaGetLastError() after its
// launch (0 = cudaSuccess).  Templated on float and double.

#include <cuda_runtime.h>

#include "lattice_common.cuh"

namespace fourc {

// column e of a (24, E) array -> xe[a][i]
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, long long E,
                                          long long e, T xe[8][3]) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i) xe[a][i] = x[(a * 3 + i) * E + e];
}

// model: 0 = Neo-Hooke, 1 = St. Venant-Kirchhoff; stiff = 0 skips the force
// (mass-only mode); mcoef = 0 skips the mass
template <typename T>
__global__ void __launch_bounds__(kElemThreads)
solid_force_kernel(const T* __restrict__ X, const T* __restrict__ u,
                   const T* __restrict__ dNg, const T* __restrict__ wg,
                   const T* __restrict__ Ng, T lam, T mu, int model, T mcoef,
                   int stiff, long long E, T* __restrict__ out) {
  __shared__ GeomShared<T> s;
  load_geom(s, dNg, wg, Ng);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  T xe[8][3], ue[8][3], fe[8][3];
  load_rows(X, E, e, xe);
  load_rows(u, E, e, ue);
  force_gen_element(xe, ue, s, lam, mu, model, mcoef, stiff, fe);
  store_fe(fe, e, E, out);
}

template <typename T>
__global__ void __launch_bounds__(kElemThreads)
solid_tangent_kernel(const T* __restrict__ X, const T* __restrict__ u,
                     const T* __restrict__ v, const T* __restrict__ dNg,
                     const T* __restrict__ wg, const T* __restrict__ Ng, T lam,
                     T mu, int model, T mcoef, long long E, T* __restrict__ out) {
  __shared__ GeomShared<T> s;
  load_geom(s, dNg, wg, Ng);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  T xe[8][3], ue[8][3], ve[8][3], fe[8][3];
  load_rows(X, E, e, xe);
  load_rows(u, E, e, ue);
  load_rows(v, E, e, ve);
  tangent_gen_element<T, false>(xe, ue, ve, s, lam, mu, model, mcoef, fe);
  store_fe(fe, e, E, out);
}

template <typename T>
int solid_force(const T* X, const T* u, const T* dN, const T* w, const T* N,
                double lam, double mu, int model, double mcoef, int stiff,
                long long E, T* out, void* stream) {
  solid_force_kernel<T><<<blocks_for(E, kElemThreads), kElemThreads, 0,
                          (cudaStream_t)stream>>>(
      X, u, dN, w, N, (T)lam, (T)mu, model, (T)mcoef, stiff, E, out);
  return (int)cudaGetLastError();
}

template <typename T>
int solid_tangent(const T* X, const T* u, const T* v, const T* dN, const T* w,
                  const T* N, double lam, double mu, int model, double mcoef,
                  long long E, T* out, void* stream) {
  solid_tangent_kernel<T><<<blocks_for(E, kElemThreads), kElemThreads, 0,
                            (cudaStream_t)stream>>>(
      X, u, v, dN, w, N, (T)lam, (T)mu, model, (T)mcoef, E, out);
  return (int)cudaGetLastError();
}

}  // namespace fourc

// ---------------------------------------------------------------------------
// plain C interface (bound with ctypes in fourc_tpu_torch/ops/solid_kernels.py)
// ---------------------------------------------------------------------------

#define FOURC_EXPORT extern "C" __attribute__((visibility("default")))

FOURC_EXPORT int fourc_solid_force_f32(const float* X, const float* u, const float* dN,
                                       const float* w, const float* N, double lam,
                                       double mu, int model, double mcoef, int stiff,
                                       long long E, float* out, void* stream) {
  return fourc::solid_force<float>(X, u, dN, w, N, lam, mu, model, mcoef, stiff, E, out,
                                   stream);
}
FOURC_EXPORT int fourc_solid_force_f64(const double* X, const double* u, const double* dN,
                                       const double* w, const double* N, double lam,
                                       double mu, int model, double mcoef, int stiff,
                                       long long E, double* out, void* stream) {
  return fourc::solid_force<double>(X, u, dN, w, N, lam, mu, model, mcoef, stiff, E, out,
                                    stream);
}
FOURC_EXPORT int fourc_solid_tangent_f32(const float* X, const float* u, const float* v,
                                         const float* dN, const float* w, const float* N,
                                         double lam, double mu, int model, double mcoef,
                                         long long E, float* out, void* stream) {
  return fourc::solid_tangent<float>(X, u, v, dN, w, N, lam, mu, model, mcoef, E, out,
                                     stream);
}
FOURC_EXPORT int fourc_solid_tangent_f64(const double* X, const double* u,
                                         const double* v, const double* dN,
                                         const double* w, const double* N, double lam,
                                         double mu, int model, double mcoef, long long E,
                                         double* out, void* stream) {
  return fourc::solid_tangent<double>(X, u, v, dN, w, N, lam, mu, model, mcoef, E, out,
                                      stream);
}

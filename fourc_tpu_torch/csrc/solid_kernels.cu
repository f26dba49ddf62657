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
// What bounds them on the H100 and what the design does about it: both run
// the lattice kernels' passes by the 12 edges of the element on the columns
// of the batch, since the batch's local node order is the hex8 cell order
// (0,0,0) (1,0,0) (1,1,0) (0,1,0) (0,0,1) (1,0,1) (1,1,1) (0,1,1), the order
// that edge_node and node_edge assume for the lattice: along every edge of
// axis j, dN[a-][j] = -dN[a+][j].
// - B6 is B4's operator and runs B4's pass (force_gen_edge_element): the
//   columns of X and u become 36 edge differences each, the Gauss loop forms
//   J and Hhat(u) from them and gathers w P cof(J) into 36 edge sums, no
//   inverse forms, the Neo-Hooke stress is taken in the cancellation-free
//   deformation-gradient form (stress_neohooke_F), and with the mass det J
//   of the 8 Gauss points rides in registers and u's column is read again
//   after the loop.  4.0k flops per element against 288 bytes (X, u and the
//   output in float32), so its bound is set by bytes (0.0151 ms at n=56).
//   Its first pass (force_gen_element, now in tools/dense_passes.cuh) took
//   the Jacobian, its inverse and the gradients against the 8 corners, about
//   6.8k flops per element, limited by its instruction rate.
// - B7 is B5's operator and runs B5's pass (tangent_gen_edge_element): the
//   columns of X, u and v become 36 edge differences each, the Gauss loop
//   forms J, Hhat(u) and Hhat(v) from them and gathers into 36 edge sums, no
//   inverse forms, the Neo-Hooke tangent is taken in deformation-gradient
//   form, and with the mass det J of the 8 Gauss points rides in registers
//   and v's column is read again after the loop.  5.9k flops per element
//   (6.7k with the mass) against 384 bytes, so its bound is set by bytes
//   (0.0201 ms at n=56).  On an H100 80GB HBM3 at 700 W (float32, n=56, a
//   CUDA graph of calls; tools/b7_b4_variants.py) B7 takes 0.0500-0.0502 ms
//   with the mass and 0.0451-0.0453 without, against 0.0873-0.0877 and
//   0.0834-0.0837 for its first, dense pass (tangent_gen_element, now in
//   tools/dense_passes.cuh) in the same run.
// - B6 the same way (tools/b1_b6_variants.py): Neo-Hooke 0.0327-0.0329 ms
//   against 0.0402-0.0404 for its first pass in the same runs, SVK
//   0.0280-0.0282 against 0.0354-0.0356, mass-only 0.0197-0.0200 against
//   0.0232-0.0234, with the mass 0.0372-0.0377 against 0.0430-0.0433; 46% of
//   its bound with Neo-Hooke.  At 1.55 TB/s and 21.7 TFLOP/s it is held by
//   neither bytes nor operations alone.
// One thread per element; with the (24, E) layout thread e reads and writes
// address row*E + e, so every row access of a warp is one coalesced line.  E
// need not be a multiple of anything: the last block masks its tail (the TPU
// kernel padded E to tiles of 512 and guarded det J of the zero padding;
// only real elements are visited here).  The hex8 tables sit in shared
// memory, loaded from device pointers.  Like B4/B5, B6 can add the
// consistent mass of u (mcoef * sum_g wdet N N^T u) or compute only that
// (stiff = 0, needs only det J), and B7 fuses mcoef * M v into the tangent
// pass.
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

// B6: at least 4 blocks of 128 threads per SM (at most 128 registers, 24-80
// B spilled in float32), as B4.  On an H100 80GB HBM3 at 700 W at n=56
// (tools/b1_b6_variants.py, by a CUDA graph of calls) it beats the
// compiler's own 156-168 registers and at most 168 by 8-11% with the force
// (Neo-Hooke 32.7-32.9 against 35.6-35.8 us, SVK 28.0-28.2 against
// 31.2-31.3, with the mass 37.2-37.7 against 40.8-41.8), and at most 102 is
// 29-69% slower; the mass-only mode (80 registers at every cap) takes
// 19.7-20.1 us at each.
constexpr int kSolidForceMinBlocks = 4;

// B6 by the 12 edges: force_gen_edge_kernel of lattice_kernels.cu on the
// columns of the batch.  kModel: 0 = Neo-Hooke, 1 = St. Venant-Kirchhoff;
// kStiff = false is the mass-only mode (X's column alone, det J only);
// kMass: mcoef sum_g wdet_g N N^T u too, u's column read again after the
// loop.
template <typename T, int kModel, bool kStiff, bool kMass, int kMinBlocks>
__global__ void __launch_bounds__(kElemThreads, kMinBlocks)
solid_force_kernel(const T* __restrict__ X, const T* __restrict__ u,
                   const T* __restrict__ dNg, const T* __restrict__ wg,
                   const T* __restrict__ Ng, T lam, T mu, T mcoef, long long E,
                   T* __restrict__ out) {
  __shared__ GenEdgeShared<T> s;
  load_gen_edge_tables(s, dNg, wg, kMass ? Ng : (const T*)nullptr);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  T dx[3][4][3], du[3][4][3], R[3][4][3], c[8];
  {
    T xe[8][3];
    load_rows(X, E, e, xe);
    edge_diff(xe, dx);
    if constexpr (kStiff) {
      load_rows(u, E, e, xe);
      edge_diff(xe, du);
    }
  }
  force_gen_edge_element<T, kModel, kStiff, kMass>(dx, du, s, lam, mu, R, c);
  T fe[8][3];
  zero_fe(fe);
  if constexpr (kMass) {
    T ue[8][3];
    load_rows(u, E, e, ue);
    mass_gen(ue, s, c, mcoef, fe);
  }
  if constexpr (kStiff) edges_to_nodes(R, fe);
  store_fe(fe, e, E, out);
}

// B6's instantiation from the host's ints: stiff = 0 is the mass-only mode
// (mcoef = 0 there gives zeros), model 0 Neo-Hooke, else SVK
template <typename T, int kMinBlocks>
void launch_solid_force(const T* X, const T* u, const T* dN, const T* w, const T* N,
                        T lam, T mu, int model, T mcoef, int stiff, long long E,
                        T* out, cudaStream_t st) {
  const unsigned int blocks = blocks_for(E, kElemThreads);
  const bool mass = mcoef != T(0);
#define FOURC_SOLID_FORCE(M, S, MS)                                              \
  solid_force_kernel<T, M, S, MS, kMinBlocks><<<blocks, kElemThreads, 0, st>>>( \
      X, u, dN, w, N, lam, mu, mcoef, E, out)
  if (!stiff)
    FOURC_SOLID_FORCE(0, false, true);
  else if (model == 0 && mass)
    FOURC_SOLID_FORCE(0, true, true);
  else if (model == 0)
    FOURC_SOLID_FORCE(0, true, false);
  else if (mass)
    FOURC_SOLID_FORCE(1, true, true);
  else
    FOURC_SOLID_FORCE(1, true, false);
#undef FOURC_SOLID_FORCE
}

// B7: at least 3 blocks of 128 threads per SM (at most 168 registers, 72-104
// B spilled in float32, B5's choice with u).  On an H100 80GB HBM3 at 700 W
// at n=56 (tools/b7_b4_variants.py, by a CUDA graph of calls) it beats the
// compiler's own 212-221 registers by 6-24% (Neo-Hooke with the mass
// 50.0-50.2 against 53.1-53.4 us, SVK 41.9-42.1 against 52.2-52.4) and at
// most 128 (232-264 B spilled) by 21-28%.
constexpr int kSolidTangentMinBlocks = 3;

// kModel: 0 = Neo-Hooke, 1 = St. Venant-Kirchhoff; kMass: mcoef M v too
template <typename T, int kModel, bool kMass, int kMinBlocks>
__global__ void __launch_bounds__(kElemThreads, kMinBlocks)
solid_tangent_kernel(const T* __restrict__ X, const T* __restrict__ u,
                     const T* __restrict__ v, const T* __restrict__ dNg,
                     const T* __restrict__ wg, const T* __restrict__ Ng, T lam,
                     T mu, T mcoef, long long E, T* __restrict__ out) {
  __shared__ GenEdgeShared<T> s;
  load_gen_edge_tables(s, dNg, wg, kMass ? Ng : (const T*)nullptr);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  T dx[3][4][3], du[3][4][3], dv[3][4][3], R[3][4][3], c[8];
  {
    T xe[8][3];
    load_rows(X, E, e, xe);
    edge_diff(xe, dx);
    load_rows(u, E, e, xe);
    edge_diff(xe, du);
    load_rows(v, E, e, xe);
    edge_diff(xe, dv);
  }
  tangent_gen_edge_element<T, kModel, kMass>(dx, du, dv, s, lam, mu, R, c);
  T fe[8][3];
  zero_fe(fe);
  if constexpr (kMass) {
    T ve[8][3];
    load_rows(v, E, e, ve);
    mass_gen(ve, s, c, mcoef, fe);
  }
  edges_to_nodes(R, fe);
  store_fe(fe, e, E, out);
}

// B7's instantiation from the host's ints: model 0 Neo-Hooke, else SVK
template <typename T, int kMinBlocks>
void launch_solid_tangent(const T* X, const T* u, const T* v, const T* dN, const T* w,
                          const T* N, T lam, T mu, int model, T mcoef, long long E,
                          T* out, cudaStream_t st) {
  const unsigned int blocks = blocks_for(E, kElemThreads);
  const bool mass = mcoef != T(0);
#define FOURC_SOLID_TANGENT(M, MS)                                            \
  solid_tangent_kernel<T, M, MS, kMinBlocks><<<blocks, kElemThreads, 0, st>>>( \
      X, u, v, dN, w, N, lam, mu, mcoef, E, out)
  if (model == 0 && mass)
    FOURC_SOLID_TANGENT(0, true);
  else if (model == 0)
    FOURC_SOLID_TANGENT(0, false);
  else if (mass)
    FOURC_SOLID_TANGENT(1, true);
  else
    FOURC_SOLID_TANGENT(1, false);
#undef FOURC_SOLID_TANGENT
}

template <typename T>
int solid_force(const T* X, const T* u, const T* dN, const T* w, const T* N,
                double lam, double mu, int model, double mcoef, int stiff,
                long long E, T* out, void* stream) {
  launch_solid_force<T, kSolidForceMinBlocks>(X, u, dN, w, N, (T)lam, (T)mu, model,
                                              (T)mcoef, stiff, E, out,
                                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

template <typename T>
int solid_tangent(const T* X, const T* u, const T* v, const T* dN, const T* w,
                  const T* N, double lam, double mu, int model, double mcoef,
                  long long E, T* out, void* stream) {
  launch_solid_tangent<T, kSolidTangentMinBlocks>(X, u, v, dN, w, N, (T)lam, (T)mu,
                                                  model, (T)mcoef, E, out,
                                                  (cudaStream_t)stream);
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

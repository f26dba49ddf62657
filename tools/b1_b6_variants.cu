// Variants of B1, the uniform lattice's force, and B6, the element-batch
// force, for timing with tools/b1_b6_variants.py.
//
// It includes fourc_tpu_torch/csrc/lattice_kernels.cu and solid_kernels.cu,
// so the shipped B1 (fourc_force_*) and B6 (fourc_solid_force_*), both by
// the 12 edges of the element, are here too, as "shipped".  Beside them:
// - "old": the passes they replaced, as they were: B1's dense Gauss loop
//   (gradients and accumulation against all 8 corners, the Neo-Hooke stress
//   in material form through C and C^-1, then P = F S) and B6's
//   force_gen_element (the same on general geometry, through the inverse of
//   the Jacobian), both from tools/dense_passes.cuh;
// - "a", "a_lb3", "a_lb" and "a_lb5": the shipped edge kernels
//   (force_elem_kernel, solid_force_kernel) at the compiler's register
//   count, at most 168 registers (__launch_bounds__(128, 3)), at most 128
//   (__launch_bounds__(128, 4)) and at most 102 (__launch_bounds__(128, 5)).
// B6 variants take fourc_solid_force's arguments; B1 variants take
// fourc_force's, with a launcher of the whole B1 (element pass and gather,
// "full") and one of the element pass alone ("elem"; the shipped launcher
// has no such entry and returns cudaErrorInvalidValue there).

#include "lattice_kernels.cu"
#include "solid_kernels.cu"
#include "dense_passes.cuh"

namespace b1b6 {
using namespace fourc;

// B1's element pass before the edge form, as it was.
template <typename T>
__global__ void __launch_bounds__(kElemThreads)
old_force_elem_kernel(const T* __restrict__ u, const T* __restrict__ Gg,
                      const T* __restrict__ wg, T lam, T mu, int model, Dims d,
                      T* __restrict__ scratch) {
  __shared__ GeomShared<T> s;
  load_geom(s, Gg, wg, (const T*)nullptr);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= d.E) return;
  T ue[8][3];
  load_corners(u, d, e, ue);
  T fe[8][3];
  zero_fe(fe);
#pragma unroll 1
  for (int g = 0; g < 8; ++g) {
    T H[3][3], A[3][3], S[3][3], F[3][3], P[3][3];
    grad(ue, s.G[g], H);
    strain_A(H, A);
    if (model == 0) {
      NeoAux<T> aux;
      stress_neohooke(A, lam, mu, S, aux);
    } else {
      stress_svk(A, lam, mu, S);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) F[i][j] = H[i][j] + (i == j ? T(1) : T(0));
    mm(F, S, P);
    accum(P, s.G[g], s.w[g], fe);
  }
  store_fe(fe, e, d.E, scratch);
}

// B6's element pass before the edge form, as it was.
template <typename T>
__global__ void __launch_bounds__(kElemThreads)
old_solid_force_kernel(const T* __restrict__ X, const T* __restrict__ u,
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

// kKind: 0 = old, 1 = the edge kernel at kMinBlocks MB, 2 = the shipped
// launcher
template <typename T, int kKind, int MB>
int b6(const T* X, const T* u, const T* dN, const T* w, const T* N, double lam,
       double mu, int model, double mcoef, int stiff, long long E, T* out,
       void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if constexpr (kKind == 2)
    return solid_force<T>(X, u, dN, w, N, lam, mu, model, mcoef, stiff, E, out, stream);
  else if constexpr (kKind == 0)
    old_solid_force_kernel<T><<<blocks_for(E, kElemThreads), kElemThreads, 0, st>>>(
        X, u, dN, w, N, (T)lam, (T)mu, model, (T)mcoef, stiff, E, out);
  else
    launch_solid_force<T, MB>(X, u, dN, w, N, (T)lam, (T)mu, model, (T)mcoef, stiff,
                              E, out, st);
  return (int)cudaGetLastError();
}

template <typename T, int kKind, int MB>
int b1(const T* u, const T* G, const T* w, double lam, double mu, int model,
       T* scratch, T* out, int nx, int ny, int nz, void* stream, bool with_gather) {
  const Dims d(nx, ny, nz);
  const cudaStream_t st = (cudaStream_t)stream;
  if constexpr (kKind == 2) {
    if (!with_gather) return (int)cudaErrorInvalidValue;
    return force<T>(u, G, w, lam, mu, model, scratch, out, nx, ny, nz, stream);
  } else {
    if constexpr (kKind == 0)
      old_force_elem_kernel<T><<<blocks_for(d.E, kElemThreads), kElemThreads, 0, st>>>(
          u, G, w, (T)lam, (T)mu, model, d, scratch);
    else
      launch_force_edge<T, MB, MB>(u, G, w, (T)lam, (T)mu, model, d, scratch, st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !with_gather) return (int)err;
    gather_kernel<T><<<blocks_for(d.n, kGatherThreads), kGatherThreads, 0, st>>>(
        scratch, d, out);
    return (int)cudaGetLastError();
  }
}

}  // namespace b1b6

#define B1B6_EXPORT extern "C" __attribute__((visibility("default")))
#define B6V_ONE(name, T, sfx, KIND, MB)                                              \
  B1B6_EXPORT int b6v_##name##_##sfx(const T* X, const T* u, const T* dN, const T* w, \
                                     const T* N, double lam, double mu, int model,    \
                                     double mcoef, int stiff, long long E, T* out,    \
                                     void* s) {                                       \
    return b1b6::b6<T, KIND, MB>(X, u, dN, w, N, lam, mu, model, mcoef, stiff, E, out, \
                                 s);                                                  \
  }
#define B6V(name, KIND, MB)           \
  B6V_ONE(name, float, f32, KIND, MB) \
  B6V_ONE(name, double, f64, KIND, MB)
#define B1V_ONE(name, T, sfx, full, KIND, MB)                                          \
  B1B6_EXPORT int b1v_##name##_##sfx(const T* u, const T* G, const T* w, double lam,    \
                                     double mu, int model, T* scratch, T* out, int nx,  \
                                     int ny, int nz, void* s) {                         \
    return b1b6::b1<T, KIND, MB>(u, G, w, lam, mu, model, scratch, out, nx, ny, nz, s, \
                                 full);                                                 \
  }
#define B1V(name, KIND, MB)                        \
  B1V_ONE(name##_full, float, f32, true, KIND, MB)  \
  B1V_ONE(name##_full, double, f64, true, KIND, MB) \
  B1V_ONE(name##_elem, float, f32, false, KIND, MB) \
  B1V_ONE(name##_elem, double, f64, false, KIND, MB)

B6V(old, 0, 1)
B6V(a, 1, 1)
B6V(a_lb3, 1, 3)
B6V(a_lb, 1, 4)
B6V(a_lb5, 1, 5)
B6V(shipped, 2, 1)

B1V(old, 0, 1)
B1V(a, 1, 1)
B1V(a_lb3, 1, 3)
B1V(a_lb, 1, 4)
B1V(a_lb5, 1, 5)
B1V(shipped, 2, 1)

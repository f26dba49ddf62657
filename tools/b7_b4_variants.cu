// Variants of B7, the element-batch tangent, and B4, the general-geometry
// force, for timing with tools/b7_b4_variants.py.
//
// It includes fourc_tpu_torch/csrc/lattice_kernels.cu and solid_kernels.cu,
// so the shipped B7 (fourc_solid_tangent_*) and B4 (fourc_force_gen_*),
// both by the 12 edges of the element, are here too, as "shipped".  Beside
// them:
// - "old": the passes they replaced, as they were: B7's dense Gauss loop
//   tangent_gen_element (Jacobian, inverse and gradients against all 8
//   corners, the Neo-Hooke tangent in material form, the mass at every
//   Gauss point with v's corners live) and B4's force_gen_element (the same
//   for the force, the Neo-Hooke stress through C and C^-1);
// - "a", "a_lb3" and "a_lb": the shipped edge kernels (solid_tangent_kernel,
//   force_gen_edge_kernel) at the compiler's register count, at most 168
//   registers (__launch_bounds__(128, 3)) and at most 128
//   (__launch_bounds__(128, 4)).
// B7 variants take fourc_solid_tangent's arguments; B4 variants take
// fourc_force_gen's, with a launcher of the whole B4 (element pass and
// gather, "full") and one of the element pass alone ("elem"; the shipped
// launcher has no such entry and returns cudaErrorInvalidValue there).

#include "lattice_kernels.cu"
#include "solid_kernels.cu"
#include "dense_passes.cuh"

namespace b7b4 {
using namespace fourc;

// B7's element pass before the edge form, as it was.
template <typename T>
__global__ void __launch_bounds__(kElemThreads)
old_solid_tangent_kernel(const T* __restrict__ X, const T* __restrict__ u,
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

// B4's element pass before the edge form, as it was.
template <typename T>
__global__ void __launch_bounds__(kElemThreads)
old_force_gen_elem_kernel(const T* __restrict__ x, const T* __restrict__ u,
                          const T* __restrict__ dNg, const T* __restrict__ wg,
                          const T* __restrict__ Ng, T lam, T mu, int model, T mcoef,
                          int stiff, Dims d, T* __restrict__ scratch) {
  __shared__ GeomShared<T> s;
  load_geom(s, dNg, wg, Ng);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= d.E) return;
  T xe[8][3], ue[8][3], fe[8][3];
  load_corners(x, d, e, xe);
  load_corners(u, d, e, ue);
  force_gen_element(xe, ue, s, lam, mu, model, mcoef, stiff, fe);
  store_fe(fe, e, d.E, scratch);
}

// kKind: 0 = old, 1 = the edge kernel at kMinBlocks MB, 2 = the shipped
// launcher
template <typename T, int kKind, int MB>
int b7(const T* X, const T* u, const T* v, const T* dN, const T* w, const T* N,
       double lam, double mu, int model, double mcoef, long long E, T* out,
       void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if constexpr (kKind == 2)
    return solid_tangent<T>(X, u, v, dN, w, N, lam, mu, model, mcoef, E, out, stream);
  else if constexpr (kKind == 0)
    old_solid_tangent_kernel<T><<<blocks_for(E, kElemThreads), kElemThreads, 0, st>>>(
        X, u, v, dN, w, N, (T)lam, (T)mu, model, (T)mcoef, E, out);
  else
    launch_solid_tangent<T, MB>(X, u, v, dN, w, N, (T)lam, (T)mu, model, (T)mcoef, E,
                                out, st);
  return (int)cudaGetLastError();
}

template <typename T, int kKind, int MB>
int b4(const T* x, const T* u, const T* dN, const T* w, const T* N, double lam,
       double mu, int model, double mcoef, int stiff, T* scratch, T* out, int nx,
       int ny, int nz, void* stream, bool with_gather) {
  const Dims d(nx, ny, nz);
  const cudaStream_t st = (cudaStream_t)stream;
  if constexpr (kKind == 2) {
    if (!with_gather) return (int)cudaErrorInvalidValue;
    return force_gen<T>(x, u, dN, w, N, lam, mu, model, mcoef, stiff, scratch, out, nx,
                        ny, nz, stream);
  } else {
    if constexpr (kKind == 0)
      old_force_gen_elem_kernel<T><<<blocks_for(d.E, kElemThreads), kElemThreads, 0,
                                     st>>>(x, u, dN, w, N, (T)lam, (T)mu, model,
                                           (T)mcoef, stiff, d, scratch);
    else
      launch_force_gen_edge<T, MB>(x, u, dN, w, N, (T)lam, (T)mu, model, (T)mcoef,
                                   stiff, d, scratch, st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !with_gather) return (int)err;
    gather_kernel<T><<<blocks_for(d.n, kGatherThreads), kGatherThreads, 0, st>>>(
        scratch, d, out);
    return (int)cudaGetLastError();
  }
}

}  // namespace b7b4

#define B7B4_EXPORT extern "C" __attribute__((visibility("default")))
#define B7V_ONE(name, T, sfx, KIND, MB)                                             \
  B7B4_EXPORT int b7v_##name##_##sfx(const T* X, const T* u, const T* v, const T* dN, \
                                     const T* w, const T* N, double lam, double mu,  \
                                     int model, double mcoef, long long E, T* out,   \
                                     void* s) {                                      \
    return b7b4::b7<T, KIND, MB>(X, u, v, dN, w, N, lam, mu, model, mcoef, E, out, s); \
  }
#define B7V(name, KIND, MB)              \
  B7V_ONE(name, float, f32, KIND, MB)    \
  B7V_ONE(name, double, f64, KIND, MB)
#define B4V_ONE(name, T, sfx, full, KIND, MB)                                         \
  B7B4_EXPORT int b4v_##name##_##sfx(const T* x, const T* u, const T* dN, const T* w,  \
                                     const T* N, double lam, double mu, int model,     \
                                     double mcoef, int stiff, T* scratch, T* out,      \
                                     int nx, int ny, int nz, void* s) {                \
    return b7b4::b4<T, KIND, MB>(x, u, dN, w, N, lam, mu, model, mcoef, stiff,         \
                                 scratch, out, nx, ny, nz, s, full);                   \
  }
#define B4V(name, KIND, MB)                            \
  B4V_ONE(name##_full, float, f32, true, KIND, MB)     \
  B4V_ONE(name##_full, double, f64, true, KIND, MB)    \
  B4V_ONE(name##_elem, float, f32, false, KIND, MB)    \
  B4V_ONE(name##_elem, double, f64, false, KIND, MB)

B7V(old, 0, 1)
B7V(a, 1, 1)
B7V(a_lb3, 1, 3)
B7V(a_lb, 1, 4)
B7V(shipped, 2, 1)

B4V(old, 0, 1)
B4V(a, 1, 1)
B4V(a_lb3, 1, 3)
B4V(a_lb, 1, 4)
B4V(shipped, 2, 1)

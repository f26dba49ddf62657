// Variants of the B2 tangent element pass, for timing with
// tools/b2_variants.py.
//
// It includes fourc_tpu_torch/csrc/lattice_kernels.cu, so the shipped
// element pass tangent_elem_kernel is here too: variant "a_lb4", the edge
// differences of u and v held in registers through the Gauss loop, under
// __launch_bounds__(128, 4) (at most 128 registers).  Beside it: the
// element pass it replaced ("old": dense gradients and accumulation against
// all 8 corners, the Neo-Hooke tangent in material form, the mass at every
// Gauss point), "a" (the same as "a_lb4" at the compiler's own register
// count), and "b" and "b_lb4" (the 24 corners held, the edge differences
// formed again at every Gauss point: fewer registers, 72 more flops per
// Gauss point; at the compiler's count and at most 128 registers).  Each
// has a launcher of the whole B2 (element pass and gather) and one of the
// element pass alone; b2v_gather launches gather_kernel alone.

#include "lattice_kernels.cu"
#include "dense_passes.cuh"

namespace b2v {
using namespace fourc;

// The element pass that tangent_elem_kernel replaced, as it was.
template <typename T>
__global__ void __launch_bounds__(kElemThreads)
old_tangent_elem_kernel(const T* __restrict__ u, const T* __restrict__ v,
                        const T* __restrict__ Gg, const T* __restrict__ wg,
                        const T* __restrict__ Ng, T lam, T mu, int model, T mcoef,
                        Dims d, T* __restrict__ scratch) {
  __shared__ GeomShared<T> s;
  load_geom(s, Gg, wg, Ng);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= d.E) return;
  T ue[8][3], ve[8][3];
  load_corners(u, d, e, ue);
  load_corners(v, d, e, ve);
  T fe[8][3];
  zero_fe(fe);
#pragma unroll 1
  for (int g = 0; g < 8; ++g) {
    T H[3][3], Hd[3][3], Pd[3][3];
    grad(ue, s.G[g], H);
    grad(ve, s.G[g], Hd);
    tangent_stress(H, Hd, lam, mu, model, Pd);
    accum(Pd, s.G[g], s.w[g], fe);
    if (mcoef != T(0)) mass_accum(ve, s.N[g], mcoef * s.w[g], fe);
  }
  store_fe(fe, e, d.E, scratch);
}

// An empty asm that "changes" x: it keeps the compiler from hoisting the
// loop-invariant edge differences of variant b out of the Gauss loop
// (which would turn it into variant a).
__device__ __forceinline__ void opaque(float& x) { asm volatile("" : "+f"(x)); }
__device__ __forceinline__ void opaque(double& x) { asm volatile("" : "+d"(x)); }

template <typename T>
__device__ __forceinline__ void grad_corners(T xe[8][3], const T Ge[3][4], T H[3][3]) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i) opaque(xe[a][i]);
  T dx[3][4][3];
  edge_diff(xe, dx);
  grad_edges(dx, Ge, H);
}

// Variant b: tangent_edge_element with the 24 corners of u and v held
// through the Gauss loop instead of their 36 edge differences.
template <typename T, int kModel>
__device__ __forceinline__ void tangent_corner_element(const T* __restrict__ u,
                                                       const T* __restrict__ v,
                                                       const EdgeShared<T>& s, T lam,
                                                       T mu, T mcoef, const Dims& d,
                                                       long long e, T fe[8][3]) {
  T ue[8][3], ve[8][3], R[3][4][3];
  load_corners(u, d, e, ue);
  load_corners(v, d, e, ve);
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) R[j][q][0] = R[j][q][1] = R[j][q][2] = T(0);
#pragma unroll 1
  for (int g = 0; g < 8; ++g) {
    T H[3][3], Hd[3][3], Pd[3][3];
    grad_corners(ue, s.Ge[g], H);
    grad_corners(ve, s.Ge[g], Hd);
    if constexpr (kModel == 0)
      tangent_neohooke_F(H, Hd, lam, mu, Pd);
    else
      tangent_stress(H, Hd, lam, mu, 1, Pd);
    accum_edges(Pd, s.Ge[g], s.w[g], R);
  }
  zero_fe(fe);
  if (mcoef != T(0)) mass_table(ve, s.Mc, fe);
  edges_to_nodes(R, fe);
}

template <typename T, int kModel, int MB, bool kHoldEdges>
__global__ void __launch_bounds__(kElemThreads, MB)
variant(const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ Gg,
        const T* __restrict__ wg, const T* __restrict__ Ng, T lam, T mu, T mcoef,
        Dims d, T* __restrict__ scratch) {
  __shared__ EdgeShared<T> s;
  load_edge_tables(s, Gg, wg, Ng, mcoef);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= d.E) return;
  T fe[8][3];
  if constexpr (kHoldEdges)
    tangent_edge_element<T, kModel>(u, v, s, lam, mu, mcoef, d, e, fe);
  else
    tangent_corner_element<T, kModel>(u, v, s, lam, mu, mcoef, d, e, fe);
  store_fe(fe, e, d.E, scratch);
}

template <typename T>
int gather(const T* scratch, T* out, const Dims& d, cudaStream_t st) {
  gather_kernel<T><<<blocks_for(d.n, kGatherThreads), kGatherThreads, 0, st>>>(
      scratch, d, out);
  return (int)cudaGetLastError();
}

// kind: 0 = old, 1 = shipped (a_lb4), 2 = variant<MB, kHoldEdges>
template <typename T, int kKind, int MB, bool kHoldEdges>
int launch(const T* u, const T* v, const T* G, const T* w, const T* N, double lam,
           double mu, int model, double mcoef, T* scratch, T* out, int nx, int ny,
           int nz, void* stream, bool with_gather) {
  const Dims d(nx, ny, nz);
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned int blocks = blocks_for(d.E, kElemThreads);
  const T l = (T)lam, m = (T)mu, c = (T)mcoef;
  if constexpr (kKind == 0)
    old_tangent_elem_kernel<T><<<blocks, kElemThreads, 0, st>>>(
        u, v, G, w, N, l, m, model, c, d, scratch);
  else if constexpr (kKind == 1) {
    if (model == 0)
      tangent_elem_kernel<T, 0><<<blocks, kElemThreads, 0, st>>>(u, v, G, w, N, l,
                                                                 m, c, d, scratch);
    else
      tangent_elem_kernel<T, 1><<<blocks, kElemThreads, 0, st>>>(u, v, G, w, N, l,
                                                                 m, c, d, scratch);
  } else {
    if (model == 0)
      variant<T, 0, MB, kHoldEdges><<<blocks, kElemThreads, 0, st>>>(
          u, v, G, w, N, l, m, c, d, scratch);
    else
      variant<T, 1, MB, kHoldEdges><<<blocks, kElemThreads, 0, st>>>(
          u, v, G, w, N, l, m, c, d, scratch);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !with_gather) return (int)err;
  return gather(scratch, out, d, st);
}

}  // namespace b2v

#define B2V_EXPORT extern "C" __attribute__((visibility("default")))
#define B2V_ONE(name, T, sfx, full, KIND, MB, HOLD)                              \
  B2V_EXPORT int b2v_##name##_##sfx(const T* u, const T* v, const T* G,         \
                                    const T* w, const T* N, double lam,         \
                                    double mu, int model, double mcoef,         \
                                    T* scratch, T* out, int nx, int ny, int nz, \
                                    void* s) {                                  \
    return b2v::launch<T, KIND, MB, HOLD>(u, v, G, w, N, lam, mu, model, mcoef, \
                                          scratch, out, nx, ny, nz, s, full);   \
  }
#define B2V(name, KIND, MB, HOLD)                                     \
  B2V_ONE(name##_full, float, f32, true, KIND, MB, HOLD)              \
  B2V_ONE(name##_full, double, f64, true, KIND, MB, HOLD)             \
  B2V_ONE(name##_elem, float, f32, false, KIND, MB, HOLD)             \
  B2V_ONE(name##_elem, double, f64, false, KIND, MB, HOLD)

B2V(old, 0, 1, true)
B2V(a, 2, 1, true)
B2V(a_lb4, 1, 4, true)
B2V(b, 2, 1, false)
B2V(b_lb4, 2, 4, false)

B2V_EXPORT int b2v_gather_f32(const float* scratch, float* out, int nx, int ny,
                              int nz, void* s) {
  return b2v::gather<float>(scratch, out, fourc::Dims(nx, ny, nz), (cudaStream_t)s);
}
B2V_EXPORT int b2v_gather_f64(const double* scratch, double* out, int nx, int ny,
                              int nz, void* s) {
  return b2v::gather<double>(scratch, out, fourc::Dims(nx, ny, nz), (cudaStream_t)s);
}

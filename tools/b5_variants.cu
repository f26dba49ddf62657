// Variants of the B5 general-geometry tangent element pass, for timing with
// tools/b5_variants.py.
//
// It includes fourc_tpu_torch/csrc/lattice_kernels.cu, so the shipped B5
// (fourc_tangent_gen_*: the element pass by the 12 edges, and in the linear
// mode on few elements the Gauss-point mapping) is here too, as "shipped".
// Beside it:
// - "old": the element pass that tangent_gen_edge_kernel replaced, as it
//   was (dense Gauss loop tangent_gen_element: Jacobian, inverse and
//   gradients against all 8 corners, the Neo-Hooke tangent in material
//   form, the mass at every Gauss point with v's corners live);
// - "a", "a_lb3" and "a_lb": tangent_gen_edge_kernel, the edge differences
//   of x, v and u held through the Gauss loop, at the compiler's register
//   count, at most 168 registers (__launch_bounds__(128, 3)) and at most 128
//   (__launch_bounds__(128, 4));
// - "b", "b_lb3" and "b_lb": the same with x held as its 24 corners, x's
//   edge differences formed again at every Gauss point;
// - "c": tangent_gen_gp_kernel, 8 lanes per element, one Gauss point each
//   (linear mode without the mass only).
// The per-thread variants are instantiated for the linear mode, Neo-Hooke
// with and without the mass and SVK with the mass; another case returns
// cudaErrorInvalidValue.  Each variant has a launcher of the whole B5
// (element pass and gather) and one of the element pass alone; b5v_gather
// launches gather_kernel alone.

#include "lattice_kernels.cu"

namespace b5v {
using namespace fourc;

// The element pass that tangent_gen_edge_kernel replaced, as it was.
template <typename T, bool kLinear>
__global__ void __launch_bounds__(kElemThreads)
old_tangent_gen_elem_kernel(const T* __restrict__ x, const T* __restrict__ u,
                            const T* __restrict__ v, const T* __restrict__ dNg,
                            const T* __restrict__ wg, const T* __restrict__ Ng, T lam,
                            T mu, int model, T mcoef, Dims d, T* __restrict__ scratch) {
  __shared__ GeomShared<T> s;
  load_geom(s, dNg, wg, Ng);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= d.E) return;
  T xe[8][3], ue[8][3], ve[8][3], fe[8][3];
  load_corners(x, d, e, xe);
  if constexpr (!kLinear) load_corners(u, d, e, ue);
  load_corners(v, d, e, ve);
  tangent_gen_element<T, kLinear>(xe, ue, ve, s, lam, mu, model, mcoef, fe);
  store_fe(fe, e, d.E, scratch);
}

// An empty asm that "changes" x: it keeps the compiler from hoisting the
// loop-invariant edge differences of variant b out of the Gauss loop
// (which would turn it into variant a).
__device__ __forceinline__ void opaque(float& x) { asm volatile("" : "+f"(x)); }
__device__ __forceinline__ void opaque(double& x) { asm volatile("" : "+d"(x)); }

// Variant b: tangent_gen_edge_kernel with x's 24 corners held through the
// Gauss loop instead of its 36 edge differences.
template <typename T, int kModel, bool kMass, int kMinBlocks>
__global__ void __launch_bounds__(kElemThreads, kMinBlocks)
corner_kernel(const T* __restrict__ x, const T* __restrict__ u,
              const T* __restrict__ v, const T* __restrict__ dNg,
              const T* __restrict__ wg, const T* __restrict__ Ng, T lam, T mu,
              T mcoef, Dims d, T* __restrict__ scratch) {
  __shared__ GenEdgeShared<T> s;
  load_gen_edge_tables(s, dNg, wg, Ng);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= d.E) return;
  T xe[8][3], du[3][4][3], dv[3][4][3], R[3][4][3], c[8];
  {
    T ye[8][3];
    if constexpr (kModel != kLinear) {
      load_corners(u, d, e, ye);
      edge_diff(ye, du);
    }
    load_corners(v, d, e, ye);
    edge_diff(ye, dv);
  }
  load_corners(x, d, e, xe);
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) R[j][q][0] = R[j][q][1] = R[j][q][2] = T(0);
#pragma unroll 1
  for (int g = 0; g < 8; ++g) {
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int i = 0; i < 3; ++i) opaque(xe[a][i]);
    T dx[3][4][3], J[3][3], Q[3][3];
    edge_diff(xe, dx);
    grad_edges(dx, s.Ge[g], J);
    const T det = tangent_gen_gp<T, kModel>(J, du, dv, s.Ge[g], s.w[g], lam, mu, Q);
    accum_edges(Q, s.Ge[g], T(1), R);
    if constexpr (kMass) {
#pragma unroll
      for (int k = 7; k > 0; --k) c[k] = c[k - 1];
      c[0] = det;
    }
  }
  T fe[8][3];
  zero_fe(fe);
  if constexpr (kMass) {
    T ve[8][3];
    load_corners(v, d, e, ve);
    mass_gen(ve, s, c, mcoef, fe);
  }
  edges_to_nodes(R, fe);
  store_fe(fe, e, d.E, scratch);
}

template <typename T>
int gather(const T* scratch, T* out, const Dims& d, cudaStream_t st) {
  gather_kernel<T><<<blocks_for(d.n, kGatherThreads), kGatherThreads, 0, st>>>(
      scratch, d, out);
  return (int)cudaGetLastError();
}

// kind: 0 = old, 1 = tangent_gen_edge_kernel<MB> (a, a_lb3, a_lb),
// 2 = corner_kernel<MB> (b, b_lb3, b_lb), 3 = tangent_gen_gp_kernel (c),
// 4 = the shipped launcher
template <typename T, int kKind, int MB, int kModel, bool kMass>
void per_thread(const T* x, const T* u, const T* v, const T* G, const T* w,
                const T* N, T l, T m, T c, const Dims& d, T* scratch, cudaStream_t st) {
  const unsigned int blocks = blocks_for(d.E, kElemThreads);
  if constexpr (kKind == 1)
    tangent_gen_edge_kernel<T, kModel, kMass, MB><<<blocks, kElemThreads, 0, st>>>(
        x, u, v, G, w, N, l, m, c, d, scratch);
  else
    corner_kernel<T, kModel, kMass, MB><<<blocks, kElemThreads, 0, st>>>(
        x, u, v, G, w, N, l, m, c, d, scratch);
}

template <typename T, int kKind, int MB>
int launch(const T* x, const T* u, const T* v, const T* G, const T* w, const T* N,
           double lam, double mu, int model, double mcoef, T* scratch, T* out,
           int nx, int ny, int nz, void* stream, bool with_gather) {
  const Dims d(nx, ny, nz);
  const cudaStream_t st = (cudaStream_t)stream;
  const T l = (T)lam, m = (T)mu, c = (T)mcoef;
  const bool mass = mcoef != 0.0;
  if constexpr (kKind == 4) {
    if (with_gather)
      return tangent_gen<T>(x, u, v, G, w, N, lam, mu, model, mcoef, scratch, out, nx,
                            ny, nz, stream);
    return (int)cudaErrorInvalidValue;
  } else if constexpr (kKind == 0) {
    const unsigned int blocks = blocks_for(d.E, kElemThreads);
    if (u == nullptr)
      old_tangent_gen_elem_kernel<T, true><<<blocks, kElemThreads, 0, st>>>(
          x, u, v, G, w, N, l, m, model, c, d, scratch);
    else
      old_tangent_gen_elem_kernel<T, false><<<blocks, kElemThreads, 0, st>>>(
          x, u, v, G, w, N, l, m, model, c, d, scratch);
  } else if constexpr (kKind == 3) {
    if (u != nullptr || mass) return (int)cudaErrorInvalidValue;
    tangent_gen_gp_kernel<T><<<blocks_for(d.E, kGpElems), kElemThreads, 0, st>>>(
        x, v, G, w, l, m, d, scratch);
  } else {
    if (u == nullptr && !mass)
      per_thread<T, kKind, MB, kLinear, false>(x, u, v, G, w, N, l, m, c, d, scratch, st);
    else if (u != nullptr && model == 0 && !mass)
      per_thread<T, kKind, MB, 0, false>(x, u, v, G, w, N, l, m, c, d, scratch, st);
    else if (u != nullptr && model == 0)
      per_thread<T, kKind, MB, 0, true>(x, u, v, G, w, N, l, m, c, d, scratch, st);
    else if (u != nullptr && mass)
      per_thread<T, kKind, MB, 1, true>(x, u, v, G, w, N, l, m, c, d, scratch, st);
    else
      return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !with_gather) return (int)err;
  return gather(scratch, out, d, st);
}

}  // namespace b5v

#define B5V_EXPORT extern "C" __attribute__((visibility("default")))
#define B5V_ONE(name, T, sfx, full, KIND, MB)                                        \
  B5V_EXPORT int b5v_##name##_##sfx(const T* x, const T* u, const T* v, const T* G, \
                                    const T* w, const T* N, double lam, double mu,  \
                                    int model, double mcoef, T* scratch, T* out,    \
                                    int nx, int ny, int nz, void* s) {              \
    return b5v::launch<T, KIND, MB>(x, u, v, G, w, N, lam, mu, model, mcoef,        \
                                    scratch, out, nx, ny, nz, s, full);             \
  }
#define B5V(name, KIND, MB)                      \
  B5V_ONE(name##_full, float, f32, true, KIND, MB)   \
  B5V_ONE(name##_full, double, f64, true, KIND, MB)  \
  B5V_ONE(name##_elem, float, f32, false, KIND, MB)  \
  B5V_ONE(name##_elem, double, f64, false, KIND, MB)

B5V(old, 0, 1)
B5V(a, 1, 1)
B5V(a_lb3, 1, 3)
B5V(a_lb, 1, 4)
B5V(b, 2, 1)
B5V(b_lb3, 2, 3)
B5V(b_lb, 2, 4)
B5V(c, 3, 1)
B5V(shipped, 4, 1)

B5V_EXPORT int b5v_gather_f32(const float* scratch, float* out, int nx, int ny,
                              int nz, void* s) {
  return b5v::gather<float>(scratch, out, fourc::Dims(nx, ny, nz), (cudaStream_t)s);
}
B5V_EXPORT int b5v_gather_f64(const double* scratch, double* out, int nx, int ny,
                              int nz, void* s) {
  return b5v::gather<double>(scratch, out, fourc::Dims(nx, ny, nz), (cudaStream_t)s);
}

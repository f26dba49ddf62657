// Hand-written Hopper (sm_90a) kernels for the hex8 lattice.
//
// Layout: one padded, component-first lattice (3, X, Y, Z) with
// X = nx + 3, Y = ny + 3, Z = nz + 3 for an nx*ny*nz element box: real node
// (i, j, k) at [c, 1+i, 1+j, 1+k], a zero ghost shell around it.  Real
// element (ex, ey, ez) has its local node 0 at padded node
// (1+ex, 1+ey, 1+ez).  Every kernel writes the whole output lattice,
// ghost shell included (as zeros), so outputs need no memset.
//
// B3 stencil      replaces fourc_tpu/ops/lattice_pallas.py:90 _stencil_kernel
// B1 force        replaces fourc_tpu/ops/lattice_pallas.py:164 _force_kernel
// B2 tangent      replaces fourc_tpu/ops/lattice_pallas.py:189 _jvp_kernel
// B4 force_gen    replaces fourc_tpu/ops/lattice_pallas.py:285 _force_kernel_gen
// B5 tangent_gen  replaces fourc_tpu/ops/lattice_pallas.py:331 _jvp_kernel_gen
//
// What bounds them on the H100 and what the design does about it:
// - B3 is a 24x24 block stencil: 576 FMAs per node (the assembled operator
//   needs 243, 27 neighbour blocks of 3x3, but the kernel walks the 8
//   elements' blocks, which overlap) against 27*3 loads and 3 stores.
//   One thread per OUTPUT node gathers its <= 8 real elements,
//   so there are no atomics and the sum order is fixed (deterministic).
//   The stencil K (576 values) sits in shared memory, loaded from a device
//   pointer, because each GMG level has its own K.  The neighbour loads
//   repeat across the 8 elements and rely on L1/L2; at ~1M dofs it should
//   be bound by the load path, not by FMAs.
// - B1/B2 do ~2-4k flops per element (8 Gauss points of 3x3 algebra),
//   compute bound in registers.  One thread per REAL element computes the
//   24-value element vector and writes it to a scratch buffer stored
//   (24, E) so neighbouring threads write neighbouring addresses.  A second
//   gather pass (one thread per node, <= 8 elements) sums it into the
//   nodes.  Two passes keep the result deterministic without atomics; the
//   TPU kernel kept the element vectors in VMEM, and fusing the passes is
//   later work.  B2 fuses the consistent-mass term mcoef * sum_g wdet N N^T v
//   into the same element pass, as _jvp_kernel does.
// - B4/B5 are B1/B2 on general geometry (box topology, arbitrary node
//   positions): the element's 8 corner coordinates are read from a
//   coordinate lattice x in the same layout, and each Gauss point's
//   Jacobian, its inverse and determinant are computed in registers, as
//   _geom_gp does on the TPU; no per-element geometry table is stored
//   (an (E, 8, 8, 3) table of gradients would be 290 MB at n=72).  The
//   cartesian gradients G_a = Jinv^T dN_a are never formed either: the
//   displacement gradient is H = Hhat Jinv with the reference gradient
//   Hhat = sum_a u_a dN_a^T, and the element vector is accumulated as
//   fe_a += wdet (P Jinv^T) dN_a, which keeps 24 values of G out of the
//   registers.  Geometry adds ~30% to the flops of B1/B2; they stay compute
//   bound.  B4 has a mass-only mode (the consistent mass of the general
//   mesh, which needs only det J: no cofactor, no inverse) and B5 a linear
//   mode (u = 0, no u read) that is the exact-geometry GMG level operator.
//   The hex8 dN, weight and N tables sit in shared
//   memory, loaded from a device pointer.
//
// Each extern "C" entry point launches on the caller's stream, never
// synchronises, allocates nothing and returns cudaGetLastError() after its
// launches (0 = cudaSuccess).  Templated on float and double.

#include <cuda_runtime.h>

#include "lattice_common.cuh"

namespace fourc {

constexpr int kStencilThreads = 256;
constexpr int kElemThreads = 128;
constexpr int kGatherThreads = 256;

struct Dims {
  int nx, ny, nz;      // real elements per axis
  int X, Y, Z;         // padded lattice extents
  long long n;         // X * Y * Z (one component plane)
  long long E;         // nx * ny * nz
  __host__ __device__ Dims(int nx_, int ny_, int nz_)
      : nx(nx_), ny(ny_), nz(nz_), X(nx_ + 3), Y(ny_ + 3), Z(nz_ + 3),
        n((long long)(nx_ + 3) * (ny_ + 3) * (nz_ + 3)),
        E((long long)nx_ * ny_ * nz_) {}
  __device__ __forceinline__ long long node(int i, int j, int k) const {
    return ((long long)i * Y + j) * Z + k;
  }
};

// ---------------------------------------------------------------------------
// B3: y = A v for a uniform (8,3,8,3) node-block stencil K[a,i,b,j]
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kStencilThreads)
stencil_kernel(const T* __restrict__ Kg, const T* __restrict__ v,
               T* __restrict__ out, Dims d) {
  __shared__ T K[576];
  for (int t = threadIdx.x; t < 576; t += blockDim.x) K[t] = Kg[t];
  __syncthreads();
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= d.n) return;
  const int k = (int)(p % d.Z);
  const int j = (int)((p / d.Z) % d.Y);
  const int i = (int)(p / ((long long)d.Y * d.Z));
  T s0 = T(0), s1 = T(0), s2 = T(0);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    // element whose local node a is this node; its node 0 is at (bx,by,bz)
    const int bx = i - ox(a), by = j - oy(a), bz = k - oz(a);
    if (bx < 1 || bx > d.nx || by < 1 || by > d.ny || bz < 1 || bz > d.nz)
      continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const long long q = d.node(bx + ox(b), by + oy(b), bz + oz(b));
      const T v0 = v[q], v1 = v[d.n + q], v2 = v[2 * d.n + q];
      const T* Kab = K + (a * 3) * 24 + b * 3;  // K[a,0,b,0]
      s0 += Kab[0] * v0 + Kab[1] * v1 + Kab[2] * v2;
      s1 += Kab[24] * v0 + Kab[25] * v1 + Kab[26] * v2;
      s2 += Kab[48] * v0 + Kab[49] * v1 + Kab[50] * v2;
    }
  }
  out[p] = s0;
  out[d.n + p] = s1;
  out[2 * d.n + p] = s2;
}

// ---------------------------------------------------------------------------
// B1 / B2 element pass: one thread per real element
// ---------------------------------------------------------------------------

// geometry tables in shared memory: G[g][a][j] (192), wdet[g] (8), N[g][a] (64)
template <typename T>
struct GeomShared {
  T G[8][8][3];
  T w[8];
  T N[8][8];
};

template <typename T>
__device__ __forceinline__ void load_geom(GeomShared<T>& s, const T* G, const T* w,
                                          const T* N) {
  for (int t = threadIdx.x; t < 192; t += blockDim.x) (&s.G[0][0][0])[t] = G[t];
  for (int t = threadIdx.x; t < 8; t += blockDim.x) s.w[t] = w[t];
  if (N != nullptr)
    for (int t = threadIdx.x; t < 64; t += blockDim.x) (&s.N[0][0])[t] = N[t];
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void load_corners(const T* __restrict__ x, const Dims& d,
                                             long long e, T xe[8][3]) {
  const int ez = (int)(e % d.nz);
  const int ey = (int)((e / d.nz) % d.ny);
  const int ex = (int)(e / ((long long)d.ny * d.nz));
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const long long q = d.node(1 + ex + ox(a), 1 + ey + oy(a), 1 + ez + oz(a));
#pragma unroll
    for (int c = 0; c < 3; ++c) xe[a][c] = x[c * d.n + q];
  }
}

template <typename T>
__device__ __forceinline__ void grad(const T xe[8][3], const T G[8][3], T H[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T s = T(0);
#pragma unroll
      for (int a = 0; a < 8; ++a) s += xe[a][i] * G[a][j];
      H[i][j] = s;
    }
}

// fe[a][i] += wg * sum_j P[i][j] G[a][j]
template <typename T>
__device__ __forceinline__ void accum(const T P[3][3], const T G[8][3], T wg,
                                      T fe[8][3]) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      fe[a][i] += wg * (P[i][0] * G[a][0] + P[i][1] * G[a][1] + P[i][2] * G[a][2]);
}

template <typename T>
__device__ __forceinline__ void store_fe(const T fe[8][3], long long e, long long E,
                                         T* __restrict__ scratch) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i) scratch[(a * 3 + i) * E + e] = fe[a][i];
}

// consistent mass of one Gauss point: fe[a] += c N[a] (sum_b N[b] ve[b])
template <typename T>
__device__ __forceinline__ void mass_accum(const T ve[8][3], const T N[8], T c,
                                           T fe[8][3]) {
  T vbar[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int b = 0; b < 8; ++b)
#pragma unroll
    for (int k = 0; k < 3; ++k) vbar[k] += N[b] * ve[b][k];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const T ca = c * N[a];
#pragma unroll
    for (int k = 0; k < 3; ++k) fe[a][k] += ca * vbar[k];
  }
}

template <typename T>
__device__ __forceinline__ void zero_fe(T fe[8][3]) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i) fe[a][i] = T(0);
}

// model: 0 = Neo-Hooke, 1 = St. Venant-Kirchhoff
template <typename T>
__global__ void __launch_bounds__(kElemThreads)
force_elem_kernel(const T* __restrict__ u, const T* __restrict__ Gg,
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

template <typename T>
__global__ void __launch_bounds__(kElemThreads)
tangent_elem_kernel(const T* __restrict__ u, const T* __restrict__ v,
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

// ---------------------------------------------------------------------------
// B4 / B5 element pass on general geometry: one thread per real element
// (shared tables: s.G holds the reference gradients dN[g][a][j], not G)
// ---------------------------------------------------------------------------

// Jinv and det of J = sum_a x_a dN_a^T (J_ij = dx_i / dxi_j)
template <typename T>
__device__ __forceinline__ void jacobian(const T xe[8][3], const T dN[8][3],
                                         T Jinv[3][3], T& det) {
  T J[3][3], C[3][3];
  grad(xe, dN, J);
  cof3(J, C);
  det = det3(J);
  inv_from_cof(C, det, Jinv);
}

// cartesian gradient H = (sum_a ue_a dN_a^T) Jinv
template <typename T>
__device__ __forceinline__ void grad_gen(const T ue[8][3], const T dN[8][3],
                                         const T Jinv[3][3], T H[3][3]) {
  T Hh[3][3];
  grad(ue, dN, Hh);
  mm(Hh, Jinv, H);
}

// fe_a += wdet P G_a with G_a = Jinv^T dN_a, as fe_a += wdet (P Jinv^T) dN_a
template <typename T>
__device__ __forceinline__ void accum_gen(const T P[3][3], const T Jinv[3][3],
                                          const T dN[8][3], T wdet, T fe[8][3]) {
  T Q[3][3];
  mm_abt(P, Jinv, Q);
  accum(Q, dN, wdet, fe);
}

// model: 0 = Neo-Hooke, 1 = St. Venant-Kirchhoff; stiff = 0 skips the force
// (mass-only mode); mcoef = 0 skips the mass
template <typename T>
__global__ void __launch_bounds__(kElemThreads)
force_gen_elem_kernel(const T* __restrict__ x, const T* __restrict__ u,
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
  zero_fe(fe);
#pragma unroll 1
  for (int g = 0; g < 8; ++g) {
    T J[3][3];
    grad(xe, s.G[g], J);
    const T det = det3(J);
    const T wdet = det * s.w[g];
    if (stiff) {  // the mass needs only det J
      T C[3][3], Jinv[3][3], H[3][3], A[3][3], S[3][3], F[3][3], P[3][3];
      cof3(J, C);
      inv_from_cof(C, det, Jinv);
      grad_gen(ue, s.G[g], Jinv, H);
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
      accum_gen(P, Jinv, s.G[g], wdet, fe);
    }
    if (mcoef != T(0)) mass_accum(ue, s.N[g], mcoef * wdet, fe);
  }
  store_fe(fe, e, d.E, scratch);
}

// kLinear: u = 0 (u is not read), where every law is linear elasticity,
// Pd = lam tr(Hd) I + mu (Hd + Hd^T)
template <typename T, bool kLinear>
__global__ void __launch_bounds__(kElemThreads)
tangent_gen_elem_kernel(const T* __restrict__ x, const T* __restrict__ u,
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
  zero_fe(fe);
#pragma unroll 1
  for (int g = 0; g < 8; ++g) {
    T Jinv[3][3], det;
    jacobian(xe, s.G[g], Jinv, det);
    const T wdet = det * s.w[g];
    T Hd[3][3], Pd[3][3];
    grad_gen(ve, s.G[g], Jinv, Hd);
    if constexpr (kLinear) {
      T Ad[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) Ad[i][j] = Hd[i][j] + Hd[j][i];
      stress_svk(Ad, lam, mu, Pd);
    } else {
      T H[3][3];
      grad_gen(ue, s.G[g], Jinv, H);
      tangent_stress(H, Hd, lam, mu, model, Pd);
    }
    accum_gen(Pd, Jinv, s.G[g], wdet, fe);
    if (mcoef != T(0)) mass_accum(ve, s.N[g], mcoef * wdet, fe);
  }
  store_fe(fe, e, d.E, scratch);
}

// ---------------------------------------------------------------------------
// B1 / B2 / B4 / B5 gather pass: one thread per node sums its <= 8 element
// vectors
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const T* __restrict__ scratch, Dims d, T* __restrict__ out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= d.n) return;
  const int k = (int)(p % d.Z);
  const int j = (int)((p / d.Z) % d.Y);
  const int i = (int)(p / ((long long)d.Y * d.Z));
  T s0 = T(0), s1 = T(0), s2 = T(0);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int ex = i - 1 - ox(a), ey = j - 1 - oy(a), ez = k - 1 - oz(a);
    if (ex < 0 || ex >= d.nx || ey < 0 || ey >= d.ny || ez < 0 || ez >= d.nz)
      continue;
    const long long e = ((long long)ex * d.ny + ey) * d.nz + ez;
    s0 += scratch[(a * 3 + 0) * d.E + e];
    s1 += scratch[(a * 3 + 1) * d.E + e];
    s2 += scratch[(a * 3 + 2) * d.E + e];
  }
  out[p] = s0;
  out[d.n + p] = s1;
  out[2 * d.n + p] = s2;
}

inline unsigned int blocks_for(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

template <typename T>
int stencil(const T* K, const T* v, T* out, int nx, int ny, int nz, void* stream) {
  const Dims d(nx, ny, nz);
  stencil_kernel<T><<<blocks_for(d.n, kStencilThreads), kStencilThreads, 0,
                      (cudaStream_t)stream>>>(K, v, out, d);
  return (int)cudaGetLastError();
}

template <typename T>
int force(const T* u, const T* G, const T* w, double lam, double mu, int model,
          T* scratch, T* out, int nx, int ny, int nz, void* stream) {
  const Dims d(nx, ny, nz);
  const cudaStream_t st = (cudaStream_t)stream;
  force_elem_kernel<T><<<blocks_for(d.E, kElemThreads), kElemThreads, 0, st>>>(
      u, G, w, (T)lam, (T)mu, model, d, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gather_kernel<T><<<blocks_for(d.n, kGatherThreads), kGatherThreads, 0, st>>>(
      scratch, d, out);
  return (int)cudaGetLastError();
}

template <typename T>
int tangent(const T* u, const T* v, const T* G, const T* w, const T* N, double lam,
            double mu, int model, double mcoef, T* scratch, T* out, int nx, int ny,
            int nz, void* stream) {
  const Dims d(nx, ny, nz);
  const cudaStream_t st = (cudaStream_t)stream;
  tangent_elem_kernel<T><<<blocks_for(d.E, kElemThreads), kElemThreads, 0, st>>>(
      u, v, G, w, N, (T)lam, (T)mu, model, (T)mcoef, d, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gather_kernel<T><<<blocks_for(d.n, kGatherThreads), kGatherThreads, 0, st>>>(
      scratch, d, out);
  return (int)cudaGetLastError();
}

template <typename T>
int force_gen(const T* x, const T* u, const T* dN, const T* w, const T* N, double lam,
              double mu, int model, double mcoef, int stiff, T* scratch, T* out,
              int nx, int ny, int nz, void* stream) {
  const Dims d(nx, ny, nz);
  const cudaStream_t st = (cudaStream_t)stream;
  force_gen_elem_kernel<T><<<blocks_for(d.E, kElemThreads), kElemThreads, 0, st>>>(
      x, u, dN, w, N, (T)lam, (T)mu, model, (T)mcoef, stiff, d, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gather_kernel<T><<<blocks_for(d.n, kGatherThreads), kGatherThreads, 0, st>>>(
      scratch, d, out);
  return (int)cudaGetLastError();
}

// u == nullptr: the linear mode (u = 0)
template <typename T>
int tangent_gen(const T* x, const T* u, const T* v, const T* dN, const T* w,
                const T* N, double lam, double mu, int model, double mcoef,
                T* scratch, T* out, int nx, int ny, int nz, void* stream) {
  const Dims d(nx, ny, nz);
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned int blocks = blocks_for(d.E, kElemThreads);
  if (u == nullptr)
    tangent_gen_elem_kernel<T, true><<<blocks, kElemThreads, 0, st>>>(
        x, u, v, dN, w, N, (T)lam, (T)mu, model, (T)mcoef, d, scratch);
  else
    tangent_gen_elem_kernel<T, false><<<blocks, kElemThreads, 0, st>>>(
        x, u, v, dN, w, N, (T)lam, (T)mu, model, (T)mcoef, d, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gather_kernel<T><<<blocks_for(d.n, kGatherThreads), kGatherThreads, 0, st>>>(
      scratch, d, out);
  return (int)cudaGetLastError();
}

}  // namespace fourc

// ---------------------------------------------------------------------------
// plain C interface (bound with ctypes in fourc_tpu_torch/ops/lattice_kernels.py)
// ---------------------------------------------------------------------------

#define FOURC_EXPORT extern "C" __attribute__((visibility("default")))

FOURC_EXPORT int fourc_stencil_f32(const float* K, const float* v, float* out,
                                   int nx, int ny, int nz, void* stream) {
  return fourc::stencil<float>(K, v, out, nx, ny, nz, stream);
}
FOURC_EXPORT int fourc_stencil_f64(const double* K, const double* v, double* out,
                                   int nx, int ny, int nz, void* stream) {
  return fourc::stencil<double>(K, v, out, nx, ny, nz, stream);
}
FOURC_EXPORT int fourc_force_f32(const float* u, const float* G, const float* w,
                                 double lam, double mu, int model, float* scratch,
                                 float* out, int nx, int ny, int nz, void* stream) {
  return fourc::force<float>(u, G, w, lam, mu, model, scratch, out, nx, ny, nz, stream);
}
FOURC_EXPORT int fourc_force_f64(const double* u, const double* G, const double* w,
                                 double lam, double mu, int model, double* scratch,
                                 double* out, int nx, int ny, int nz, void* stream) {
  return fourc::force<double>(u, G, w, lam, mu, model, scratch, out, nx, ny, nz, stream);
}
FOURC_EXPORT int fourc_tangent_f32(const float* u, const float* v, const float* G,
                                   const float* w, const float* N, double lam,
                                   double mu, int model, double mcoef, float* scratch,
                                   float* out, int nx, int ny, int nz, void* stream) {
  return fourc::tangent<float>(u, v, G, w, N, lam, mu, model, mcoef, scratch, out,
                               nx, ny, nz, stream);
}
FOURC_EXPORT int fourc_tangent_f64(const double* u, const double* v, const double* G,
                                   const double* w, const double* N, double lam,
                                   double mu, int model, double mcoef, double* scratch,
                                   double* out, int nx, int ny, int nz, void* stream) {
  return fourc::tangent<double>(u, v, G, w, N, lam, mu, model, mcoef, scratch, out,
                                nx, ny, nz, stream);
}
FOURC_EXPORT int fourc_force_gen_f32(const float* x, const float* u, const float* dN,
                                     const float* w, const float* N, double lam,
                                     double mu, int model, double mcoef, int stiff,
                                     float* scratch, float* out, int nx, int ny, int nz,
                                     void* stream) {
  return fourc::force_gen<float>(x, u, dN, w, N, lam, mu, model, mcoef, stiff, scratch,
                                 out, nx, ny, nz, stream);
}
FOURC_EXPORT int fourc_force_gen_f64(const double* x, const double* u, const double* dN,
                                     const double* w, const double* N, double lam,
                                     double mu, int model, double mcoef, int stiff,
                                     double* scratch, double* out, int nx, int ny,
                                     int nz, void* stream) {
  return fourc::force_gen<double>(x, u, dN, w, N, lam, mu, model, mcoef, stiff,
                                  scratch, out, nx, ny, nz, stream);
}
FOURC_EXPORT int fourc_tangent_gen_f32(const float* x, const float* u, const float* v,
                                       const float* dN, const float* w, const float* N,
                                       double lam, double mu, int model, double mcoef,
                                       float* scratch, float* out, int nx, int ny,
                                       int nz, void* stream) {
  return fourc::tangent_gen<float>(x, u, v, dN, w, N, lam, mu, model, mcoef, scratch,
                                   out, nx, ny, nz, stream);
}
FOURC_EXPORT int fourc_tangent_gen_f64(const double* x, const double* u, const double* v,
                                       const double* dN, const double* w,
                                       const double* N, double lam, double mu, int model,
                                       double mcoef, double* scratch, double* out,
                                       int nx, int ny, int nz, void* stream) {
  return fourc::tangent_gen<double>(x, u, v, dN, w, N, lam, mu, model, mcoef,
                                    scratch, out, nx, ny, nz, stream);
}

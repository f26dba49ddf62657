// Shared device code of the hex8 kernels (lattice_kernels.cu, solid_kernels.cu).
//
// Port of the 3x3 helpers of fourc_tpu/ops/solid_pallas.py: _mm, _det,
// _cof, _inv_from_cof, _strain_A, _stress_neohooke / _stress_neohooke_dual
// and _stress_svk / _stress_svk_dual, plus the tangent stress Pd that every
// tangent kernel shares, the one-element-per-thread helpers (tables in
// shared memory, gradients, accumulation), the same by the 12 edges of an
// element with the Neo-Hooke tangent in deformation-gradient form (B2), the
// general-geometry Gauss loops of one element against its 8 corners
// (force_gen_element for B4 and B6, tangent_gen_element for B7) and the
// general-geometry tangent by the 12 edges (B5).
// Everything lives in registers; the index loops are fully unrolled so the
// 3x3 arrays never touch local memory.
//
// Neo-Hooke uses the cancellation-free form of the reference:
//   A = 2E = H + H^T + H^T H,  C = I + A,
//   det C - 1 = tr A + (tr(A)^2 - tr(A^2)) / 2 + det A   (exact),
//   lnJ = log1p(det C - 1) / 2,  S = C^-1 (mu A + lam lnJ I).
#pragma once

#include <cuda_runtime.h>

namespace fourc {

// hex8 local node a sits at lattice offset (ox(a), oy(a), oz(a)), node order
// (0,0,0) (1,0,0) (1,1,0) (0,1,0) (0,0,1) (1,0,1) (1,1,1) (0,1,1).
__host__ __device__ __forceinline__ int ox(int a) { return ((a + 1) >> 1) & 1; }
__host__ __device__ __forceinline__ int oy(int a) { return (a >> 1) & 1; }
__host__ __device__ __forceinline__ int oz(int a) { return a >> 2; }

__device__ __forceinline__ float log1p_t(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_t(double x) { return log1p(x); }

template <typename T>
__device__ __forceinline__ void mm(const T a[3][3], const T b[3][3], T c[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[i][j] = a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j];
}

template <typename T>
__device__ __forceinline__ T det3(const T a[3][3]) {
  return a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
       - a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
       + a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]);
}

// cofactor matrix (= adj^T)
template <typename T>
__device__ __forceinline__ void cof3(const T a[3][3], T c[3][3]) {
  c[0][0] = a[1][1] * a[2][2] - a[1][2] * a[2][1];
  c[0][1] = a[1][2] * a[2][0] - a[1][0] * a[2][2];
  c[0][2] = a[1][0] * a[2][1] - a[1][1] * a[2][0];
  c[1][0] = a[0][2] * a[2][1] - a[0][1] * a[2][2];
  c[1][1] = a[0][0] * a[2][2] - a[0][2] * a[2][0];
  c[1][2] = a[0][1] * a[2][0] - a[0][0] * a[2][1];
  c[2][0] = a[0][1] * a[1][2] - a[0][2] * a[1][1];
  c[2][1] = a[0][2] * a[1][0] - a[0][0] * a[1][2];
  c[2][2] = a[0][0] * a[1][1] - a[0][1] * a[1][0];
}

// inverse = adj / det = cof^T / det
template <typename T>
__device__ __forceinline__ void inv_from_cof(const T cof[3][3], T det, T inv[3][3]) {
  const T r = T(1) / det;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) inv[i][j] = cof[j][i] * r;
}

// A = H + H^T + H^T H
template <typename T>
__device__ __forceinline__ void strain_A(const T H[3][3], T A[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      A[i][j] = H[i][j] + H[j][i] + H[0][i] * H[0][j] + H[1][i] * H[1][j] +
                H[2][i] * H[2][j];
}

// Ad = d/dt A(H + t Hd) at t = 0 = Hd + Hd^T + Hd^T H + H^T Hd
template <typename T>
__device__ __forceinline__ void strain_A_dual(const T H[3][3], const T Hd[3][3],
                                              T Ad[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T s = Hd[i][j] + Hd[j][i];
#pragma unroll
      for (int k = 0; k < 3; ++k) s += Hd[k][i] * H[k][j] + H[k][i] * Hd[k][j];
      Ad[i][j] = s;
    }
}

// Values of the Neo-Hooke stress that its dual reuses.
template <typename T>
struct NeoAux {
  T Cinv[3][3];
  T detC_m1;
  T lnJ;
};

template <typename T>
__device__ __forceinline__ void stress_neohooke(const T A[3][3], T lam, T mu,
                                                T S[3][3], NeoAux<T>& aux) {
  T C[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C[i][j] = A[i][j] + (i == j ? T(1) : T(0));
  const T trA = A[0][0] + A[1][1] + A[2][2];
  T trA2 = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) trA2 += A[i][j] * A[j][i];
  aux.detC_m1 = trA + T(0.5) * (trA * trA - trA2) + det3(A);
  aux.lnJ = T(0.5) * log1p_t(aux.detC_m1);
  T cofC[3][3];
  cof3(C, cofC);
  inv_from_cof(cofC, T(1) + aux.detC_m1, aux.Cinv);
  T M[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      M[i][j] = mu * A[i][j] + (i == j ? lam * aux.lnJ : T(0));
  mm(aux.Cinv, M, S);
}

template <typename T>
__device__ __forceinline__ void stress_neohooke_dual(const T A[3][3], const T Ad[3][3],
                                                     const NeoAux<T>& aux, T lam,
                                                     T mu, T Sd[3][3]) {
  const T trAd = Ad[0][0] + Ad[1][1] + Ad[2][2];
  const T trA = A[0][0] + A[1][1] + A[2][2];
  T trA2d = T(0);
  T cofA[3][3];
  cof3(A, cofA);
  T detAd = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      trA2d += A[i][j] * Ad[i][j];
      detAd += cofA[i][j] * Ad[i][j];
    }
  trA2d *= T(2);
  const T detC_m1_d = trAd + trA * trAd - T(0.5) * trA2d + detAd;
  const T lnJd = T(0.5) * detC_m1_d / (T(1) + aux.detC_m1);
  T CinvAd[3][3], Cinvd[3][3];
  mm(aux.Cinv, Ad, CinvAd);
  mm(CinvAd, aux.Cinv, Cinvd);
  T M[3][3], Md[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Cinvd[i][j] = -Cinvd[i][j];
      M[i][j] = mu * A[i][j] + (i == j ? lam * aux.lnJ : T(0));
      Md[i][j] = mu * Ad[i][j] + (i == j ? lam * lnJd : T(0));
    }
  T S1[3][3], S2[3][3];
  mm(Cinvd, M, S1);
  mm(aux.Cinv, Md, S2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Sd[i][j] = S1[i][j] + S2[i][j];
}

// St. Venant-Kirchhoff: S = lam tr(E) I + 2 mu E = lam tr(A)/2 I + mu A
template <typename T>
__device__ __forceinline__ void stress_svk(const T A[3][3], T lam, T mu, T S[3][3]) {
  const T trE = T(0.5) * (A[0][0] + A[1][1] + A[2][2]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) S[i][j] = (i == j ? lam * trE : T(0)) + mu * A[i][j];
}

// Pd = d/dt P(H + t Hd) at t = 0 = Hd S + F Sd, F = I + H
// (model: 0 = Neo-Hooke, 1 = St. Venant-Kirchhoff)
template <typename T>
__device__ __forceinline__ void tangent_stress(const T H[3][3], const T Hd[3][3], T lam,
                                               T mu, int model, T Pd[3][3]) {
  T A[3][3], Ad[3][3], S[3][3], Sd[3][3];
  strain_A(H, A);
  strain_A_dual(H, Hd, Ad);
  if (model == 0) {
    NeoAux<T> aux;
    stress_neohooke(A, lam, mu, S, aux);
    stress_neohooke_dual(A, Ad, aux, lam, mu, Sd);
  } else {
    stress_svk(A, lam, mu, S);
    stress_svk(Ad, lam, mu, Sd);  // linear law: the dual is S(Ad)
  }
  T F[3][3], P2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) F[i][j] = H[i][j] + (i == j ? T(1) : T(0));
  mm(Hd, S, Pd);
  mm(F, Sd, P2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Pd[i][j] += P2[i][j];
}

// c = a b^T
template <typename T>
__device__ __forceinline__ void mm_abt(const T a[3][3], const T b[3][3], T c[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[i][j] = a[i][0] * b[j][0] + a[i][1] * b[j][1] + a[i][2] * b[j][2];
}

// ---------------------------------------------------------------------------
// One hex8 element per thread: tables, gradients, accumulation
// ---------------------------------------------------------------------------

constexpr int kElemThreads = 128;

inline unsigned int blocks_for(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

// hex8 tables in shared memory: G[g][a][j] (192; the cartesian gradients of
// a uniform lattice, or the reference gradients dN on general geometry),
// w[g] (8; wdet, or the Gauss weights), N[g][a] (64)
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

// element vector -> column e of a (24, E) array, row a*3+i (neighbouring
// threads write neighbouring addresses)
template <typename T>
__device__ __forceinline__ void store_fe(const T fe[8][3], long long e, long long E,
                                         T* __restrict__ out) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i) out[(a * 3 + i) * E + e] = fe[a][i];
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

// ---------------------------------------------------------------------------
// One hex8 element per thread by its 12 edges
//
// Every node of a hex8 lies on exactly one edge along each axis j; edge e
// of axis j runs from node edge_node(j, e, 0) to edge_node(j, e, 1):
//   x: (0,1) (3,2) (4,5) (7,6);  y: (0,3) (1,2) (4,7) (5,6);
//   z: (0,4) (1,5) (2,6) (3,7).
// A trilinear hex8's gradients satisfy G[a-][j] = -G[a+][j] on every edge
// along j, so with the edge table Ge[g][j][e] = (G[g][a+][j] - G[g][a-][j])/2
// a gradient is H[i][j] = sum over the 4 edges e along j of
// (x[a+][i] - x[a-][i]) Ge[g][j][e], and the accumulation sum_a P G_a^T
// gathers into 36 edge sums R[j][e][i] that edges_to_nodes adds to a+ and
// subtracts from a-.
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int edge_node(int j, int e, int side) {
  return j == 2 ? e + 4 * side
       : j == 1 ? 4 * (e >> 1) + (side ? 3 - (e & 1) : (e & 1))
                : 4 * (e >> 1) + ((e & 1) ? 3 - side : side);
}

// Tables of a uniform hex8 in shared memory: the edge table Ge[g][j][e], the
// weights w[g] (wdet) and the element mass times mcoef,
// Mc[a][b] = mcoef sum_g wdet_g N[g][a] N[g][b].
template <typename T>
struct EdgeShared {
  T Ge[8][3][4];
  T w[8];
  T Mc[8][8];
};

// Entry t = (g * 3 + j) * 4 + e of the edge table of G (8, 8, 3):
// Ge[g][j][e] = (G[g][a+][j] - G[g][a-][j]) / 2
template <typename T>
__device__ __forceinline__ T edge_table_entry(const T* G, int t) {
  const int g = t / 12, j = (t / 4) % 3, e = t % 4;
  return T(0.5) * (G[(g * 8 + edge_node(j, e, 1)) * 3 + j] -
                   G[(g * 8 + edge_node(j, e, 0)) * 3 + j]);
}

// Builds the tables from G (8, 8, 3), wdet (8) and N (8, 8); one barrier.
template <typename T>
__device__ __forceinline__ void load_edge_tables(EdgeShared<T>& s, const T* G,
                                                 const T* w, const T* N, T mcoef) {
  for (int t = threadIdx.x; t < 96 + 8 + 64; t += blockDim.x) {
    if (t < 96) {
      (&s.Ge[0][0][0])[t] = edge_table_entry(G, t);
    } else if (t < 104) {
      s.w[t - 96] = w[t - 96];
    } else {
      const int a = (t - 104) / 8, b = (t - 104) % 8;
      T m = T(0);
#pragma unroll
      for (int g = 0; g < 8; ++g) m += w[g] * N[g * 8 + a] * N[g * 8 + b];
      s.Mc[a][b] = mcoef * m;
    }
  }
  __syncthreads();
}

// dx[j][e][i] = xe[a+][i] - xe[a-][i]
template <typename T>
__device__ __forceinline__ void edge_diff(const T xe[8][3], T dx[3][4][3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 3; ++i)
        dx[j][e][i] = xe[edge_node(j, e, 1)][i] - xe[edge_node(j, e, 0)][i];
}

// H[i][j] = sum_e dx[j][e][i] Ge[j][e]  (grad regrouped by edges)
template <typename T>
__device__ __forceinline__ void grad_edges(const T dx[3][4][3], const T Ge[3][4],
                                           T H[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      H[i][j] = dx[j][0][i] * Ge[j][0] + dx[j][1][i] * Ge[j][1] +
                dx[j][2][i] * Ge[j][2] + dx[j][3][i] * Ge[j][3];
}

// R[j][e][i] += wg P[i][j] Ge[j][e]  (accum regrouped by edges)
template <typename T>
__device__ __forceinline__ void accum_edges(const T P[3][3], const T Ge[3][4], T wg,
                                            T R[3][4][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T p = wg * P[i][j];
#pragma unroll
      for (int e = 0; e < 4; ++e) R[j][e][i] += p * Ge[j][e];
    }
}

// fe[a+] += R[j][e], fe[a-] -= R[j][e], axis by axis
template <typename T>
__device__ __forceinline__ void edges_to_nodes(const T R[3][4][3], T fe[8][3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        fe[edge_node(j, e, 1)][i] += R[j][e][i];
        fe[edge_node(j, e, 0)][i] -= R[j][e][i];
      }
}

// fe[a] += sum_b Mc[a][b] ve[b]  (the consistent mass of a uniform element)
template <typename T>
__device__ __forceinline__ void mass_table(const T ve[8][3], const T Mc[8][8],
                                           T fe[8][3]) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const T m = Mc[a][b];
#pragma unroll
      for (int k = 0; k < 3; ++k) fe[a][k] += m * ve[b][k];
    }
}

// The Neo-Hooke tangent stress in deformation-gradient form.  The law of
// stress_neohooke, S = mu (I - C^-1) + lam lnJ C^-1, is P = F S
// = mu F + (lam lnJ - mu) F^-T, so along Hd
//   Pd = mu Hd + lam tr(F^-1 Hd) F^-T - (lam lnJ - mu) (F^-1 Hd F^-1)^T,
// written with K = cof(F) = det F F^-T and r = 1 / det F as
//   Pd = mu Hd + r^2 (lam (K : Hd) K - (lam lnJ - mu) K Hd^T K):
// no C, no C^-1 and one division.  det F = 1 + delta with the small-strain
// accurate delta = tr H + ((tr H)^2 - tr(H^2)) / 2 + det H, and
// lnJ = log1p(delta (2 + delta)) / 2 = log(det C) / 2, as the reference has
// it (det F < 0 gives its value, not a NaN).  At H = 0 the terms add up to
// mu (Hd + Hd^T) + lam tr(Hd) I with no cancellation.
template <typename T>
__device__ __forceinline__ void tangent_neohooke_F(const T H[3][3], const T Hd[3][3],
                                                   T lam, T mu, T Pd[3][3]) {
  const T trH = H[0][0] + H[1][1] + H[2][2];
  T trH2 = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) trH2 += H[i][j] * H[j][i];
  const T delta = trH + T(0.5) * (trH * trH - trH2) + det3(H);
  const T lnJ = T(0.5) * log1p_t(delta * (T(2) + delta));
  T F[3][3], K[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) F[i][j] = H[i][j] + (i == j ? T(1) : T(0));
  cof3(F, K);
  const T r = T(1) / (T(1) + delta);
  T KHd = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) KHd += K[i][j] * Hd[i][j];
  T Q[3][3], M[3][3];
  mm_abt(K, Hd, Q);  // K Hd^T
  mm(Q, K, M);       // K Hd^T K
  const T r2 = r * r;
  const T a = lam * KHd * r2, b = (lam * lnJ - mu) * r2;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Pd[i][j] = mu * Hd[i][j] + a * K[i][j] - b * M[i][j];
}

// ---------------------------------------------------------------------------
// General geometry: the Gauss loop of one element from its 8 corners
// (s.G holds the reference gradients dN[g][a][j], s.w the Gauss weights)
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

// fe = sum_g wdet_g P(F_g) G_g (when stiff) + mcoef sum_g wdet_g N N^T ue
// (when mcoef != 0); model: 0 = Neo-Hooke, 1 = St. Venant-Kirchhoff.  The
// mass needs only det J: no cofactor, no inverse.
template <typename T>
__device__ __forceinline__ void force_gen_element(const T xe[8][3], const T ue[8][3],
                                                  const GeomShared<T>& s, T lam, T mu,
                                                  int model, T mcoef, int stiff,
                                                  T fe[8][3]) {
  zero_fe(fe);
#pragma unroll 1
  for (int g = 0; g < 8; ++g) {
    T J[3][3];
    grad(xe, s.G[g], J);
    const T det = det3(J);
    const T wdet = det * s.w[g];
    if (stiff) {
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
}

// fe = K(ue) ve + mcoef sum_g wdet_g N N^T ve.  kLinear: u = 0 (ue is not
// read), where every law is linear elasticity,
// Pd = lam tr(Hd) I + mu (Hd + Hd^T)
template <typename T, bool kLinear>
__device__ __forceinline__ void tangent_gen_element(const T xe[8][3], const T ue[8][3],
                                                    const T ve[8][3],
                                                    const GeomShared<T>& s, T lam, T mu,
                                                    int model, T mcoef, T fe[8][3]) {
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
}

// ---------------------------------------------------------------------------
// General geometry by the 12 edges (B5)
//
// The reference gradients of a trilinear hex8 satisfy dN[a-][j] = -dN[a+][j]
// along every edge of axis j, so one edge table Ge[g][j][e] (edge_table_entry
// of dN) serves every element and every GMG level: the Jacobian
// J = sum_a x_a dN_a^T and the reference gradient Hhat(v) = sum_a v_a dN_a^T
// are grad_edges on edge differences.  With K = cof(J) = det J Jinv^T,
//   H = Hhat Jinv = Hhat K^T / det J   and   wdet P Jinv^T = w P K,
// so no inverse and no wdet is formed.  Pd is linear in Hd, so the one
// division of a Gauss point moves onto its weight: with Hd' = Hhat(v) K^T =
// det J Hd, the edge sums gather (w / det J) Pd(H, Hd') K.
// ---------------------------------------------------------------------------

// kModel of the general-geometry tangent: 0 = Neo-Hooke, 1 = St.
// Venant-Kirchhoff (as cuda_build.MODELS), kLinear = linear elasticity at
// u = 0 (the exact-geometry GMG level operator; u is not read)
constexpr int kLinear = 2;

// Tables of general geometry in shared memory: the edge table Ge[g][j][e] of
// dN, the Gauss weights w[g] and the shape functions N[g][a].
template <typename T>
struct GenEdgeShared {
  T Ge[8][3][4];
  T w[8];
  T N[8][8];
};

// Builds the tables from dN (8, 8, 3), w (8) and N (8, 8; not loaded when
// nullptr); one barrier.
template <typename T>
__device__ __forceinline__ void load_gen_edge_tables(GenEdgeShared<T>& s, const T* dN,
                                                     const T* w, const T* N) {
  const int n = N != nullptr ? 96 + 8 + 64 : 96 + 8;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    if (t < 96)
      (&s.Ge[0][0][0])[t] = edge_table_entry(dN, t);
    else if (t < 104)
      s.w[t - 96] = w[t - 96];
    else
      (&s.N[0][0])[t - 104] = N[t - 104];
  }
  __syncthreads();
}

// Pd = lam tr(Hd) I + mu (Hd + Hd^T): every law's tangent at u = 0
template <typename T>
__device__ __forceinline__ void linear_stress(const T Hd[3][3], T lam, T mu, T Pd[3][3]) {
  const T lt = lam * (Hd[0][0] + Hd[1][1] + Hd[2][2]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Pd[i][j] = i == j ? lt + T(2) * mu * Hd[i][i] : mu * (Hd[i][j] + Hd[j][i]);
}

// det J Pd of one Gauss point, from K = cof(J), r = 1 / det J, the reference
// gradient Hv = Hhat(v) and, unless kLinear, the edge differences du of u.
template <typename T, int kModel>
__device__ __forceinline__ void tangent_gen_Pd(const T K[3][3], T r, const T Hv[3][3],
                                               const T du[3][4][3], const T Ge[3][4],
                                               T lam, T mu, T Pd[3][3]) {
  T Hd[3][3];
  mm_abt(Hv, K, Hd);  // det J Hd
  if constexpr (kModel == kLinear) {
    linear_stress(Hd, lam, mu, Pd);
  } else {
    T Hu[3][3], H[3][3];
    grad_edges(du, Ge, Hu);
    mm_abt(Hu, K, H);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) H[i][j] *= r;
    if constexpr (kModel == 0)
      tangent_neohooke_F(H, Hd, lam, mu, Pd);
    else
      tangent_stress(H, Hd, lam, mu, 1, Pd);
  }
}

// Q = (w / det J) Pd(H, Hd') K of one Gauss point, the matrix whose product
// with dN_a is the Gauss point's share of fe_a; returns det J.
template <typename T, int kModel>
__device__ __forceinline__ T tangent_gen_gp(const T J[3][3], const T du[3][4][3],
                                            const T dv[3][4][3], const T Ge[3][4], T w,
                                            T lam, T mu, T Q[3][3]) {
  T K[3][3], Hv[3][3], Pd[3][3];
  cof3(J, K);
  const T det = J[0][0] * K[0][0] + J[0][1] * K[0][1] + J[0][2] * K[0][2];
  const T r = T(1) / det;
  grad_edges(dv, Ge, Hv);
  tangent_gen_Pd<T, kModel>(K, r, Hv, du, Ge, lam, mu, Pd);
  mm(Pd, K, Q);
  const T s = w * r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Q[i][j] *= s;
  return det;
}

// The Gauss loop of one element by its edges: R[j][e][i] = edge sums of
// sum_g Q_g Ge[g] (edges_to_nodes turns them into fe); with kMass,
// c[7 - g] = det J_g after the loop (a shift register: static indices keep
// the 8 values in registers).  du is not read when kLinear.
template <typename T, int kModel, bool kMass>
__device__ __forceinline__ void tangent_gen_edge_element(const T dx[3][4][3],
                                                         const T du[3][4][3],
                                                         const T dv[3][4][3],
                                                         const GenEdgeShared<T>& s,
                                                         T lam, T mu, T R[3][4][3],
                                                         T c[8]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) R[j][q][0] = R[j][q][1] = R[j][q][2] = T(0);
#pragma unroll 1
  for (int g = 0; g < 8; ++g) {
    T J[3][3], Q[3][3];
    grad_edges(dx, s.Ge[g], J);
    const T det = tangent_gen_gp<T, kModel>(J, du, dv, s.Ge[g], s.w[g], lam, mu, Q);
    accum_edges(Q, s.Ge[g], T(1), R);
    if constexpr (kMass) {
#pragma unroll
      for (int k = 7; k > 0; --k) c[k] = c[k - 1];
      c[0] = det;
    }
  }
}

// fe[a] += sum_g mcoef w_g det J_g N[g][a] (N[g] . ve): the consistent mass
// of a general element after its Gauss loop (c from tangent_gen_edge_element)
template <typename T>
__device__ __forceinline__ void mass_gen(const T ve[8][3], const GenEdgeShared<T>& s,
                                         const T c[8], T mcoef, T fe[8][3]) {
#pragma unroll
  for (int g = 0; g < 8; ++g) mass_accum(ve, s.N[g], mcoef * s.w[g] * c[7 - g], fe);
}

// The edge of axis j through node a: node a is edge_node(j, a's edge,
// a's offset along j), so dN[g][a][j] = (2 offset - 1) Ge[g][j][edge]
__host__ __device__ constexpr int node_edge(int a, int j) {
  return j == 2 ? (a & 3) : 2 * (a >> 2) + (j == 1 ? ((a & 3) < 2 ? (a & 3) : 3 - (a & 3))
                                                   : int((a & 3) >= 2));
}

}  // namespace fourc

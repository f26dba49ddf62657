// Shared device code of the hex8 kernels (lattice_kernels.cu, solid_kernels.cu).
//
// Port of the 3x3 helpers of fourc_tpu/ops/solid_pallas.py: _mm, _det,
// _cof, _inv_from_cof, _strain_A, _stress_neohooke / _stress_neohooke_dual
// and _stress_svk / _stress_svk_dual, plus the tangent stress Pd that every
// tangent kernel shares, the one-element-per-thread helpers (tables in
// shared memory, gradients, accumulation) and the general-geometry Gauss
// loops of one element (force_gen_element, tangent_gen_element), which the
// lattice kernels B4/B5 and the element-batch kernels B6/B7 both run.
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

}  // namespace fourc

// The dense one-element passes that the shipped kernels replaced, for the
// variant tools that time them as "old" (b2_variants.cu, b5_variants.cu,
// b7_b4_variants.cu, b1_b6_variants.cu).  No kernel of
// fourc_tpu_torch/csrc uses them: every shipped element pass works by the
// 12 edges of the element (lattice_common.cuh).
//
// Here a Gauss point's gradient is taken against all 8 corners of the
// element, and on general geometry through the inverse of its Jacobian.
#pragma once

#include "lattice_common.cuh"

namespace fourc {

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
// mass needs only det J: no cofactor, no inverse.  B4's and B6's pass
// before their edge form (force_gen_edge_element).
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
// Pd = lam tr(Hd) I + mu (Hd + Hd^T).  The dense pass of B5 and B7 before
// their edge form (tangent_gen_edge_element).
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

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
// - B3 applies one element stencil K (8,3,8,3), read from a device pointer
//   because each GMG level has its own.  Walking the 8 elements of each
//   node (one thread per node) costs 64 node-block pairs: 576 FMAs, each
//   with its K coefficient from shared memory, and 192 loads of v of which
//   81 are distinct.  At n=72 that is 7.6 M warp-wide shared loads, about
//   57 k per SM, which at one per clock is the 32-35 us that version took
//   on the H100 (0.0030 ms byte bound): the shared-load pipe bound it.
//   Now a block with interior nodes first sums K into the assembled
//   27-point stencil S (27 blocks of 3x3, stencil_prologue).  A node with
//   all 8 elements (an interior node) is y_p = sum_d S[d] v[p+d], 243 FMAs;
//   one thread takes 4 consecutive interior nodes along y, reads each block
//   of S once as 3 vector rows and feeds each of the 6 rows of v it loads
//   per (dx, dz) column to the nodes it touches: about 20 shared loads and
//   40 loads of v per node.  Boundary nodes (8% of the real nodes at n=72)
//   keep the 8-element loop; they come first in the grid, ordered so that
//   a warp shares one set of elements; the interior threads start at a
//   whole block, so no warp runs both paths.  The prologue has one
//   barrier: on the coarse GMG levels, where one wave of blocks runs, the
//   longest block is the kernel.  One launch, no atomics, a fixed sum order
//   per node.  14.1 us on the H100 at n=72 (float32, a CUDA graph of
//   calls), against 32.5 us for the element walk in the same run, and
//   faster at n=36, 18 and 9 too (tools/b3_variants.py): now the load pipe
//   (misaligned rows of v, two wavefronts each), the boundary shell's
//   strided columns and a launch floor of about 4 us share the time.
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

// B3: 128 threads, at least 5 blocks per SM (at most 102 registers; the
// compiler's own choice, 254, leaves 2 blocks per SM and is slower), 4
// interior nodes per thread (tools/b3_variants.py times the others)
constexpr int kStencilThreads = 128;
constexpr int kStencilMinBlocks = 5;
constexpr int kStencilRows = 4;
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

// The assembled stencil S: S[d] couples a node to its neighbour at offset
// (dx, dy, dz), d = (dx+1)*9 + (dy+1)*3 + (dz+1), a 3x3 block stored with
// row r at S + d*kSBlock + 4*r (rows padded to 4 so that they load as one
// vector).
constexpr int kSBlock = 12;

// hex8 local node at lattice offset (x, y, z) in {0,1}^3 (inverse of ox/oy/oz)
__device__ __forceinline__ int hex8_node(int x, int y, int z) {
  return 4 * z + (y ? 3 - x : x);
}

// The block's prologue, one barrier.  A block of shell nodes loads K into
// shared memory (the 8-element loop reads it); a block of interior nodes
// sums K, read from global memory, into S[d][i][j] = sum over the pairs
// (a, b) with o(b) - o(a) = d of K[a,i,b,j] (8, 4, 2 or 1 terms, a in order).
template <typename T>
__device__ __forceinline__ void stencil_prologue(const T* __restrict__ Kg, T* K,
                                                 T* S, bool shell) {
  if (shell)
    for (int t = threadIdx.x; t < 576; t += blockDim.x) K[t] = Kg[t];
  else
    for (int t = threadIdx.x; t < 243; t += blockDim.x) {
      const int dd = t / 9, i = (t / 3) % 3, j = t % 3;
      const int dx = dd / 9 - 1, dy = (dd / 3) % 3 - 1, dz = dd % 3 - 1;
      T s = T(0);
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int x = ox(a) + dx, y = oy(a) + dy, z = oz(a) + dz;
        if ((unsigned)x > 1u || (unsigned)y > 1u || (unsigned)z > 1u) continue;
        s += __ldg(Kg + (a * 3 + i) * 24 + hex8_node(x, y, z) * 3 + j);
      }
      S[dd * kSBlock + 4 * i + j] = s;
    }
  __syncthreads();
}

// one padded node (i, j, k) by its <= 8 real elements: any node, needed for
// those that miss an element (boundary nodes; ghost nodes get 0)
template <typename T>
__device__ __forceinline__ void stencil_node(const T* K, const T* __restrict__ v,
                                             T* __restrict__ out, const Dims& d,
                                             int i, int j, int k) {
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
  const long long p = d.node(i, j, k);
  out[p] = s0;
  out[d.n + p] = s1;
  out[2 * d.n + p] = s2;
}

__device__ __forceinline__ void lds_row(const float* s, float r[3]) {
  const float4 q = *reinterpret_cast<const float4*>(s);
  r[0] = q.x;
  r[1] = q.y;
  r[2] = q.z;
}
__device__ __forceinline__ void lds_row(const double* s, double r[3]) {
  const double2 q = *reinterpret_cast<const double2*>(s);
  r[0] = q.x;
  r[1] = q.y;
  r[2] = s[2];
}

// R interior nodes (i, j0 + m, k), m < R, by the 27-point product; the
// first nj of them are stored (the others may lie outside the interior and
// their rows past the lattice read 0)
template <typename T, int R>
__device__ __forceinline__ void stencil_rows(const T* S, const T* __restrict__ v,
                                             T* __restrict__ out, const Dims& d,
                                             int i, int j0, int k, int nj) {
  const int YZ = d.Y * d.Z;
  const long long p0 = d.node(i, j0, k);
  T acc[R][3];
#pragma unroll
  for (int m = 0; m < R; ++m) acc[m][0] = acc[m][1] = acc[m][2] = T(0);
  // the 9 (dx, dz) columns; each reads its 3 blocks S[dx, -1..1, dz] once
#pragma unroll
  for (int col = 0; col < 9; ++col) {
    const int dx = col / 3 - 1, dz = col % 3 - 1;
    T s[3][3][3];  // [dy + 1][row][col]
#pragma unroll
    for (int e = 0; e < 3; ++e)
#pragma unroll
      for (int r = 0; r < 3; ++r)
        lds_row(S + ((dx + 1) * 9 + e * 3 + dz + 1) * kSBlock + 4 * r, s[e][r]);
    // row r = v[:, i+dx, j0-1+r, k+dz] feeds node m with dy = r - 1 - m
    const T* q0 = v + p0 + dx * YZ + dz - d.Z;
#pragma unroll
    for (int r = 0; r < R + 2; ++r) {
      T w0 = T(0), w1 = T(0), w2 = T(0);
      if (r < 4 || j0 - 1 + r < d.Y) {
        const T* q = q0 + r * d.Z;
        w0 = q[0];
        w1 = q[d.n];
        w2 = q[2 * d.n];
      }
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int e = r - m;
        if (e < 0 || e > 2) continue;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          acc[m][c] += s[e][c][0] * w0;
          acc[m][c] += s[e][c][1] * w1;
          acc[m][c] += s[e][c][2] * w2;
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < R; ++m) {
    if (m < nj) {
      const long long p = p0 + (long long)m * d.Z;
      out[p] = acc[m][0];
      out[d.n + p] = acc[m][1];
      out[2 * d.n + p] = acc[m][2];
    }
  }
}

// Interior nodes have all 8 elements: 2 <= i <= nx, alike in j and k.
__host__ __device__ __forceinline__ long long interior_nodes(const Dims& d) {
  return (long long)(d.nx - 1) * (d.ny - 1) * (d.nz - 1);
}

template <int R>
__host__ __device__ __forceinline__ long long interior_threads(const Dims& d) {
  return (long long)(d.nx - 1) * ((d.ny - 1 + R - 1) / R) * (d.nz - 1);
}

// The threads of the boundary shell: one per shell node, rounded up to whole
// blocks, so that no warp runs both the shell's and the interior's path
// (one such warp would be the kernel's critical path on the coarse levels).
__host__ __device__ __forceinline__ long long shell_threads(const Dims& d) {
  const long long n_bnd = d.n - interior_nodes(d);
  return (n_bnd + kStencilThreads - 1) / kStencilThreads * kStencilThreads;
}

// Node b of the boundary shell (the padded nodes that are not interior, 2
// deep), by planes i = 0, 1, X-2, X-1, then rows j = 0, 1, Y-2, Y-1 of the
// other planes, then columns k = 0, 1, Z-2, Z-1 of the other rows, so that
// the nodes of one warp have one set of elements.
__device__ __forceinline__ void shell_node(const Dims& d, long long b, int& i,
                                           int& j, int& k) {
  const int ni = d.nx - 1, nj = d.ny - 1;
  const long long plane = (long long)d.Y * d.Z, row = (long long)ni * d.Z,
                  col = (long long)ni * nj;
  if (b < 4 * plane) {
    const int s = (int)(b / plane);
    i = s < 2 ? s : d.X - 4 + s;
    j = (int)((b % plane) / d.Z);
    k = (int)(b % d.Z);
  } else if ((b -= 4 * plane) < 4 * row) {
    const int s = (int)(b / row);
    j = s < 2 ? s : d.Y - 4 + s;
    i = 2 + (int)((b % row) / d.Z);
    k = (int)(b % d.Z);
  } else {
    b -= 4 * row;
    const int s = (int)(b / col);
    k = s < 2 ? s : d.Z - 4 + s;
    i = 2 + (int)((b % col) / nj);
    j = 2 + (int)(b % nj);
  }
}

// The first blocks take the boundary shell, one node per thread by the
// 8-element loop; the blocks after them take R consecutive interior nodes
// along y at one (i, k) per thread, k fastest.
template <typename T, int R>
__global__ void __launch_bounds__(kStencilThreads, kStencilMinBlocks)
stencil_kernel(const T* __restrict__ Kg, const T* __restrict__ v,
               T* __restrict__ out, Dims d) {
  __shared__ T K[576];
  __shared__ __align__(16) T S[27 * kSBlock];
  const long long t = (long long)blockIdx.x * kStencilThreads + threadIdx.x;
  const long long n_shell = shell_threads(d);
  const bool shell = t - threadIdx.x < n_shell;  // the same for the block
  stencil_prologue(Kg, K, S, shell);
  if (shell) {
    if (t >= d.n - interior_nodes(d)) return;
    int i, j, k;
    shell_node(d, t, i, j, k);
    stencil_node(K, v, out, d, i, j, k);
    return;
  }
  const long long u = t - n_shell;
  if (u >= interior_threads<R>(d)) return;
  const int nk = d.nz - 1, jb = (d.ny - 1 + R - 1) / R;
  const int k = 2 + (int)(u % nk);
  const int j0 = 2 + R * (int)((u / nk) % jb);
  const int i = 2 + (int)(u / nk / jb);
  stencil_rows<T, R>(S, v, out, d, i, j0, k, min(R, d.ny + 1 - j0));
}

// ---------------------------------------------------------------------------
// B1 / B2 element pass: one thread per real element
// ---------------------------------------------------------------------------

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
// B4 / B5 element pass on general geometry: one thread per real element; the
// Gauss loops (force_gen_element, tangent_gen_element) are shared with the
// element-batch kernels of solid_kernels.cu through lattice_common.cuh
// (shared tables: s.G holds the reference gradients dN[g][a][j], not G)
// ---------------------------------------------------------------------------

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
  force_gen_element(xe, ue, s, lam, mu, model, mcoef, stiff, fe);
  store_fe(fe, e, d.E, scratch);
}

// kLinear: u = 0 (u is not read)
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
  tangent_gen_element<T, kLinear>(xe, ue, ve, s, lam, mu, model, mcoef, fe);
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

template <typename T>
int stencil(const T* K, const T* v, T* out, int nx, int ny, int nz, void* stream) {
  const Dims d(nx, ny, nz);
  const long long threads = shell_threads(d) + interior_threads<kStencilRows>(d);
  stencil_kernel<T, kStencilRows>
      <<<blocks_for(threads, kStencilThreads), kStencilThreads, 0,
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

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
// - B1/B2 do 4-10k flops per element (8 Gauss points of 3x3 algebra),
//   compute bound in registers.  One thread per REAL element computes the
//   24-value element vector and writes it to a scratch buffer stored
//   (24, E) so neighbouring threads write neighbouring addresses.  A second
//   gather pass (one thread per node, <= 8 elements) sums it into the
//   nodes.  Two passes keep the result deterministic without atomics; the
//   TPU kernel kept the element vectors in VMEM, and fusing the passes is
//   later work.  B2 fuses the consistent-mass term mcoef * sum_g wdet N N^T v
//   into the same element pass, as _jvp_kernel does.
// - B2 runs in every CG iteration of the flagship.  Its first pass did
//   10,288 flops per element with the mass: gradients and accumulation
//   dense against all 8 corners (456 per Gauss point), the Neo-Hooke
//   tangent in material form through C, C^-1, A and Ad (721), the mass at
//   every Gauss point (106).  Limited by its instruction rate at 163
//   registers, it took 0.1263 ms at n=72.  Now it works by the 12 edges of
//   the element (lattice_common.cuh): a block prologue builds the edge table
//   (G[a+] - G[a-]) / 2 and the 8x8 element mass in shared memory; a
//   gradient entry is 4 FMAs on the edge differences instead of 8 on the
//   corners, each Gauss point accumulates into 36 edge sums, the Neo-Hooke
//   tangent is taken in deformation-gradient form (no C, one division), and
//   the mass is one 8x8 product per element: 4,224 flops, 0.0235 ms of
//   float32 peak.  At most 128 registers (4 blocks per SM, 24 B spilled);
//   the compiler's own 155-159 leave 3 blocks and are 11-14% slower, holding
//   the 24 corners instead of the 36 edge differences is slower at either
//   count.  On the H100 at n=72 (float32, with the mass): 0.0745 ms by a
//   CUDA graph of calls against 0.1263 for the first pass in the same run,
//   31.6% of the bound against 18.6%; by a plain loop of calls 0.0785
//   against 0.1299 (tools/b2_variants.py).  The element pass alone takes
//   0.0568 ms, the gather 0.0153-0.0157.
// - B4/B5 are B1/B2 on general geometry (box topology, arbitrary node
//   positions): the element's 8 corner coordinates are read from a
//   coordinate lattice x in the same layout, and each Gauss point's
//   Jacobian and determinant are computed in registers, as _geom_gp does on
//   the TPU; no per-element geometry table is stored (an (E, 8, 8, 3) table
//   of gradients would be 290 MB at n=72).  B4 forms Jinv and works
//   against the 8 corners (force_gen_element), as B5 did until it was
//   redesigned; B4 has a mass-only mode (the consistent mass of the general
//   mesh, which needs only det J: no cofactor, no inverse).
// - B5 runs 750 times per GMG level in its linear mode (u = 0, no u read:
//   the exact-geometry level operator) and in every CG iteration with the
//   Neo-Hooke tangent and the mass.  Its dense first pass did 5,008 flops
//   per element in the linear mode and 12,936 with the mass, limited by its
//   instruction rate (210 registers with the mass).  Now it works by the 12
//   edges of the element, on one edge table of the reference gradients dN
//   built in the block prologue (lattice_common.cuh): J, Hhat(v) and Hhat(u)
//   are 36 FMAs each on the edge differences of x, v and u, which stay in
//   registers through the Gauss loop with 36 edge sums; the inverse never
//   forms (wdet P Jinv^T = w P cof(J), the one division per Gauss point on
//   the weight); the Neo-Hooke tangent is taken in deformation-gradient form
//   as B2 takes it; the mass keeps det J of the 8 Gauss points in registers
//   and reads v's corners again after the loop.  3,088 flops per element in
//   the linear mode, 6,724 with the mass.  At most 128 registers in the
//   linear mode (4 blocks per SM) and 168 with u (3 blocks): the compiler's
//   own 154 and 212-221 are 12% and 7-8% slower.  On the coarse GMG levels,
//   with fewer than 72 elements per SM (n=18: 44 on 132 SMs), the time
//   is one thread's chain of 8 Gauss points plus the launch floor: there the
//   linear mode takes 8 lanes per element, one Gauss point each, and sums
//   each node's 3 values from the lanes' results in shared memory in a fixed
//   order (tangent_gen_gp_kernel).  On an H100 80GB HBM3 at 700 W (float32,
//   a CUDA graph of calls, with the gather; tools/b5_variants.py): linear
//   mode 0.0570-0.0572 ms at n=72 against 0.0725-0.0727 for the first pass,
//   11.0 / 7.4-7.5 / 6.3-6.4 us at n=36 / 18 / 9 against 13.2-13.3 /
//   9.3-9.4 / 8.5; Neo-Hooke with the mass 0.1086-0.1094 ms against
//   0.1696-0.1707.  The gather takes 0.015 ms of the 0.057 at n=72 and
//   3.1-3.5 us on the coarse levels, where each launch has a floor.
//   The hex8 dN, weight and N tables sit in shared memory, loaded from a
//   device pointer.
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
// B2: at least 4 blocks of 128 threads per SM (at most 128 registers; the
// compiler's own choice, 155 in float32, leaves 3 and is slower:
// tools/b2_variants.py)
constexpr int kTangentMinBlocks = 4;
// B5: at least 4 blocks of 128 threads per SM in the linear mode (at most
// 128 registers; the compiler's 154 are 12% slower at n=72) and 3 with u
// (at most 168; the compiler's 212-221 and the cap of 128 are 7-10%
// slower); the linear mode goes by Gauss points while there are fewer than
// 72 elements per SM: on an H100 80GB HBM3 at 700 W (tools/b5_variants.py,
// by a CUDA graph of calls with the gather) it wins at 61 and 70 (8.08-8.10
// against 8.32-8.34 us, 8.54-8.56 against 8.59-8.61) and loses at 81, 92
// and 105 (8.68 against 8.59-8.60 us, 9.01-9.03 against 8.81-8.82,
// 9.38-9.39 against 8.69-8.72)
constexpr int tangent_gen_min_blocks(int model) { return model == kLinear ? 4 : 3; }
constexpr int kGpSwitchPerSm = 72;

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

// B2: fe = K(u) v + mcoef M v of element e by its 12 edges
// (lattice_common.cuh): the edge differences of u and v stay in registers
// through the Gauss loop, each Gauss point accumulates into 36 edge sums,
// which become the 24 nodal values after the loop; the mass is one product
// with the 8x8 element mass of the shared tables (v's corners read again).
// kModel: 0 = Neo-Hooke (deformation-gradient form), 1 = St.
// Venant-Kirchhoff (tangent_stress).
template <typename T, int kModel>
__device__ __forceinline__ void tangent_edge_element(const T* __restrict__ u,
                                                     const T* __restrict__ v,
                                                     const EdgeShared<T>& s, T lam,
                                                     T mu, T mcoef, const Dims& d,
                                                     long long e, T fe[8][3]) {
  T du[3][4][3], dv[3][4][3], R[3][4][3];
  {
    T xe[8][3];
    load_corners(u, d, e, xe);
    edge_diff(xe, du);
    load_corners(v, d, e, xe);
    edge_diff(xe, dv);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) R[j][q][0] = R[j][q][1] = R[j][q][2] = T(0);
#pragma unroll 1
  for (int g = 0; g < 8; ++g) {
    T H[3][3], Hd[3][3], Pd[3][3];
    grad_edges(du, s.Ge[g], H);
    grad_edges(dv, s.Ge[g], Hd);
    if constexpr (kModel == 0)
      tangent_neohooke_F(H, Hd, lam, mu, Pd);
    else
      tangent_stress(H, Hd, lam, mu, 1, Pd);
    accum_edges(Pd, s.Ge[g], s.w[g], R);
  }
  zero_fe(fe);
  if (mcoef != T(0)) {
    T ve[8][3];
    load_corners(v, d, e, ve);
    mass_table(ve, s.Mc, fe);
  }
  edges_to_nodes(R, fe);
}

template <typename T, int kModel>
__global__ void __launch_bounds__(kElemThreads, kTangentMinBlocks)
tangent_elem_kernel(const T* __restrict__ u, const T* __restrict__ v,
                    const T* __restrict__ Gg, const T* __restrict__ wg,
                    const T* __restrict__ Ng, T lam, T mu, T mcoef, Dims d,
                    T* __restrict__ scratch) {
  __shared__ EdgeShared<T> s;
  load_edge_tables(s, Gg, wg, Ng, mcoef);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= d.E) return;
  T fe[8][3];
  tangent_edge_element<T, kModel>(u, v, s, lam, mu, mcoef, d, e, fe);
  store_fe(fe, e, d.E, scratch);
}

// ---------------------------------------------------------------------------
// B4 / B5 element pass on general geometry: one thread per real element (B5's
// linear mode on few elements: one lane per Gauss point).  B4's Gauss loop
// force_gen_element is shared with the element-batch kernels of
// solid_kernels.cu through lattice_common.cuh (shared tables: s.G holds the
// reference gradients dN[g][a][j], not G); B5's edge tables come from dN.
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

// B5 by the 12 edges (lattice_common.cuh): one thread per element holds the
// edge differences of x, v and (unless kLinear) u and 36 edge sums through
// the Gauss loop; with kMass the 8 values det J_g too, and v's corners are
// read again for the consistent mass after the loop.
template <typename T, int kModel, bool kMass, int kMinBlocks>
__global__ void __launch_bounds__(kElemThreads, kMinBlocks)
tangent_gen_edge_kernel(const T* __restrict__ x, const T* __restrict__ u,
                        const T* __restrict__ v, const T* __restrict__ dNg,
                        const T* __restrict__ wg, const T* __restrict__ Ng, T lam,
                        T mu, T mcoef, Dims d, T* __restrict__ scratch) {
  __shared__ GenEdgeShared<T> s;
  load_gen_edge_tables(s, dNg, wg, Ng);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= d.E) return;
  T dx[3][4][3], du[3][4][3], dv[3][4][3], R[3][4][3], c[8];
  {
    T xe[8][3];
    load_corners(x, d, e, xe);
    edge_diff(xe, dx);
    if constexpr (kModel != kLinear) {
      load_corners(u, d, e, xe);
      edge_diff(xe, du);
    }
    load_corners(v, d, e, xe);
    edge_diff(xe, dv);
  }
  tangent_gen_edge_element<T, kModel, kMass>(dx, du, dv, s, lam, mu, R, c);
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

// B5's linear mode mapped by Gauss points, for the coarse GMG levels, where
// one thread per element leaves the card nearly empty and the kernel is one
// thread's chain of 8 Gauss points: 8 lanes of a warp take one element, one
// Gauss point each, and write their Q (tangent_gen_gp) to shared memory;
// after a __syncwarp lane a sums the 3 values of node a,
// fe[a][i] = sum_g sum_j Q_g[i][j] dN[g][a][j], in a fixed order.
constexpr int kGpElems = kElemThreads / 8;  // elements per block

template <typename T>
__global__ void __launch_bounds__(kElemThreads)
tangent_gen_gp_kernel(const T* __restrict__ x, const T* __restrict__ v,
                      const T* __restrict__ dNg, const T* __restrict__ wg, T lam,
                      T mu, Dims d, T* __restrict__ scratch) {
  __shared__ GenEdgeShared<T> s;
  __shared__ T Qs[kGpElems][8][9];
  load_gen_edge_tables(s, dNg, wg, (const T*)nullptr);
  const int le = threadIdx.x >> 3, g = threadIdx.x & 7;
  const long long e = (long long)blockIdx.x * kGpElems + le;
  const bool live = e < d.E;
  if (live) {
    T dx[3][4][3], dv[3][4][3], J[3][3], Q[3][3];
    {
      T xe[8][3];
      load_corners(x, d, e, xe);
      edge_diff(xe, dx);
      load_corners(v, d, e, xe);
      edge_diff(xe, dv);
    }
    grad_edges(dx, s.Ge[g], J);
    tangent_gen_gp<T, kLinear>(J, dv, dv, s.Ge[g], s.w[g], lam, mu, Q);  // no u
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Qs[le][g][i * 3 + j] = Q[i][j];
  }
  __syncwarp();
  if (!live) return;
  const int a = g;  // this lane's node
  T f0 = T(0), f1 = T(0), f2 = T(0);
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int side = j == 0 ? ox(a) : j == 1 ? oy(a) : oz(a);
      const T gj = side ? s.Ge[q][j][node_edge(a, j)] : -s.Ge[q][j][node_edge(a, j)];
      f0 += Qs[le][q][j] * gj;
      f1 += Qs[le][q][3 + j] * gj;
      f2 += Qs[le][q][6 + j] * gj;
    }
  scratch[(a * 3 + 0) * d.E + e] = f0;
  scratch[(a * 3 + 1) * d.E + e] = f1;
  scratch[(a * 3 + 2) * d.E + e] = f2;
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
  const unsigned int blocks = blocks_for(d.E, kElemThreads);
  if (model == 0)
    tangent_elem_kernel<T, 0><<<blocks, kElemThreads, 0, st>>>(
        u, v, G, w, N, (T)lam, (T)mu, (T)mcoef, d, scratch);
  else
    tangent_elem_kernel<T, 1><<<blocks, kElemThreads, 0, st>>>(
        u, v, G, w, N, (T)lam, (T)mu, (T)mcoef, d, scratch);
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

template <typename T, int kModel>
void launch_tangent_gen_edge(const T* x, const T* u, const T* v, const T* dN,
                             const T* w, const T* N, T lam, T mu, T mcoef,
                             const Dims& d, T* scratch, cudaStream_t st) {
  const unsigned int blocks = blocks_for(d.E, kElemThreads);
  if (mcoef != T(0))
    tangent_gen_edge_kernel<T, kModel, true, tangent_gen_min_blocks(kModel)>
        <<<blocks, kElemThreads, 0, st>>>(x, u, v, dN, w, N, lam, mu, mcoef, d,
                                          scratch);
  else
    tangent_gen_edge_kernel<T, kModel, false, tangent_gen_min_blocks(kModel)>
        <<<blocks, kElemThreads, 0, st>>>(x, u, v, dN, w, N, lam, mu, mcoef, d,
                                          scratch);
}

// The linear mode without the mass goes by Gauss points while the elements
// are fewer than kGpSwitchPerSm per SM of the current device (the GMG
// levels n=18 and 9 of the jittered path, not n=36 or 72).  The SM count is
// read on every call (a cached attribute of the runtime), so each device
// gets its own switch; a failed query is returned as the launch's error.
inline cudaError_t by_gauss_points(const Dims& d, bool* gp) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *gp = d.E < (long long)kGpSwitchPerSm * sms;
  return err;
}

// u == nullptr: the linear mode (u = 0)
template <typename T>
int tangent_gen(const T* x, const T* u, const T* v, const T* dN, const T* w,
                const T* N, double lam, double mu, int model, double mcoef,
                T* scratch, T* out, int nx, int ny, int nz, void* stream) {
  const Dims d(nx, ny, nz);
  const cudaStream_t st = (cudaStream_t)stream;
  const T l = (T)lam, m = (T)mu, c = (T)mcoef;
  bool gp = false;
  if (u == nullptr && mcoef == 0.0) {
    const cudaError_t err = by_gauss_points(d, &gp);
    if (err != cudaSuccess) return (int)err;
  }
  if (gp)
    tangent_gen_gp_kernel<T><<<blocks_for(d.E, kGpElems), kElemThreads, 0, st>>>(
        x, v, dN, w, l, m, d, scratch);
  else if (u == nullptr)
    launch_tangent_gen_edge<T, kLinear>(x, u, v, dN, w, N, l, m, c, d, scratch, st);
  else if (model == 0)
    launch_tangent_gen_edge<T, 0>(x, u, v, dN, w, N, l, m, c, d, scratch, st);
  else
    launch_tangent_gen_edge<T, 1>(x, u, v, dN, w, N, l, m, c, d, scratch, st);
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

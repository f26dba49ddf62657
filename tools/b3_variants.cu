// Variants of the B3 stencil kernel, for timing with tools/b3_variants.py.
//
// It includes fourc_tpu_torch/csrc/lattice_kernels.cu, so the shipped
// launcher fourc::stencil is here too, and builds its other versions from
// the same device functions: the element walk that the 27-point design
// replaced, the shipped design with other rows per thread and threads per
// block, two earlier prologues and thread mappings, and three cut-down
// versions that run one part only (their output is not y = A v).

#include "lattice_kernels.cu"

namespace b3v {
using namespace fourc;

enum Mode {
  kFull,          // the shipped design
  kShellOnly,     // shell threads only             (cut down)
  kInteriorOnly,  // interior threads only          (cut down)
  kPrologueOnly,  // the prologue only              (cut down)
  kTwoBarriers,   // K to shared, then S from shared K in every block
  kTwoBarriersSkip,  // the same, S skipped in blocks of shell nodes only
  kMixedBlock,    // one barrier, interior threads right after the shell
};

// First interior thread: right after the shell, or (shipped) at a whole
// block.
template <int TH, int MODE>
__host__ __device__ long long shell_end(const Dims& d) {
  const long long n_bnd = d.n - interior_nodes(d);
  if (MODE == kTwoBarriers || MODE == kTwoBarriersSkip || MODE == kMixedBlock)
    return n_bnd;
  return (n_bnd + TH - 1) / TH * TH;
}

template <typename T, int TH>
__device__ void sum_s(const T* __restrict__ Kg, const T* K, T* S,
                      bool from_shared) {
  for (int q = threadIdx.x; q < 243; q += TH) {
    const int dd = q / 9, i = (q / 3) % 3, j = q % 3;
    const int dx = dd / 9 - 1, dy = (dd / 3) % 3 - 1, dz = dd % 3 - 1;
    T s = T(0);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int x = ox(a) + dx, y = oy(a) + dy, z = oz(a) + dz;
      if ((unsigned)x > 1u || (unsigned)y > 1u || (unsigned)z > 1u) continue;
      const int off = (a * 3 + i) * 24 + hex8_node(x, y, z) * 3 + j;
      s += from_shared ? K[off] : __ldg(Kg + off);
    }
    S[dd * kSBlock + 4 * i + j] = s;
  }
}

template <typename T, int R, int TH, int MB, int MODE>
__global__ void __launch_bounds__(TH, MB)
variant(const T* __restrict__ Kg, const T* __restrict__ v, T* __restrict__ out,
        Dims d) {
  __shared__ T K[576];
  __shared__ __align__(16) T S[27 * kSBlock];
  const long long first = (long long)blockIdx.x * TH;
  const long long t = first + threadIdx.x;
  const long long n_bnd = d.n - interior_nodes(d);
  const long long n_shell = shell_end<TH, MODE>(d);
  if (MODE == kTwoBarriers || MODE == kTwoBarriersSkip) {
    for (int q = threadIdx.x; q < 576; q += TH) K[q] = Kg[q];
    __syncthreads();
    if (MODE == kTwoBarriers || first + TH > n_bnd) {
      sum_s<T, TH>(Kg, K, S, true);
      __syncthreads();
    }
  } else if (MODE == kMixedBlock) {
    if (first < n_bnd)
      for (int q = threadIdx.x; q < 576; q += TH) K[q] = Kg[q];
    if (first + TH > n_bnd) sum_s<T, TH>(Kg, K, S, false);
    __syncthreads();
  } else {
    stencil_prologue(Kg, K, S, first < n_shell);
  }
  if (MODE == kPrologueOnly) return;
  if (t < n_shell) {
    if (MODE == kInteriorOnly || t >= n_bnd) return;
    int i, j, k;
    shell_node(d, t, i, j, k);
    stencil_node(K, v, out, d, i, j, k);
    return;
  }
  if (MODE == kShellOnly) return;
  const long long u = t - n_shell;
  if (u >= interior_threads<R>(d)) return;
  const int nk = d.nz - 1, jb = (d.ny - 1 + R - 1) / R;
  const int k = 2 + (int)(u % nk);
  const int j0 = 2 + R * (int)((u / nk) % jb);
  const int i = 2 + (int)(u / nk / jb);
  stencil_rows<T, R>(S, v, out, d, i, j0, k, min(R, d.ny + 1 - j0));
}

template <typename T, int R, int TH, int MB, int MODE>
int launch(const T* K, const T* v, T* out, int nx, int ny, int nz, void* s) {
  const Dims d(nx, ny, nz);
  const long long threads = shell_end<TH, MODE>(d) + interior_threads<R>(d);
  variant<T, R, TH, MB, MODE>
      <<<blocks_for(threads, TH), TH, 0, (cudaStream_t)s>>>(K, v, out, d);
  return (int)cudaGetLastError();
}

// The element walk: one thread per padded node over its <= 8 elements,
// K coefficients from shared memory.
template <typename T>
__global__ void __launch_bounds__(256)
walk(const T* __restrict__ Kg, const T* __restrict__ v, T* __restrict__ out,
     Dims d) {
  __shared__ T K[576];
  for (int t = threadIdx.x; t < 576; t += blockDim.x) K[t] = Kg[t];
  __syncthreads();
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= d.n) return;
  const int k = (int)(p % d.Z);
  const int j = (int)((p / d.Z) % d.Y);
  const int i = (int)(p / ((long long)d.Y * d.Z));
  stencil_node(K, v, out, d, i, j, k);
}

template <typename T>
int launch_walk(const T* K, const T* v, T* out, int nx, int ny, int nz, void* s) {
  const Dims d(nx, ny, nz);
  walk<T><<<blocks_for(d.n, 256), 256, 0, (cudaStream_t)s>>>(K, v, out, d);
  return (int)cudaGetLastError();
}

}  // namespace b3v

#define B3V_EXPORT extern "C" __attribute__((visibility("default")))
#define B3V_PAIR(name, call)                                                   \
  B3V_EXPORT int b3v_##name##_f32(const float* K, const float* v, float* out, \
                                  int nx, int ny, int nz, void* s) {          \
    return call<float>(K, v, out, nx, ny, nz, s);                             \
  }                                                                           \
  B3V_EXPORT int b3v_##name##_f64(const double* K, const double* v,          \
                                  double* out, int nx, int ny, int nz,        \
                                  void* s) {                                  \
    return call<double>(K, v, out, nx, ny, nz, s);                            \
  }
#define B3V(name, R, TH, MB, MODE)                                             \
  namespace b3v {                                                             \
  template <typename T>                                                       \
  int name(const T* K, const T* v, T* out, int nx, int ny, int nz, void* s) { \
    return launch<T, R, TH, MB, MODE>(K, v, out, nx, ny, nz, s);              \
  }                                                                           \
  }                                                                           \
  B3V_PAIR(name, b3v::name)

B3V_PAIR(shipped, fourc::stencil)
B3V_PAIR(walk, b3v::launch_walk)
B3V(r1_t128, 1, 128, 5, b3v::kFull)
B3V(r2_t128, 2, 128, 5, b3v::kFull)
B3V(r8_t128, 8, 128, 5, b3v::kFull)
B3V(r1_t256, 1, 256, 2, b3v::kFull)
B3V(r2_t256, 2, 256, 2, b3v::kFull)
B3V(r4_t256, 4, 256, 2, b3v::kFull)
B3V(two_barriers, 4, 128, 5, b3v::kTwoBarriers)
B3V(two_barriers_skip, 4, 128, 5, b3v::kTwoBarriersSkip)
B3V(mixed_block, 4, 128, 5, b3v::kMixedBlock)
B3V(shell_only, 4, 128, 5, b3v::kShellOnly)
B3V(interior_only, 4, 128, 5, b3v::kInteriorOnly)
B3V(prologue_only, 4, 128, 5, b3v::kPrologueOnly)

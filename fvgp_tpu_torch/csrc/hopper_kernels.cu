// Hand-written Hopper (sm_90a) kernels of fvgp_tpu_torch: the block-sparse
// SpMMs of the gp2Scale path and the dense covariance assembly of the dense
// path.
//
// Block-sparse SpMMs.  Three kernels reduce "segments" of a tile list: for
// segment s with tiles t in [begin(s), end(s)),
//
//     out[s] = sum_t tiles[t] @ X_block[min(cols[t], nb - 1)]
//
// with tiles (T, B, B) row-major, X (nb * B, k) row-major, out (n_seg, B, k).
// Inputs are float32 or bfloat16 (tiles and X of one type), read through
// __bfloat162float and accumulated in float32 registers.
//
// * fvgp_chunked_spmm (K1): segments are the output row blocks of a row-sorted
//   tile list given as CSR row offsets, so out IS the (nb * B, k) product, in
//   float32.  Replaces the Pallas chunked_spmm (fvgp_tpu/ops/pallas_kernels.py,
//   _chunked_spmm_call).
// * fvgp_row_chunk_sums (K2): segments are fixed runs of C tiles of a
//   row-aligned schedule; out[s] is the chunk's float32 partial sum.  The
//   kernel reads the X blocks through cols itself instead of a pre-gathered X.
//   Replaces the Pallas row_chunk_sums (_chunk_sums_call).
// * fvgp_block_spmv (K4): the product of K1 over CSR row offsets, written in
//   X's type (float32 or bfloat16).  Row blocks that own no tile have an empty
//   segment and are written as zero by the kernel.  Replaces the Pallas
//   block_spmv (_block_spmv_call), whose one-tile-per-grid-step sequential
//   grid carried the output block in VMEM.
//
// One thread block owns one (row slice x 32-column slice) of one segment and
// writes it once: no atomics, and the result does not depend on scheduling.
// Bound: the tile stream (T * B * B elements) is the dominant traffic; at
// k = 17 the arithmetic (2 * k flops per tile element on the CUDA cores) sits
// near the card's float32 ridge, at k >= 64 it is above it.  The design keeps
// each tile element read from device memory once per 32 output columns
// (column slices of one segment are adjacent block ids, so repeat reads hit
// L2), stages the tile and X in shared memory in 32-deep slices, and
// register-blocks 4 columns x RM rows per thread.  Tensor cores (wgmma) are
// not used yet.
//
// Dense covariance (K3, fvgp_dense_covariance).  K[i, j] = var * poly(d_ij)
// with d_ij = |z1_i - z2_j| from exact per-dimension differences of the
// whitened inputs (never the |a|^2 + |b|^2 - 2ab expansion, which loses the
// diagonal to cancellation), poly = Matern-3/2 or the C4 Wendland polynomial.
// Replaces the Pallas dense_covariance (_dense_cov_call).  Float32 or float64
// throughout (the TPU version ran float32 only).  A 32 x 32 output tile per
// thread block; the tile's 32 whitened rows and 32 columns (D <= 32) sit in
// shared memory, one thread computes 4 output elements of one column, and a
// warp writes 32 consecutive elements of an output row.  Bound: the output
// write (n1 * n2 elements) — the inputs are (n1 + n2) * D elements and the
// arithmetic is ~3 D + 7 operations per element, far below the ridge.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kColGroups = 8;                  // threads across columns
constexpr int kRowGroups = kThreads / kColGroups;
constexpr int kRN = 4;                         // columns per thread
constexpr int kKT = kColGroups * kRN;          // 32 output columns per block
constexpr int kLK = 32;                        // contraction slice depth

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// RM rows per thread; a block covers RB = RM * kRowGroups output rows.
template <typename T, int RM, typename OutT>
__global__ void __launch_bounds__(kThreads)
segment_spmm_kernel(const T* __restrict__ tiles, const T* __restrict__ X,
                    const int* __restrict__ seg_ptr, int chunk,
                    const int* __restrict__ cols, OutT* __restrict__ out,
                    long long n_seg, int B, int k, int nb,
                    int n_col_tiles, int n_row_tiles) {
  constexpr int RB = RM * kRowGroups;
  __shared__ float As[RB][kLK + 1];
  __shared__ __align__(16) float Xs[kLK][kKT];

  const long long bid = blockIdx.x;
  const int rt = static_cast<int>(bid % n_row_tiles);
  const int ct = static_cast<int>((bid / n_row_tiles) % n_col_tiles);
  const long long seg = bid / (static_cast<long long>(n_row_tiles) * n_col_tiles);
  if (seg >= n_seg) return;
  const int row0 = rt * RB;
  const int col0 = ct * kKT;

  long long t_begin, t_end;
  if (seg_ptr != nullptr) {
    t_begin = seg_ptr[seg];
    t_end = seg_ptr[seg + 1];
  } else {
    t_begin = seg * chunk;
    t_end = t_begin + chunk;
  }

  const int tx = threadIdx.x % kColGroups;
  const int ty = threadIdx.x / kColGroups;
  float acc[RM][kRN];
#pragma unroll
  for (int m = 0; m < RM; ++m)
#pragma unroll
    for (int r = 0; r < kRN; ++r) acc[m][r] = 0.f;

  const long long BB = static_cast<long long>(B) * B;
  for (long long t = t_begin; t < t_end; ++t) {
    int c = cols[t];
    c = c < nb - 1 ? c : nb - 1;
    const T* A = tiles + t * BB + static_cast<long long>(row0) * B;
    const T* Xblk = X + static_cast<long long>(c) * B * k;
    for (int l0 = 0; l0 < B; l0 += kLK) {
      for (int e = threadIdx.x; e < RB * kLK; e += kThreads) {
        const int i = e / kLK, l = e % kLK;
        As[i][l] = to_f32(A[static_cast<long long>(i) * B + l0 + l]);
      }
      for (int e = threadIdx.x; e < kLK * kKT; e += kThreads) {
        const int l = e / kKT, j = e % kKT;
        const int col = col0 + j;
        Xs[l][j] = col < k ? to_f32(Xblk[static_cast<long long>(l0 + l) * k + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int l = 0; l < kLK; ++l) {
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[l][tx * kRN]);
#pragma unroll
        for (int m = 0; m < RM; ++m) {
          const float a = As[ty + m * kRowGroups][l];
          acc[m][0] = fmaf(a, xv.x, acc[m][0]);
          acc[m][1] = fmaf(a, xv.y, acc[m][1]);
          acc[m][2] = fmaf(a, xv.z, acc[m][2]);
          acc[m][3] = fmaf(a, xv.w, acc[m][3]);
        }
      }
      __syncthreads();
    }
  }

  OutT* o = out + seg * static_cast<long long>(B) * k;
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int i = row0 + ty + m * kRowGroups;
#pragma unroll
    for (int r = 0; r < kRN; ++r) {
      const int j = col0 + tx * kRN + r;
      if (j < k) store(&o[static_cast<long long>(i) * k + j], acc[m][r]);
    }
  }
}

template <typename T, typename OutT>
int launch_t(const void* tiles, const void* X, const int* seg_ptr, int chunk,
             const int* cols, void* out, long long n_seg, int B, int k, int nb,
             cudaStream_t stream) {
  if (B < 32 || B % 32 != 0 || k < 1 || nb < 1 || n_seg < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_seg == 0) return static_cast<int>(cudaSuccess);
  const int n_col_tiles = (k + kKT - 1) / kKT;
  const bool wide_rows = (B % (4 * kRowGroups)) == 0;
  const int RB = (wide_rows ? 4 : 2) * kRowGroups;
  const int n_row_tiles = B / RB;
  const long long blocks = n_seg * n_col_tiles * n_row_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks));
  const T* tp = static_cast<const T*>(tiles);
  const T* xp = static_cast<const T*>(X);
  OutT* op = static_cast<OutT*>(out);
  if (wide_rows)
    segment_spmm_kernel<T, 4, OutT><<<grid, kThreads, 0, stream>>>(
        tp, xp, seg_ptr, chunk, cols, op, n_seg, B, k, nb, n_col_tiles, n_row_tiles);
  else
    segment_spmm_kernel<T, 2, OutT><<<grid, kThreads, 0, stream>>>(
        tp, xp, seg_ptr, chunk, cols, op, n_seg, B, k, nb, n_col_tiles, n_row_tiles);
  return static_cast<int>(cudaGetLastError());
}

// out_in_x_type: false -> float32 output (K1, K2), true -> output in X's type (K4).
int launch(int dtype, bool out_in_x_type, const void* tiles, const void* X,
           const int* seg_ptr, int chunk, const int* cols, void* out, long long n_seg,
           int B, int k, int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float, float>(tiles, X, seg_ptr, chunk, cols, out, n_seg, B, k, nb, s);
  if (dtype == 1 && out_in_x_type)
    return launch_t<__nv_bfloat16, __nv_bfloat16>(tiles, X, seg_ptr, chunk, cols, out,
                                                  n_seg, B, k, nb, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16, float>(tiles, X, seg_ptr, chunk, cols, out, n_seg, B,
                                          k, nb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// K3: dense covariance
// ---------------------------------------------------------------------------

constexpr int kCovCols = 32;                   // output columns per block (one warp)
constexpr int kCovRowThreads = 8;              // thread rows per block
constexpr int kCovRowsPerThread = 4;
constexpr int kCovRows = kCovRowThreads * kCovRowsPerThread;   // 32 output rows
constexpr int kCovMaxD = 32;

__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_exp(double v) { return exp(v); }

// kind 0: Matern-3/2 (1 + a) exp(-a), a = sqrt(3) d.
// kind 1: C4 Wendland (1 - d)^8 (32 d^3 + 25 d^2 + 8 d + 1) on d clipped at 1.
template <typename T, int KIND>
__device__ __forceinline__ T cov_poly(T d) {
  const T one = static_cast<T>(1);
  if (KIND == 0) {
    const T a = static_cast<T>(1.7320508075688772) * d;
    return (one + a) * dev_exp(-a);
  }
  d = d < one ? d : one;
  const T t = one - d;
  const T t2 = t * t;
  const T t4 = t2 * t2;
  return (t4 * t4) * (static_cast<T>(32) * d * d * d + static_cast<T>(25) * d * d +
                      static_cast<T>(8) * d + one);
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kCovCols * kCovRowThreads)
dense_cov_kernel(const T* __restrict__ z1, const T* __restrict__ z2,
                 const T* __restrict__ var, T* __restrict__ out, int n1, int n2, int D) {
  __shared__ T z1s[kCovRows][kCovMaxD];
  __shared__ T z2s[kCovMaxD][kCovCols];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kCovCols + tx;
  const int row0 = blockIdx.y * kCovRows;
  const int col0 = blockIdx.x * kCovCols;
  for (int e = tid; e < kCovRows * D; e += kCovCols * kCovRowThreads) {
    const int i = e / D, d = e % D;
    const int r = row0 + i;
    z1s[i][d] = r < n1 ? z1[static_cast<long long>(r) * D + d] : static_cast<T>(0);
  }
  for (int e = tid; e < kCovCols * D; e += kCovCols * kCovRowThreads) {
    const int j = e / D, d = e % D;
    const int c = col0 + j;
    z2s[d][j] = c < n2 ? z2[static_cast<long long>(c) * D + d] : static_cast<T>(0);
  }
  __syncthreads();
  const int col = col0 + tx;
  if (col >= n2) return;
  const T v = var[0];
#pragma unroll
  for (int r = 0; r < kCovRowsPerThread; ++r) {
    const int i = ty + r * kCovRowThreads;
    const int row = row0 + i;
    if (row >= n1) break;
    T d2 = static_cast<T>(0);
    for (int d = 0; d < D; ++d) {
      const T diff = z1s[i][d] - z2s[d][tx];
      d2 += diff * diff;
    }
    const T dist = d2 > static_cast<T>(0) ? dev_sqrt(d2) : static_cast<T>(0);
    out[static_cast<long long>(row) * n2 + col] = v * cov_poly<T, KIND>(dist);
  }
}

template <typename T>
int launch_cov(const void* z1, const void* z2, const void* var, void* out, int n1,
               int n2, int D, int kind, cudaStream_t stream) {
  if (n1 < 0 || n2 < 0 || D < 1 || D > kCovMaxD || (kind != 0 && kind != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n1 == 0 || n2 == 0) return static_cast<int>(cudaSuccess);
  const long long gy = (static_cast<long long>(n1) + kCovRows - 1) / kCovRows;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((n2 + kCovCols - 1) / kCovCols, static_cast<unsigned>(gy));
  const dim3 block(kCovCols, kCovRowThreads);
  const T* a = static_cast<const T*>(z1);
  const T* b = static_cast<const T*>(z2);
  const T* v = static_cast<const T*>(var);
  T* o = static_cast<T*>(out);
  if (kind == 0)
    dense_cov_kernel<T, 0><<<grid, block, 0, stream>>>(a, b, v, o, n1, n2, D);
  else
    dense_cov_kernel<T, 1><<<grid, block, 0, stream>>>(a, b, v, o, n1, n2, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (tiles and X alike).  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int fvgp_chunked_spmm(const void* tiles, const void* X, const int* row_ptr,
                                 const int* cols, float* out, int nb, int B, int k,
                                 int dtype, void* stream) {
  return launch(dtype, false, tiles, X, row_ptr, 0, cols, out, nb, B, k, nb, stream);
}

extern "C" int fvgp_row_chunk_sums(const void* tiles, const void* X, const int* cols,
                                   float* out, long long n_chunks, int C, int nb, int B,
                                   int k, int dtype, void* stream) {
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(dtype, false, tiles, X, nullptr, C, cols, out, n_chunks, B, k, nb, stream);
}

// K4: out (nb * B, k) in X's type (dtype 0 = float32, 1 = bfloat16).
extern "C" int fvgp_block_spmv(const void* tiles, const void* X, const int* row_ptr,
                               const int* cols, void* out, int nb, int B, int k,
                               int dtype, void* stream) {
  return launch(dtype, true, tiles, X, row_ptr, 0, cols, out, nb, B, k, nb, stream);
}

// K3: z1 (n1, D), z2 (n2, D) whitened, var (1,), out (n1, n2); all of one type,
// dtype 0 = float32, 2 = float64; kind 0 = Matern-3/2, 1 = Wendland.
extern "C" int fvgp_dense_covariance(const void* z1, const void* z2, const void* var,
                                     void* out, int n1, int n2, int D, int kind,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_cov<float>(z1, z2, var, out, n1, n2, D, kind, s);
  if (dtype == 2) return launch_cov<double>(z1, z2, var, out, n1, n2, D, kind, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

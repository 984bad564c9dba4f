// Block-sparse SpMM kernels of the gp2Scale path, written for Hopper (sm_90a).
//
// Both kernels reduce "segments" of a tile list: for segment s with tiles
// t in [begin(s), end(s)),
//
//     out[s] = sum_t tiles[t] @ X_block[min(cols[t], nb - 1)]
//
// with tiles (T, B, B) row-major, X (nb * B, k) row-major, out (n_seg, B, k)
// float32.  Inputs are float32 or bfloat16 (tiles and X of one type), read
// through __bfloat162float and accumulated in float32 registers.
//
// * fvgp_chunked_spmm (K1): segments are the output row blocks of a row-sorted
//   tile list given as CSR row offsets, so out IS the (nb * B, k) product.
//   Replaces the Pallas chunked_spmm (fvgp_tpu/ops/pallas_kernels.py).
// * fvgp_row_chunk_sums (K2): segments are fixed runs of C tiles of a
//   row-aligned schedule; out[s] is the chunk's partial sum.  The kernel reads
//   the X blocks through cols itself instead of a pre-gathered X.  Replaces
//   the Pallas row_chunk_sums.
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

// RM rows per thread; a block covers RB = RM * kRowGroups output rows.
template <typename T, int RM>
__global__ void __launch_bounds__(kThreads)
segment_spmm_kernel(const T* __restrict__ tiles, const T* __restrict__ X,
                    const int* __restrict__ seg_ptr, int chunk,
                    const int* __restrict__ cols, float* __restrict__ out,
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

  float* o = out + seg * static_cast<long long>(B) * k;
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int i = row0 + ty + m * kRowGroups;
#pragma unroll
    for (int r = 0; r < kRN; ++r) {
      const int j = col0 + tx * kRN + r;
      if (j < k) o[static_cast<long long>(i) * k + j] = acc[m][r];
    }
  }
}

template <typename T>
int launch_t(const void* tiles, const void* X, const int* seg_ptr, int chunk,
             const int* cols, float* out, long long n_seg, int B, int k, int nb,
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
  if (wide_rows)
    segment_spmm_kernel<T, 4><<<grid, kThreads, 0, stream>>>(
        tp, xp, seg_ptr, chunk, cols, out, n_seg, B, k, nb, n_col_tiles, n_row_tiles);
  else
    segment_spmm_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
        tp, xp, seg_ptr, chunk, cols, out, n_seg, B, k, nb, n_col_tiles, n_row_tiles);
  return static_cast<int>(cudaGetLastError());
}

int launch(int dtype, const void* tiles, const void* X, const int* seg_ptr, int chunk,
           const int* cols, float* out, long long n_seg, int B, int k, int nb,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(tiles, X, seg_ptr, chunk, cols, out, n_seg, B, k, nb, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(tiles, X, seg_ptr, chunk, cols, out, n_seg, B, k, nb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (tiles and X alike).  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int fvgp_chunked_spmm(const void* tiles, const void* X, const int* row_ptr,
                                 const int* cols, float* out, int nb, int B, int k,
                                 int dtype, void* stream) {
  return launch(dtype, tiles, X, row_ptr, 0, cols, out, nb, B, k, nb, stream);
}

extern "C" int fvgp_row_chunk_sums(const void* tiles, const void* X, const int* cols,
                                   float* out, long long n_chunks, int C, int nb, int B,
                                   int k, int dtype, void* stream) {
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(dtype, tiles, X, nullptr, C, cols, out, n_chunks, B, k, nb, stream);
}

// Hand-written Hopper (sm_90a) kernels of fvgp_tpu_torch: the block-sparse
// SpMMs of the gp2Scale path and the dense covariance assembly of the dense
// path.
//
// Block-sparse SpMMs.  Three products reduce "segments" of a tile list: for
// segment s with tiles t in [begin(s), end(s)),
//
//     out[s] = sum_t tiles[t] @ X_block[min(cols[t], nb - 1)]
//
// with tiles (T, B, B) row-major, X (nb * B, ldx) row-major holding the k
// live columns first (the wrappers pad ldx to a multiple of 8, so every row
// of X is 16-byte aligned for the asynchronous copies), out (n_seg, B, k)
// row-major.  Tiles and X are float32 or bfloat16, of one type; sums are
// float32.
//
// * fvgp_chunked_spmm (K1): segments are the output row blocks of a row-sorted
//   tile list given as CSR row offsets, so out IS the (nb * B, k) product, in
//   float32.  Replaces the Pallas chunked_spmm (fvgp_tpu/ops/pallas_kernels.py,
//   _chunked_spmm_call).
// * fvgp_block_spmv (K4): the same product written in X's type, over the
//   caller's own index tensors: row blocks that own no tile have an empty
//   segment and are written as zero, sentinel rows (>= nb) lie past the last
//   row offset and are skipped, sentinel columns are clamped where X is
//   read.  X may end inside its last block and the output inside the last
//   row block: the X slices are copied with cp.async's zero-fill predicate
//   past X's last row, and rows past the output's length are not stored, so
//   the wrapper pads nothing along the rows.  Replaces the Pallas block_spmv
//   (_block_spmv_call).
// * fvgp_row_chunk_sums (K2): segments are fixed runs of C tiles of a
//   row-aligned schedule; out[s] is the chunk's float32 partial sum.  Replaces
//   the Pallas row_chunk_sums (_chunk_sums_call).
//
// K1 and K4: segment_mma_kernel.  k = 1 + probes is narrow (17 on the
// training path), so K1 is bound by the tile stream: T * B * B elements
// read once against ~2 k operations each, far below the tensor cores' ridge.
// One thread block owns a 64-row slice of one segment and a column tile of
// 8 * NF columns (k = 17 is one tile of 3 n8 fragments), writes it once (no
// atomics, a deterministic result) and streams the segment's tile slices
// (64 rows x 128 bytes: 64 bfloat16 or 32 float32 deep, 8 KB) with the
// matching X slices through a 4-stage cp.async ring in shared memory: three
// slices stay in flight while the tensor cores work on the fourth.  A grid
// of at most two waves starts the longest rows first.  Each warp computes
// 16 rows: bfloat16 on mma.sync m16n8k16 (operands by ldmatrix), float32 on
// mma.sync m16n8k8 with a 3xTF32 split (a = hi + lo, both rounded to TF32;
// lo*hi + hi*lo + hi*hi summed in float32, a fresh partial per stage), which
// keeps float32 accuracy where one TF32 pass keeps ~3 digits.  At these
// widths mma.sync is the right tool: its fragments are read from shared
// memory in any layout, so X needs no split copy, and the bytes, not the
// products, set the time.
//
// Float32 K2: segment_mma_kernel_wgmma_tf32.  The committed posterior's
// products are wide (c = 512 columns narrowing to 8), so the 3xTF32
// operations set its bound: 3 * 2 * B * B * c a tile against 4 * B * B
// bytes.  On mma.sync every warp split its X fragments again, every column
// tile split the tile again, and a block of 64 rows x 64 columns streamed
// each tile slice to c / 64 blocks: 15.5% of the bound at c = 128-512.
// This body issues wgmma m64nNk8 (N <= 128, the fewest column tiles that
// cover c) with the same arithmetic: a = hi + lo rounded as split_tf32
// rounds, lo*hi + hi*lo + hi*hi into a fresh float32 partial each 32-deep
// stage (scale-d 0 on its first product), added to the sum with
// round-to-nearest adds.  wgmma's TF32 form reads shared-memory operands
// K-major only: the tile slice is K-major as stored and X's slice is
// N-major.  So the tile is the register operand A (each consumer thread
// loads its two rows' 8 values as two 16-byte reads and splits them), and
// each stage's X slice is split once, into hi and lo buffers written
// K-major and 128-byte swizzled, which both consumer warpgroups (the
// block's 128 rows) read as operand B.  A persistent block of two consumer
// warpgroups and a producer warp walks over (chunk, row group, column tile)
// items; the producer reads the chunk's cols, skips its padding tiles (cols
// >= nb, zero by the committed solver's construction) and issues TMA copies
// of the tile slice and of the X slice at its column block into a 4-stage
// mbarrier ring.  While the tensor cores work on stage g, the consumers
// split stage g + 1's X slice into the other split buffer and load its A
// fragments; the producer's warpgroup gives its registers to them
// (setmaxnreg 40 / 232), which hold the sum, the partial and two stages' A
// fragments.  What bounds it on this card is shared memory: per stage the
// copies land 32 KB, the split reads 16 and writes 32, the A loads read 16
// and the products read B 96 KB (2 warpgroups x 12 x 4 KB), and the time
// follows those bytes (measured at c = 512 on the N = 50k structure: 1.59
// ms as it is, 0.82 ms without the products, 1.09 ms with one product of
// three, as bytes of 192, 96 and 128 KB a stage predict; PERF.md, section
// 6).
//
// Bfloat16 K2: chunk_sums_wgmma_kernel.  A chunk is a GEMM of B x (C * B) @
// (C * B) x c (128 x 1024 @ 1024 x 128 on the posterior path), far above the
// SIMT float32 peak, so it runs on wgmma and is bound by the bytes of its
// tiles (and of the gathered X blocks where they miss L2).  A persistent
// block of one or two consumer warpgroups and one producer warp walks over
// (chunk, row group, column tile) items.  The producer reads the chunk's cols
// and issues TMA copies: the tile slice from a 3-D tensor map over the tiles
// (T, B, B) and the X slice from a 3-D map over X (nb, B, ldx) at block
// min(cols[t], nb - 1), so the gather is folded into the copy; the maps'
// bounds zero-fill what lies past B or past ldx, so any B that is a multiple
// of 32 takes the same 64-deep slices.  Both land 128-byte swizzled in a
// 4-stage ring guarded by mbarriers.  The consumers issue wgmma m64nNk16
// (N = 64, 128 or 256; wider c is tiled) with the tile K-major and X
// MN-major (wgmma's transpose bit), keep the sums in registers and store
// them as float32 straight from there.
//
// Dense covariance (K3, fvgp_dense_covariance).  K[i, j] = var * poly(d_ij)
// with d_ij = |x1_i / l - x2_j / l| from exact per-dimension differences of
// the whitened inputs (never the |a|^2 + |b|^2 - 2ab expansion, which loses
// the diagonal to cancellation), poly = Matern-3/2 or the C4 Wendland
// polynomial.  Replaces the Pallas dense_covariance (_dense_cov_call).
// Float32 or float64 throughout (the TPU version ran float32 only).  The
// function is a write-only stream: (n1 + n2) * D inputs against n1 * n2
// outputs.  In float32 at small D the output write bounds it, and in the
// time the stores take the card's schedulers start only ~35 instructions
// per element, so the body is built to spend few; float64 (software exp and
// sqrt) and float32 at larger D are bound by the arithmetic.  A block of
// 256 threads owns a square tile (128 x 128 float32, 64 x 64 float64) of a
// 1-D grid.  It whitens the tile's rows and columns while loading them (one
// IEEE division per coordinate, so the wrapper launches nothing else), then
// every thread keeps the coordinates of its 4 (float64: 2) columns in
// registers for the whole tile — D is a template parameter for D = 1..4, a
// run-time loop up to 32 — and walks the rows: one shared-memory broadcast
// per dimension, and one 16-byte streaming store per row.  Where n2 is not a
// multiple of 4 (2) the rows of the output are not 16-byte aligned, and a
// scalar-store instance of the same kernel runs, with a warp's columns
// interleaved so that its stores stay contiguous.  The float32 body takes
// the hardware's approximate rsqrt and exp (error below).  For k(X, X) on
// one tensor the kernel can compute only the tiles on and above the
// diagonal and write each tile above it a second time, transposed, below
// it — 32 rows at a time through a swizzled shared-memory buffer, in full
// 128-byte lines.  (a - b)^2 == (b - a)^2 exactly, so that result is bit for
// bit the full computation's, exactly symmetric, with the diagonal exactly
// var.  It halves the arithmetic and adds stores that coalesce less well,
// so the wrapper asks for it where the arithmetic sets the time (float64,
// or D > 4) and not for float32 at D <= 4.
//
// gp2Scale tile assembly (K5, fvgp_tile_covariance and
// fvgp_tile_covariance_vjp): the T covariance tiles of the block-sparse K
// under the library's anisotropic Wendland kernel, tiles[t] = live[t] *
// mask[r_t] (x) mask[c_t] * var * P(d) between point blocks r_t and c_t, and
// the hyperparameter VJP of that assembly.  They replace no Pallas kernel:
// the JAX package assembles the tiles in jnp under jax.checkpoint
// (fvgp_tpu/ops/sparse_lml.py, _assemble_chunked_tiles), which XLA fuses;
// in PyTorch the same chain ran as a dozen elementwise passes over
// (chunk, B, B, D) intermediates and autograd's backward ran it again, two
// thirds of the gp2Scale training step.  Both are streams: the forward
// writes T * B * B tile values (float32 or bfloat16) and the VJP reads as
// many cotangents, against 2 * B * (D + 1) inputs a tile, so those bytes
// bound them.  One block of 256 threads per tile whitens its two point
// blocks into shared memory (K3's arithmetic), every thread takes 16 bytes
// of tile values a step (4 float32 or 8 bfloat16 columns, their coordinates
// in registers), and the VJP recomputes the distances in registers and
// reduces its 1 + D sums inside the block: one float32 partial per tile,
// summed over the tiles by the wrapper in float64 (no atomics).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// cp.async, ldmatrix, mma.sync
// ---------------------------------------------------------------------------

// 16 bytes global -> shared; when !valid nothing is read and zeros land.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, hi and lo rounded to TF32 (10-bit mantissa, nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// ---------------------------------------------------------------------------
// K1, K4, float32 K2: segment_mma_kernel
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;   // 4 warps, 16 output rows each
constexpr int kMmaRows = 64;       // output rows per block
constexpr int kMmaStages = 4;

// A ring stage is 128 bytes deep along the contraction: 64 bfloat16 or 32
// float32 columns of the tile slice (8 KB), with the matching rows of X.
template <typename T>
__host__ __device__ constexpr int k_depth() { return 128 / static_cast<int>(sizeof(T)); }

// Shared-memory row strides (elements), padded so that the fragment reads
// are free of bank conflicts: ldmatrix rows 16-byte chunks apart by an odd
// count (bfloat16), scalar tf32 reads with strides of 4 and 8 banks (float32).
template <typename T>
__host__ __device__ constexpr int a_ld() { return sizeof(T) == 2 ? 64 + 8 : 32 + 4; }
__host__ __device__ constexpr int x_ld(int nt) { return nt % 16 == 0 ? nt + 8 : nt; }
template <typename T, int NF>
__host__ __device__ constexpr int mma_stage_elems() {
  return kMmaRows * a_ld<T>() + k_depth<T>() * x_ld(8 * NF);
}

// One stage: acc[f] += A (warp's 16 rows x depth) @ X (depth x 8 columns of f).
template <int NF, int ALD, int XLD>
__device__ __forceinline__ void mma_stage(const bf16* sA, const bf16* sX, int warp, int lane,
                                          float (&acc)[NF][4]) {
#pragma unroll
  for (int kk = 0; kk < k_depth<bf16>(); kk += 16) {
    uint32_t a[4];
    ldsm_x4(smem_u32(sA + (warp * 16 + lane % 16) * ALD + kk + (lane / 16) * 8), a);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      uint32_t b0, b1;
      ldsm_x2_trans(smem_u32(sX + (kk + lane % 16) * XLD + f * 8), b0, b1);
      mma_bf16(acc[f], a, b0, b1);
    }
  }
}

// The tensor cores' float32 accumulation truncates; summed over a segment's
// whole depth that bias, not the split, would dominate the error.  So each
// stage (12 MMAs for each fragment) sums into a fresh partial, added to acc
// with round-to-nearest float adds.
template <int NF, int ALD, int XLD>
__device__ __forceinline__ void mma_stage(const float* sA, const float* sX, int warp, int lane,
                                          float (&acc)[NF][4]) {
  const int g = lane / 4, t = lane % 4;
  float part[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[f][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < k_depth<float>(); kk += 8) {
    const float* pa = sA + (warp * 16 + g) * ALD + kk + t;
    uint32_t ah[4], al[4];
    split_tf32(pa[0], ah[0], al[0]);
    split_tf32(pa[8 * ALD], ah[1], al[1]);
    split_tf32(pa[4], ah[2], al[2]);
    split_tf32(pa[8 * ALD + 4], ah[3], al[3]);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float* pb = sX + (kk + t) * XLD + f * 8 + g;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(pb[0], bh0, bl0);
      split_tf32(pb[4 * XLD], bh1, bl1);
      mma_tf32(part[f], al, bh0, bh1);
      mma_tf32(part[f], ah, bl0, bl1);
      mma_tf32(part[f], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[f][i] += part[f][i];
}

// Block = (segment, 64-row slice, column tile of 8 * NF): grid index
// ((i * n_row_tiles) + row tile) * n_col_tiles + col tile for the i-th
// segment of the launch order (order[i], or i without one), and the column
// tiles of one slice are neighbours that share its tiles through L2.
// The ring's shared memory lets at most 4 blocks share an SM, so the bound
// gives ptxas 128 registers: without it the compiler aims at more blocks,
// keeps ~70 registers and the float32 body runs 17% longer (measured: 0.664
// against 0.563 ms at N = 50k).
template <typename T, typename OutT, int NF>
__global__ void __launch_bounds__(kMmaThreads, 4)
segment_mma_kernel(const T* __restrict__ tiles, const T* __restrict__ X,
                   const int* __restrict__ seg_ptr, const int* __restrict__ order,
                   const int* __restrict__ cols, OutT* __restrict__ out, int B, int k,
                   int ldx, int nb, long long x_rows, long long out_rows, int n_row_tiles,
                   int n_col_tiles) {
  constexpr int NT = 8 * NF;
  constexpr int KD = k_depth<T>();
  constexpr int ALD = a_ld<T>();
  constexpr int XLD = x_ld(NT);
  constexpr int A_ELEMS = kMmaRows * ALD;
  constexpr int STAGE = mma_stage_elems<T, NF>();
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));   // elements per copy
  constexpr int A_CPR = KD / EPC;                         // copies per tile-slice row
  constexpr int X_CPR = NT / EPC;                         // copies per X-slice row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  long long bid = blockIdx.x;
  const int ct = static_cast<int>(bid % n_col_tiles);
  bid /= n_col_tiles;
  const int rt = static_cast<int>(bid % n_row_tiles);
  const long long seg = order != nullptr ? order[bid / n_row_tiles] : bid / n_row_tiles;
  const int row0 = rt * kMmaRows;
  const int col0 = ct * NT;
  if (seg * B + row0 >= out_rows) return;   // a slice wholly past the ragged end
  const long long t_begin = seg_ptr[seg], t_end = seg_ptr[seg + 1];
  // slices past B (bfloat16 with B % 64 == 32) are zero-filled
  const int kslices = (B + KD - 1) / KD;
  const long long n_steps = (t_end - t_begin) * kslices;
  const long long BB = static_cast<long long>(B) * B;

  // copy cursor (tile, slice, ring slot), advanced one step per call; the
  // tile's column block, and the next tile's, loaded one tile ahead so that
  // its latency hides behind the copies in flight
  long long t_copy = t_begin;
  int ks_copy = 0, slot_copy = 0;
  int col_cur = 0;
  int col_nxt = t_begin < t_end ? cols[t_begin] : 0;
  auto issue = [&]() {
    if (ks_copy == 0) {
      col_cur = min(col_nxt, nb - 1);
      if (t_copy + 1 < t_end) col_nxt = cols[t_copy + 1];
    }
    T* sA = smem + slot_copy * STAGE;
    T* sX = sA + A_ELEMS;
    const int l0 = ks_copy * KD;
    const T* gA = tiles + t_copy * BB + static_cast<long long>(row0) * B + l0;
#pragma unroll
    for (int e = threadIdx.x; e < kMmaRows * A_CPR; e += kMmaThreads) {
      const int r = e / A_CPR, ch = e % A_CPR;
      const bool ok = row0 + r < B && l0 + ch * EPC < B;
      cp_async16(smem_u32(sA + r * ALD + ch * EPC),
                 ok ? gA + static_cast<long long>(r) * B + ch * EPC : tiles, ok);
    }
    // rows of X at or past x_rows (the ragged end of its last block) land
    // as zeros, like the slices past B: x_live rows of this slice are read
    const long long xr0 = static_cast<long long>(col_cur) * B + l0;
    const int x_live = static_cast<int>(min(static_cast<long long>(B - l0), x_rows - xr0));
    const T* gX = X + xr0 * ldx + col0;
#pragma unroll
    for (int e = threadIdx.x; e < KD * X_CPR; e += kMmaThreads) {
      const int r = e / X_CPR, ch = e % X_CPR;
      const bool ok = r < x_live && col0 + ch * EPC < ldx;
      cp_async16(smem_u32(sX + r * XLD + ch * EPC),
                 ok ? gX + static_cast<long long>(r) * ldx + ch * EPC : X, ok);
    }
    if (++ks_copy == kslices) {
      ks_copy = 0;
      ++t_copy;
    }
    slot_copy = slot_copy + 1 == kMmaStages ? 0 : slot_copy + 1;
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[f][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < n_steps) issue();
    cp_async_commit();
  }
  int slot = 0;
  for (long long st = 0; st < n_steps; ++st) {
    cp_async_wait<kMmaStages - 2>();   // step st has landed (own copies)
    __syncthreads();                   // ... everyone's; step st - 1's slot is free
    if (st + kMmaStages - 1 < n_steps) issue();
    cp_async_commit();
    const T* sA = smem + slot * STAGE;
    mma_stage<NF, ALD, XLD>(sA, sA + A_ELEMS, warp, lane, acc);
    slot = slot + 1 == kMmaStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  OutT* o = out + seg * static_cast<long long>(B) * k;
  // rows of this segment that the output holds (it may end inside the last)
  const int o_live = static_cast<int>(min(static_cast<long long>(B), out_rows - seg * B));
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + warp * 16 + g + 8 * h;
      if (r >= o_live) continue;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = col0 + f * 8 + 2 * t4 + q;
        if (j < k) store(&o[static_cast<long long>(r) * k + j], acc[f][2 * h + q]);
      }
    }
}

// Blocks of kern the card holds at once: SMs x resident blocks per SM.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kern, int threads, int smem, long long* cap) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  *cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return err;
}

template <typename T, typename OutT, int NF>
int launch_mma_nf(const void* tiles, const void* X, const int* seg_ptr, const int* order,
                  const int* cols, void* out, long long n_seg, int B, int k,
                  int ldx, int nb, long long x_rows, long long out_rows,
                  cudaStream_t stream) {
  auto kern = segment_mma_kernel<T, OutT, NF>;
  const int smem = kMmaStages * mma_stage_elems<T, NF>() * static_cast<int>(sizeof(T));
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_col_tiles = (k + 8 * NF - 1) / (8 * NF);
  const int n_row_tiles = (B + kMmaRows - 1) / kMmaRows;
  const long long blocks = n_seg * n_col_tiles * n_row_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (order != nullptr) {
    // The longest rows first only while the grid is at most two waves of
    // resident blocks: there the tail decides the time.  Over many waves
    // row-major order is faster, because neighbouring row blocks share X
    // blocks in L2 (both measured: PERF.md, section 6).
    long long cap = 0;
    if ((err = resident_blocks(kern, kMmaThreads, smem, &cap)) != cudaSuccess)
      return static_cast<int>(err);
    if (blocks > 2 * cap) order = nullptr;
  }
  kern<<<static_cast<unsigned>(blocks), kMmaThreads, smem, stream>>>(
      static_cast<const T*>(tiles), static_cast<const T*>(X), seg_ptr, order, cols,
      static_cast<OutT*>(out), B, k, ldx, nb, x_rows, out_rows, n_row_tiles, n_col_tiles);
  return static_cast<int>(cudaGetLastError());
}

// Column tile of 8 * NF: NF = ceil(k / 8) up to 4 (k = 17 takes 3), else 8.
// X holds x_rows <= nb * B rows and out out_rows <= n_seg * B: what lies past
// them is read as zero and not written.
template <typename T, typename OutT>
int launch_mma(const void* tiles, const void* X, const int* seg_ptr, const int* order,
               const int* cols, void* out, long long n_seg, int B, int k, int ldx,
               int nb, long long x_rows, long long out_rows, cudaStream_t s) {
  if (B < 32 || B % 32 != 0 || k < 1 || ldx < k || ldx % 8 != 0 || nb < 1 || n_seg < 0 ||
      x_rows < 0 || x_rows > static_cast<long long>(nb) * B || out_rows < 0 ||
      out_rows > n_seg * B)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_seg == 0 || out_rows == 0) return static_cast<int>(cudaSuccess);
#define FVGP_LAUNCH_MMA(NF)                                                                  \
  launch_mma_nf<T, OutT, NF>(tiles, X, seg_ptr, order, cols, out, n_seg, B, k, ldx, nb, x_rows, \
                             out_rows, s)
  switch ((k + 7) / 8) {
    case 1: return FVGP_LAUNCH_MMA(1);
    case 2: return FVGP_LAUNCH_MMA(2);
    case 3: return FVGP_LAUNCH_MMA(3);
    case 4: return FVGP_LAUNCH_MMA(4);
    default: return FVGP_LAUNCH_MMA(8);
  }
#undef FVGP_LAUNCH_MMA
}

// ---------------------------------------------------------------------------
// Bfloat16 K2: chunk_sums_wgmma_kernel (TMA + mbarrier ring, wgmma)
// ---------------------------------------------------------------------------

constexpr int kWgStages = 4;
constexpr int kBox = 64 * 128;   // one 64-row box of 64 bfloat16 (128-byte rows)

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = SW128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// D (64 x N, float32, registers) += A (64 x 16, K-major) @ B (16 x N,
// MN-major: imm-trans-b = 1), bfloat16 operands from shared memory.
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 64) wgmma_m64n64(d, da, db);
  else if constexpr (N == 128) wgmma_m64n128(d, da, db);
  else wgmma_m64n256(d, da, db);
}

// Ring stage: the tile slice (64 * WG rows x 64 deep, one box) then N / 64
// X boxes (64 deep x 64 columns each).  Work item w = ((chunk * n_rg) + row
// group) * n_ct + column tile: the column tiles of one chunk are neighbours.
template <int N, int WG>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
chunk_sums_wgmma_kernel(const __grid_constant__ CUtensorMap tm_tiles,
                        const __grid_constant__ CUtensorMap tm_x,
                        const int* __restrict__ cols, float* __restrict__ out,
                        long long n_chunks, int C, int nb, int B, int c, int ldx, int n_rg,
                        int n_ct) {
  constexpr int A_BYTES = WG * kBox;
  constexpr int STAGE = A_BYTES + (N / 64) * kBox;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + kWgStages * STAGE;
  const uint32_t empty = full + 8 * kWgStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * WG);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nks = (B + 63) / 64;
  const long long n_work = n_chunks * n_rg * n_ct;

  if (warp == 4 * WG) {
    // producer warp: lane 0 issues the copies, the warp reads cols
    long long it = 0;
    for (long long w = blockIdx.x; w < n_work; w += gridDim.x) {
      const int ct = static_cast<int>(w % n_ct);
      const int rg = static_cast<int>((w / n_ct) % n_rg);
      const long long chunk = w / n_ct / n_rg;
      const int n0 = ct * N;
      const int boxes = min(N / 64, (ldx - n0 + 63) / 64);
      const uint32_t tx_bytes = A_BYTES + boxes * kBox;
      for (int j0 = 0; j0 < C; j0 += 32) {
        const long long t0 = chunk * C + j0;
        const int cj = j0 + lane < C ? min(cols[t0 + lane], nb - 1) : 0;
        const int jn = min(32, C - j0);
        for (int jj = 0; jj < jn; ++jj) {
          const int col = __shfl_sync(0xffffffffu, cj, jj);
          for (int ks = 0; ks < nks; ++ks, ++it) {
            if (lane == 0) {
              const int s = static_cast<int>(it % kWgStages);
              const uint32_t ph = static_cast<uint32_t>(it / kWgStages) & 1u;
              mbar_wait(empty + 8 * s, ph ^ 1u);
              mbar_expect_tx(full + 8 * s, tx_bytes);
              const uint32_t sa = base + s * STAGE;
              tma_load_3d(sa, &tm_tiles, ks * 64, rg * 64 * WG, static_cast<int>(t0 + jj),
                          full + 8 * s);
              for (int i = 0; i < boxes; ++i)
                tma_load_3d(sa + A_BYTES + i * kBox, &tm_x, n0 + 64 * i, ks * 64, col,
                            full + 8 * s);
            }
            __syncwarp();
          }
        }
      }
    }
  } else {
    // consumer warpgroup wg: rows wg * 64 .. + 63 of the row group
    const int wg = warp / 4;
    float acc[N / 2];
    long long it = 0;
    for (long long w = blockIdx.x; w < n_work; w += gridDim.x) {
      const int ct = static_cast<int>(w % n_ct);
      const int rg = static_cast<int>((w / n_ct) % n_rg);
      const long long chunk = w / n_ct / n_rg;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      const int steps = C * nks;
      for (int st = 0; st < steps; ++st, ++it) {
        const int s = static_cast<int>(it % kWgStages);
        const uint32_t ph = static_cast<uint32_t>(it / kWgStages) & 1u;
        mbar_wait(full + 8 * s, ph);
        const uint32_t sa = base + s * STAGE + wg * kBox;
        const uint32_t sx = base + s * STAGE + A_BYTES;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // A: 16 deep = 32 bytes along the swizzled row, 8-row groups 1024
          // bytes apart.  X: 16 deep = 16 rows of 128 bytes; 8-row groups
          // 1024 bytes apart, 64-column boxes kBox apart.
          wgmma_n<N>(acc, sw128_desc(sa + 32 * kk, 16, 1024),
                     sw128_desc(sx + 2048 * kk, kBox, 1024));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
      // accumulator fragment: d[i] sits at row 16 * warp + lane / 4 + 8 *
      // ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2
      const int n0 = ct * N;
      const int r0 = rg * 64 * WG + wg * 64 + (warp % 4) * 16 + lane / 4;
      float* o = out + chunk * static_cast<long long>(B) * c;
      const bool pairs = c % 2 == 0;
#pragma unroll
      for (int i = 0; i < N / 2; i += 2) {
        const int col = n0 + (i / 4) * 8 + 2 * (lane % 4);
        const int row = r0 + 8 * ((i / 2) % 2);
        if (row < B && col < c) {
          float* p = o + static_cast<long long>(row) * c + col;
          if (pairs) {
            *reinterpret_cast<float2*>(p) = make_float2(acc[i], acc[i + 1]);
          } else {
            p[0] = acc[i];
            if (col + 1 < c) p[1] = acc[i + 1];
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda.so.1, not in the CUDA runtime: it
// is looked up there (the process already holds the library), so the build
// links nothing beyond the runtime.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// 3-D map over a row-major (d2, d1, d0) array of bfloat16 or float32; box
// (1, box1, box0), zeros past the bounds.  Built per call: pointers change.
int encode_3d(CUtensorMap* map, const void* ptr, bool f32, uint64_t d0, uint64_t d1,
              uint64_t d2, uint32_t box0, uint32_t box1, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const uint64_t item = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * item, d0 * d1 * item};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         3, const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int N, int WG>
int launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tx, const int* cols, float* out,
                 long long n_chunks, int C, int nb, int B, int c, int ldx,
                 cudaStream_t stream) {
  auto kern = chunk_sums_wgmma_kernel<N, WG>;
  constexpr int STAGE = WG * kBox + (N / 64) * kBox;
  const int smem = kWgStages * STAGE + 1024 + 16 * kWgStages;
  const int threads = WG * 128 + 32;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long cap = 0;
  if ((err = resident_blocks(kern, threads, smem, &cap)) != cudaSuccess)
    return static_cast<int>(err);
  const int n_rg = (B + 64 * WG - 1) / (64 * WG);
  const int n_ct = (c + N - 1) / N;
  const long long n_work = n_chunks * n_rg * n_ct;
  const long long grid = n_work < cap ? n_work : cap;
  kern<<<static_cast<unsigned>(grid), threads, smem, stream>>>(ta, tx, cols, out, n_chunks, C,
                                                               nb, B, c, ldx, n_rg, n_ct);
  return static_cast<int>(cudaGetLastError());
}

template <int WG>
int launch_wgmma_n(const CUtensorMap& ta, const CUtensorMap& tx, const int* cols, float* out,
                   long long n_chunks, int C, int nb, int B, int c, int ldx, cudaStream_t s) {
  if (c <= 64) return launch_wgmma<64, WG>(ta, tx, cols, out, n_chunks, C, nb, B, c, ldx, s);
  if (c <= 128) return launch_wgmma<128, WG>(ta, tx, cols, out, n_chunks, C, nb, B, c, ldx, s);
  return launch_wgmma<256, WG>(ta, tx, cols, out, n_chunks, C, nb, B, c, ldx, s);
}

int launch_chunk_sums_bf16(const void* tiles, const void* X, const int* cols, float* out,
                           long long n_chunks, int C, int nb, int B, int c, int ldx,
                           cudaStream_t s) {
  const int WG = B > 64 ? 2 : 1;
  CUtensorMap ta, tx;
  int err = encode_3d(&ta, tiles, false, B, B, static_cast<uint64_t>(n_chunks) * C, 64,
                      64 * WG, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0) err = encode_3d(&tx, X, false, ldx, B, nb, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  if (WG == 2) return launch_wgmma_n<2>(ta, tx, cols, out, n_chunks, C, nb, B, c, ldx, s);
  return launch_wgmma_n<1>(ta, tx, cols, out, n_chunks, C, nb, B, c, ldx, s);
}

// ---------------------------------------------------------------------------
// Float32 K2: segment_mma_kernel_wgmma_tf32 (TMA + mbarrier ring, 3xTF32 on wgmma)
// ---------------------------------------------------------------------------

constexpr int kTfStages = 4;      // ring stages
constexpr int kTfDepth = 32;      // contraction depth of a stage: 128 bytes of float32
constexpr int kTfRows = 128;      // output rows of a work item: two consumer warpgroups
constexpr int kTfThreads = 384;   // two consumer warpgroups and the producer's
constexpr int kTfMaxN = 128;      // widest column tile (the partial and the sum in registers)

// Shared memory of the body for a column tile of N: a ring of kTfStages
// (tile slice: up to 128 rows x 32 deep, 128-byte swizzled; X slice: 32 x N
// as stored), two split buffers, each an X slice's hi and lo parts K-major
// (N rows of 128 bytes, 128-byte swizzled, wgmma's B operand), the barriers.
template <int N>
struct TfLayout {
  static constexpr int TILE = kTfRows * kTfDepth * 4;
  static constexpr int X = kTfDepth * N * 4;
  static constexpr int STAGE = TILE + X;
  static constexpr int SPLIT = N * 128;
  static constexpr int BARS = 8 * (2 * kTfStages + 4);
  static constexpr int SMEM = kTfStages * STAGE + 4 * SPLIT + BARS + 1024;
};

// D (64 x N, float32, registers) (+)= A (64 x 8, tf32 registers) @ B (8 x N,
// K-major in shared memory); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_m64n8(float (&d)[4], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      " %0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_m64n16(float (&d)[8], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      " %0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_m64n24(float (&d)[12], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_m64n48(float (&d)[24], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_m64n96(float (&d)[48], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  if constexpr (N == 8) wgmma_tf32_m64n8(d, a, db, scale_d);
  else if constexpr (N == 16) wgmma_tf32_m64n16(d, a, db, scale_d);
  else if constexpr (N == 24) wgmma_tf32_m64n24(d, a, db, scale_d);
  else if constexpr (N == 32) wgmma_tf32_m64n32(d, a, db, scale_d);
  else if constexpr (N == 48) wgmma_tf32_m64n48(d, a, db, scale_d);
  else if constexpr (N == 64) wgmma_tf32_m64n64(d, a, db, scale_d);
  else if constexpr (N == 96) wgmma_tf32_m64n96(d, a, db, scale_d);
  else wgmma_tf32_m64n128(d, a, db, scale_d);
}

// Keeps a register's value where the compiler put it until this point: the
// asynchronous wgmma reads its A fragments and writes its partial after the
// instruction that issued it, which the compiler does not see.
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r) :: "memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r) :: "memory"); }

// Split one stage's X slice (32 deep x N, as copied) into the hi and lo
// buffers, K-major for wgmma.  The A fragments hold, at step kk, the
// contraction indices 8 t + 2 kk (columns t) and 8 t + 2 kk + 1 (columns
// t + 4) of thread t in its quad (t = lane % 4): the sum runs over the same
// products in another order, and each thread reads its 8 values of a tile
// row as two 16-byte loads.  So row n of a split buffer holds X[8 q + r][n]
// at 16-byte chunk r, element q, the chunk swizzled by n % 8.  Warpgroup wg
// splits the rows r = 4 wg .. 4 wg + 3 of every chunk: a warp reads 32
// neighbouring floats and writes 16-byte chunks that fall in distinct banks.
template <int N>
__device__ __forceinline__ void split_x_slice(const float* xs, unsigned char* hi,
                                              unsigned char* lo, int wg, int tid) {
#pragma unroll
  for (int p0 = 0; p0 < 4 * N; p0 += 128) {
    const int p = wg * 4 * N + p0 + tid;
    if (4 * N % 128 != 0 && p >= (wg + 1) * 4 * N) break;
    const int n = p % N, r = p / N;
    uint32_t h[4], l[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(xs[(r + 8 * q) * N + n], h[q], l[q]);
    const int off = n * 128 + ((r ^ (n & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Work item w = ((chunk * n_rg) + row group) * n_ct + column tile: the column
// tiles of one chunk are neighbours, so their tile slices come from L2.  A
// tile whose column block is nb or past it is padding (zero by the caller's
// contract) and is skipped by the producer and the consumers alike.  Warps
// 0-7 are the consumer warpgroups, warp 8 the producer; its warpgroup gives
// its registers to the consumers (setmaxnreg), which hold the sum, the
// stage's partial and two stages' A fragments.
template <int N>
__global__ void __launch_bounds__(kTfThreads, 1)
segment_mma_kernel_wgmma_tf32(const __grid_constant__ CUtensorMap tm_tiles,
                              const __grid_constant__ CUtensorMap tm_x,
                              const int* __restrict__ cols, float* __restrict__ out,
                              long long n_chunks, int C, int nb, int B, int c, int box_rows,
                              int n_rg, int n_ct) {
  using L = TfLayout<N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t split = base + kTfStages * L::STAGE;   // [buffer][hi, lo]
  const uint32_t full = split + 4 * L::SPLIT;
  const uint32_t empty = full + 8 * kTfStages;
  const uint32_t sfull = empty + 8 * kTfStages;        // split buffer written
  const uint32_t sempty = sfull + 16;                   // split buffer read
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTfStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);   // one arrival per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(sfull + 8 * b, 8);
      mbar_init(sempty + 8 * b, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nks = B / kTfDepth;
  const long long n_work = n_chunks * n_rg * n_ct;

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp > 8) return;
    // producer warp: lane 0 issues the copies, the warp reads cols
    const uint32_t tx_bytes = box_rows * kTfDepth * 4 + L::X;
    long long it = 0;
    for (long long w = blockIdx.x; w < n_work; w += gridDim.x) {
      const int ct = static_cast<int>(w % n_ct);
      const int rg = static_cast<int>((w / n_ct) % n_rg);
      const long long chunk = w / n_ct / n_rg;
      for (int j0 = 0; j0 < C; j0 += 32) {
        const long long t0 = chunk * C + j0;
        const int cj = j0 + lane < C ? cols[t0 + lane] : nb;
        const int jn = min(32, C - j0);
        for (int jj = 0; jj < jn; ++jj) {
          const int col = __shfl_sync(0xffffffffu, cj, jj);
          if (col >= nb) continue;
          for (int ks = 0; ks < nks; ++ks, ++it) {
            if (lane == 0) {
              const int s = static_cast<int>(it % kTfStages);
              const uint32_t ph = static_cast<uint32_t>(it / kTfStages) & 1u;
              mbar_wait(empty + 8 * s, ph ^ 1u);
              mbar_expect_tx(full + 8 * s, tx_bytes);
              const uint32_t sa = base + s * L::STAGE;
              tma_load_3d(sa, &tm_tiles, ks * kTfDepth, rg * kTfRows, static_cast<int>(t0 + jj),
                          full + 8 * s);
              tma_load_3d(sa + L::TILE, &tm_x, ct * N, ks * kTfDepth, col, full + 8 * s);
            }
            __syncwarp();
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // consumer warpgroup wg: rows wg * 64 .. + 63 of the item's 128; this
  // thread's A rows r0 and r0 + 8
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int q4 = lane % 4;
  float acc[N / 2], part[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) part[i] = 0.f;
  uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];

  // stage g's X slice split into split buffer g % 2, and its tile slice's
  // A fragments into (ah, al): rows r0 and r0 + 8, contraction indices
  // 8 q4 .. 8 q4 + 7 (two 16-byte chunks of the 128-byte swizzled row);
  // then the ring slot is free
  auto load_stage = [&](long long g, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
    const int s = static_cast<int>(g % kTfStages), b = static_cast<int>(g & 1);
    mbar_wait(full + 8 * s, static_cast<uint32_t>(g / kTfStages) & 1u);
    // the buffer's last readers (stage g - 2's products) are done
    mbar_wait(sempty + 8 * b, (static_cast<uint32_t>(g >> 1) & 1u) ^ 1u);
    const unsigned char* slot = gbase + s * L::STAGE;
    unsigned char* hi = gbase + (split - base) + 2 * b * L::SPLIT;
    split_x_slice<N>(reinterpret_cast<const float*>(slot + L::TILE), hi, hi + L::SPLIT, wg,
                     tid);
    // generic-proxy stores, read next by wgmma through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    float v[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 f = *reinterpret_cast<const float4*>(
            slot + row * 128 + (((2 * q4 + e) ^ (row & 7)) << 4));
        v[h][4 * e] = f.x;
        v[h][4 * e + 1] = f.y;
        v[h][4 * e + 2] = f.z;
        v[h][4 * e + 3] = f.w;
      }
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(sfull + 8 * b);
      mbar_arrive(empty + 8 * s);   // this warp is done with the slot
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split_tf32(v[0][2 * kk], ah[kk][0], al[kk][0]);
      split_tf32(v[1][2 * kk], ah[kk][1], al[kk][1]);
      split_tf32(v[0][2 * kk + 1], ah[kk][2], al[kk][2]);
      split_tf32(v[1][2 * kk + 1], ah[kk][3], al[kk][3]);
    }
  };

  // stage g's products on (ah, al) and the split buffer; stage g + 1's
  // loads (into (nh, nl)) while the tensor cores work
  auto run_stage = [&](long long g, bool more, uint32_t (&ah)[4][4], uint32_t (&al)[4][4],
                       uint32_t (&nh)[4][4], uint32_t (&nl)[4][4]) {
    const int b = static_cast<int>(g & 1);
    mbar_wait(sfull + 8 * b, static_cast<uint32_t>(g >> 1) & 1u);
    const uint32_t bh = split + 2 * b * L::SPLIT;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // a fresh partial each stage (scale-d 0 on its first product): the
    // stage's lo.hi and hi.lo products first, then its hi.hi products.  The
    // tensor cores truncate each sum into the partial to its float32 ulp,
    // so the eight small products cost ulps of a small partial and only
    // the four large ones ulps of the stage's whole
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32<N>(part, al[kk], sw128_desc(bh + 32 * kk, 16, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32<N>(part, ah[kk], sw128_desc(bh + L::SPLIT + 32 * kk, 16, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32<N>(part, ah[kk], sw128_desc(bh + 32 * kk, 16, 1024), 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (more) load_stage(g + 1, nh, nl);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        reg_fence(ah[kk][i]);
        reg_fence(al[kk][i]);
      }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) reg_fence(part[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(sempty + 8 * b);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
  };

  long long it = 0;
  for (long long w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int ct = static_cast<int>(w % n_ct);
    const int rg = static_cast<int>((w / n_ct) % n_rg);
    const long long chunk = w / n_ct / n_rg;
    // the producer's sequence: the chunk's live tiles, nks slices each
    int n_live = 0;
    for (int j0 = 0; j0 < C; j0 += 32) {
      const bool live = j0 + lane < C && cols[chunk * C + j0 + lane] < nb;
      n_live += __popc(__ballot_sync(0xffffffffu, live));
    }
    const int steps = n_live * nks;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    if (steps > 0) load_stage(it, ah0, al0);
    // two stages a trip, so the A fragments alternate without moves
    for (int st = 0; st < steps; st += 2) {
      run_stage(it, st + 1 < steps, ah0, al0, ah1, al1);
      ++it;
      if (st + 1 < steps) {
        run_stage(it, st + 2 < steps, ah1, al1, ah0, al0);
        ++it;
      }
    }
    // accumulator fragment: acc[i] sits at row 16 * (warp % 4) + lane / 4 + 8 *
    // ((i / 2) % 2) of the warpgroup's 64, column 8 * (i / 4) + 2 * (lane % 4) + i % 2
    float* o = out + chunk * static_cast<long long>(B) * c;
    const bool pairs = c % 2 == 0;
#pragma unroll
    for (int i = 0; i < N / 2; i += 2) {
      const int col = ct * N + (i / 4) * 8 + 2 * q4;
      const int row = rg * kTfRows + r0 + 8 * ((i / 2) % 2);
      if (row < B && col < c) {
        float* p = o + static_cast<long long>(row) * c + col;
        if (pairs) {
          *reinterpret_cast<float2*>(p) = make_float2(acc[i], acc[i + 1]);
        } else {
          p[0] = acc[i];
          if (col + 1 < c) p[1] = acc[i + 1];
        }
      }
    }
  }
}

template <int N>
int launch_tf32(const CUtensorMap& ta, const void* X, const int* cols, float* out,
                long long n_chunks, int C, int nb, int B, int c, int ldx, int box_rows,
                int n_ct, cudaStream_t stream) {
  CUtensorMap tx;
  int e = encode_3d(&tx, X, true, ldx, B, nb, N, kTfDepth, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  auto kern = segment_mma_kernel_wgmma_tf32<N>;
  const int smem = TfLayout<N>::SMEM;
  const int threads = kTfThreads;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long cap = 0;
  if ((err = resident_blocks(kern, threads, smem, &cap)) != cudaSuccess)
    return static_cast<int>(err);
  const int n_rg = (B + kTfRows - 1) / kTfRows;
  const long long n_work = n_chunks * n_rg * n_ct;
  const long long grid = n_work < cap ? n_work : cap;
  kern<<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      ta, tx, cols, out, n_chunks, C, nb, B, c, box_rows, n_rg, n_ct);
  return static_cast<int>(cudaGetLastError());
}

// The fewest column tiles of at most 128 that cover c, each of the narrowest
// instantiated width that holds its share.
int launch_chunk_sums_tf32(const void* tiles, const void* X, const int* cols, float* out,
                           long long n_chunks, int C, int nb, int B, int c, int ldx,
                           cudaStream_t s) {
  const int n_ct = (c + kTfMaxN - 1) / kTfMaxN;
  const int w = (c + n_ct - 1) / n_ct;
  const int box_rows = B < kTfRows ? B : kTfRows;
  CUtensorMap ta;
  const int err = encode_3d(&ta, tiles, true, B, B, static_cast<uint64_t>(n_chunks) * C,
                            kTfDepth, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
#define FVGP_TF32(NN)                                                                 \
  if (w <= NN)                                                                        \
    return launch_tf32<NN>(ta, X, cols, out, n_chunks, C, nb, B, c, ldx, box_rows, n_ct, s);
  FVGP_TF32(8)
  FVGP_TF32(16)
  FVGP_TF32(24)
  FVGP_TF32(32)
  FVGP_TF32(48)
  FVGP_TF32(64)
  FVGP_TF32(96)
  FVGP_TF32(128)
#undef FVGP_TF32
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// K3: dense covariance
// ---------------------------------------------------------------------------

constexpr int kCovThreads = 256;   // 8 warps
constexpr int kCovPassRows = 32;   // rows of one pass over the tile: 4 per warp
constexpr int kCovMaxD = 32;

// Float32 takes the hardware's approximate reciprocal square root and
// exponential (v > 0 is the caller's guard): the precise sqrtf and expf are
// ~8 instructions each, which kept the float32 body bound by its
// instruction count, not by its stores (10^4 x 10^4 Matern: 0.170 ms
// precise, 0.128 ms so).  Against the plain version the result moves from 1.8e-7 to 3.0e-7 of
// the variance, against float64 from 3.7e-7 to 4.0e-7: float32's own
// rounding either way.  Float64 stays on sqrt and exp.
__device__ __forceinline__ float dev_sqrt(float v) { return v * rsqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float dev_exp(float v) { return __expf(v); }
__device__ __forceinline__ double dev_exp(double v) { return exp(v); }
__device__ __forceinline__ float dev_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double dev_fma(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// 16 bytes of T: 4 floats or 2 doubles.  hint: the streaming (evict-first)
// store, for an output that nothing reads back through L2.
__device__ __forceinline__ void store16(float* p, const float (&v)[4], bool hint) {
  const float4 q = make_float4(v[0], v[1], v[2], v[3]);
  if (hint) __stcs(reinterpret_cast<float4*>(p), q);
  else *reinterpret_cast<float4*>(p) = q;
}
__device__ __forceinline__ void store16(double* p, const double (&v)[2], bool hint) {
  const double2 q = make_double2(v[0], v[1]);
  if (hint) __stcs(reinterpret_cast<double2*>(p), q);
  else *reinterpret_cast<double2*>(p) = q;
}
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load16(const double* p, double (&v)[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x; v[1] = q.y;
}

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

// The staging buffer of the mirrored write holds one pass (32 rows x TC
// columns) in 16-byte chunks, chunk c of row r at chunk c ^ ((r / V) & 7):
// both the row-wise writes and the V x V block reads of the transposition
// then spread over all banks.
template <int V>
__device__ __forceinline__ int cov_stage_at(int r, int c, int tc) {
  return r * tc + V * ((c / V) ^ ((r / V) & 7)) + c % V;
}

// One square output tile of TC = 32 * V columns and as many rows per block
// (V = 4 float32 or 2 float64 values in 16 bytes: 128 x 128 or 64 x 64).
// DT > 0: D == DT at compile time and the thread's columns live in
// registers; DT == 0: D <= 32 at run time, columns re-read from shared
// memory.  VST: one 16-byte store per thread and row (the caller guarantees
// n2 % V == 0), the thread owning V neighbouring columns; otherwise scalar
// stores, the thread owning columns lane, lane + 32, ..., so that a warp's
// store is one contiguous run either way.  sym: x2 is x1; the block index
// walks the tiles on and above the diagonal, and a tile above it is written
// a second time, transposed, below it.
template <typename T, int KIND, int DT, bool VST>
__global__ void __launch_bounds__(kCovThreads)
dense_cov_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                 const T* __restrict__ hps, T* __restrict__ out, int n1, int n2, int d_rt,
                 int n_ct, int sym, int hint) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int TC = 32 * V;
  constexpr int TR = TC;
  constexpr int NP = TR / kCovPassRows;
  const int D = DT > 0 ? DT : d_rt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* z1s = reinterpret_cast<T*>(smem_raw);   // [TR][D] whitened rows
  T* z2s = z1s + TR * D;                     // [D][TC] whitened columns
  T* stg = z2s + D * TC;                     // [32][TC], sym only
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  int ti, tj;
  if (sym) {
    // tile row ti holds the n_ct - ti tiles tj >= ti and starts at index
    // ti * n_ct - ti (ti - 1) / 2
    const long long p = blockIdx.x, nt = n_ct;
    const double b = 2.0 * nt + 1.0;
    long long t = static_cast<long long>((b - sqrt(b * b - 8.0 * p)) * 0.5);
    t = t < 0 ? 0 : (t > nt - 1 ? nt - 1 : t);
    while (t > 0 && t * nt - t * (t - 1) / 2 > p) --t;
    while ((t + 1) * nt - (t + 1) * t / 2 <= p) ++t;
    ti = static_cast<int>(t);
    tj = ti + static_cast<int>(p - (t * nt - t * (t - 1) / 2));
  } else {
    ti = blockIdx.x / n_ct;
    tj = blockIdx.x % n_ct;
  }
  const long long row0 = static_cast<long long>(ti) * TR;
  const long long col0 = static_cast<long long>(tj) * TC;

  // whiten while loading: one IEEE division per coordinate, x / l, never a
  // product with 1 / l, so the values are those of the plain version
  const long long lim1 = (n1 - row0) * D;
  for (int e = tid; e < TR * D; e += kCovThreads) {
    const int d = e % D;
    z1s[e] = e < lim1 ? x1[row0 * D + e] / hps[1 + d] : static_cast<T>(0);
  }
  const long long lim2 = (n2 - col0) * D;
  for (int e = tid; e < TC * D; e += kCovThreads) {
    const int j = e / D, d = e - j * D;
    z2s[d * TC + j] = e < lim2 ? x2[col0 * D + e] / hps[1 + d] : static_cast<T>(0);
  }
  __syncthreads();

  int cj[V];
#pragma unroll
  for (int q = 0; q < V; ++q) cj[q] = VST ? V * lane + q : lane + 32 * q;
  T zc[V][DT > 0 ? DT : 1];
  if constexpr (DT > 0) {
#pragma unroll
    for (int q = 0; q < V; ++q)
#pragma unroll
      for (int d = 0; d < DT; ++d) zc[q][d] = z2s[d * TC + cj[q]];
  }
  const T var = hps[0];
  const bool mirror = sym && ti != tj;
  const bool stream = hint != 0;

  for (int ps = 0; ps < NP; ++ps) {
#pragma unroll
    for (int i = 0; i < kCovPassRows / 8; ++i) {
      const int rl = warp * (kCovPassRows / 8) + i;   // row of the pass
      const int r = ps * kCovPassRows + rl;           // row of the tile
      T d2[V];
#pragma unroll
      for (int q = 0; q < V; ++q) d2[q] = static_cast<T>(0);
      if constexpr (DT > 0) {
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          const T a = z1s[r * DT + d];
#pragma unroll
          for (int q = 0; q < V; ++q) {
            const T diff = a - zc[q][d];
            d2[q] = dev_fma(diff, diff, d2[q]);
          }
        }
      } else {
        for (int d = 0; d < D; ++d) {
          const T a = z1s[r * D + d];
#pragma unroll
          for (int q = 0; q < V; ++q) {
            const T diff = a - z2s[d * TC + cj[q]];
            d2[q] = dev_fma(diff, diff, d2[q]);
          }
        }
      }
      T v[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const T dist = d2[q] > static_cast<T>(0) ? dev_sqrt(d2[q]) : static_cast<T>(0);
        v[q] = var * cov_poly<T, KIND>(dist);
      }
      const long long row = row0 + r;
      if (row < n1) {
        T* o = out + row * n2 + col0;   // the row's offset once, in 64 bits
        if (VST) {
          if (col0 + cj[0] < n2) store16(o + cj[0], v, stream);
        } else {
#pragma unroll
          for (int q = 0; q < V; ++q)
            if (col0 + cj[q] < n2) o[cj[q]] = v[q];
        }
      }
      if (mirror) {
        if (VST) {
          store16(stg + cov_stage_at<V>(rl, cj[0], TC), v, false);
        } else {
#pragma unroll
          for (int q = 0; q < V; ++q) stg[cov_stage_at<V>(rl, cj[q], TC)] = v[q];
        }
      }
    }
    if (mirror) {   // the same for the whole block
      __syncthreads();
      // V x V blocks of the pass, transposed in registers: output row
      // col0 + c gets the V values of rows V * rq ... of this pass
      constexpr int RQ = kCovPassRows / V;
      for (int blk = tid; blk < RQ * 32; blk += kCovThreads) {
        const int rq = blk % RQ, cc = blk / RQ;
        T m[V][V];
#pragma unroll
        for (int q = 0; q < V; ++q)
          load16(stg + cov_stage_at<V>(V * rq + q, V * cc, TC), m[q]);
        const long long c_out = row0 + ps * kCovPassRows + V * rq;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const long long r_out = col0 + V * cc + j;
          if (r_out >= n1) continue;
          T w[V];
#pragma unroll
          for (int q = 0; q < V; ++q) w[q] = m[q][j];
          T* o = out + r_out * n2 + c_out;
          if (VST) {
            if (c_out < n2) store16(o, w, stream);
          } else {
#pragma unroll
            for (int q = 0; q < V; ++q)
              if (c_out + q < n2) o[q] = w[q];
          }
        }
      }
      __syncthreads();
    }
  }
}

template <typename T, int KIND, int DT, bool VST>
int launch_cov_one(const T* x1, const T* x2, const T* hps, T* out, int n1, int n2, int D,
                   bool sym, bool hint, cudaStream_t stream) {
  constexpr int TC = 32 * (16 / static_cast<int>(sizeof(T)));
  const long long n_ct = (static_cast<long long>(n2) + TC - 1) / TC;
  const long long n_rt = (static_cast<long long>(n1) + TC - 1) / TC;
  const long long blocks = sym ? n_ct * (n_ct + 1) / 2 : n_rt * n_ct;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int smem = (2 * TC * D + (sym ? kCovPassRows * TC : 0)) * static_cast<int>(sizeof(T));
  dense_cov_kernel<T, KIND, DT, VST>
      <<<static_cast<unsigned>(blocks), kCovThreads, smem, stream>>>(
          x1, x2, hps, out, n1, n2, D, static_cast<int>(n_ct), sym ? 1 : 0, hint ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KIND, bool VST>
int launch_cov_d(const T* x1, const T* x2, const T* hps, T* out, int n1, int n2, int D,
                 bool sym, bool hint, cudaStream_t s) {
#define FVGP_LAUNCH_COV(DT) \
  launch_cov_one<T, KIND, DT, VST>(x1, x2, hps, out, n1, n2, D, sym, hint, s)
  switch (D) {
    case 1: return FVGP_LAUNCH_COV(1);
    case 2: return FVGP_LAUNCH_COV(2);
    case 3: return FVGP_LAUNCH_COV(3);
    case 4: return FVGP_LAUNCH_COV(4);
    default: return FVGP_LAUNCH_COV(0);
  }
#undef FVGP_LAUNCH_COV
}

// flags: 1 = x2 is x1 (the symmetric route), 2 = 16-byte stores (n2 must be
// a multiple of 16 / sizeof(T)), 4 = the streaming store hint.
template <typename T>
int launch_cov(const void* x1, const void* x2, const void* hps, void* out, int n1, int n2,
               int D, int kind, int flags, cudaStream_t s) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const bool sym = flags & 1, vst = flags & 2, hint = flags & 4;
  if (n1 < 0 || n2 < 0 || D < 1 || D > kCovMaxD || (kind != 0 && kind != 1) ||
      (sym && (n1 != n2 || x1 != x2)) ||
      (vst && (n2 % V != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n1 == 0 || n2 == 0) return static_cast<int>(cudaSuccess);
  const T* a = static_cast<const T*>(x1);
  const T* b = static_cast<const T*>(x2);
  const T* h = static_cast<const T*>(hps);
  T* o = static_cast<T*>(out);
  if (kind == 0) {
    if (vst) return launch_cov_d<T, 0, true>(a, b, h, o, n1, n2, D, sym, hint, s);
    return launch_cov_d<T, 0, false>(a, b, h, o, n1, n2, D, sym, hint, s);
  }
  if (vst) return launch_cov_d<T, 1, true>(a, b, h, o, n1, n2, D, sym, hint, s);
  return launch_cov_d<T, 1, false>(a, b, h, o, n1, n2, D, sym, hint, s);
}

// ---------------------------------------------------------------------------
// K5: gp2Scale tile assembly and its hyperparameter VJP
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 256;   // 8 warps

// 16 bytes of tile values: 4 float32 or 8 bfloat16, converted from and to
// float32 (round to nearest even, as torch's cast), streamed past L2.
__device__ __forceinline__ void store_tile16(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_tile16(bf16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
}
__device__ __forceinline__ void load_tile16(const float* p, float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_tile16(const bf16* p, float (&v)[8]) {
  const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// The block's tile: its row and column point blocks whitened into shared
// memory (one IEEE division per coordinate, x / l, as the plain formula and
// K3 do), rows [B][D], columns [D][B], and both masks.  n_ls lengthscales:
// D, or 1 broadcast over every dimension.
__device__ __forceinline__ void tile_cov_load(const float* __restrict__ xb,
                                              const float* __restrict__ mask,
                                              const float* __restrict__ hps, int r, int c,
                                              int B, int D, int n_ls, float* z1s, float* z2s,
                                              float* m1s, float* m2s) {
  const float* x1 = xb + static_cast<long long>(r) * B * D;
  const float* x2 = xb + static_cast<long long>(c) * B * D;
  for (int e = threadIdx.x; e < B * D; e += kTileThreads) {
    const int j = e / D, d = e - j * D;
    const float l = hps[1 + (n_ls == 1 ? 0 : d)];
    z1s[e] = x1[e] / l;
    z2s[d * B + j] = x2[e] / l;
  }
  for (int i = threadIdx.x; i < B; i += kTileThreads) {
    m1s[i] = mask[static_cast<long long>(r) * B + i];
    m2s[i] = mask[static_cast<long long>(c) * B + i];
  }
}

// The walk over a B x B tile: the thread takes groups of V neighbouring
// columns, group g = row * G + cg (G = B / V groups a row) for g = tid,
// tid + 256, ...; the row and column group advance without a division.
// Where G divides 256 a thread keeps one column group for the whole tile.
struct TileWalk {
  int row, cg, step_r, step_c, G;
  __device__ __forceinline__ TileWalk(int G_) : G(G_) {
    row = threadIdx.x / G;
    cg = threadIdx.x - row * G;
    step_r = kTileThreads / G;
    step_c = kTileThreads - step_r * G;
  }
  __device__ __forceinline__ void next() {
    row += step_r;
    cg += step_c;
    if (cg >= G) { cg -= G; ++row; }
  }
};

// K5 forward: tiles[t] = live[t] * mask[r] (x) mask[c] * var * P(min(d, 1)),
// d = |x_r / l - x_c / l| (K3's Wendland arithmetic: exact per-dimension
// differences, fma sums, the approximate rsqrt), for every tile t in one
// launch, one block per tile.  A write-only stream: T * B * B values
// against 2 * B * (D + 1) inputs a tile, so the tile write bounds it; each
// thread writes one 16-byte streaming store per group.  A dead tile (live
// false: bucket padding) is written as zeros.  DT > 0: D == DT at compile
// time, the thread's column coordinates in registers; DT == 0: D <= 32 at
// run time, read from shared memory.
template <typename OutT, int DT>
__global__ void __launch_bounds__(kTileThreads)
tile_cov_kernel(const float* __restrict__ xb, const float* __restrict__ mask,
                const int* __restrict__ rows, const int* __restrict__ cols,
                const unsigned char* __restrict__ live, const float* __restrict__ hps,
                OutT* __restrict__ out, int nb, int B, int d_rt, int n_ls) {
  constexpr int V = 16 / static_cast<int>(sizeof(OutT));
  const int D = DT > 0 ? DT : d_rt;
  const int G = B / V;
  const long long t = blockIdx.x;
  OutT* o = out + t * B * B;
  if (!live[t]) {
    float zero[V];
#pragma unroll
    for (int q = 0; q < V; ++q) zero[q] = 0.0f;
    for (int g = threadIdx.x; g < B * G; g += kTileThreads) store_tile16(o + g * V, zero);
    return;
  }
  extern __shared__ __align__(16) float tile_smem[];
  float* z1s = tile_smem;
  float* z2s = z1s + B * D;
  float* m1s = z2s + B * D;
  float* m2s = m1s + B;
  const int r = min(max(rows[t], 0), nb - 1), c = min(max(cols[t], 0), nb - 1);
  tile_cov_load(xb, mask, hps, r, c, B, D, n_ls, z1s, z2s, m1s, m2s);
  __syncthreads();

  const float var = hps[0];
  TileWalk w(G);
  int cg_held = -1;
  float zc[V][DT > 0 ? DT : 1];
  float mc[V];
  for (; w.row < B; w.next()) {
    const int col0 = w.cg * V;
    if (w.cg != cg_held) {
      cg_held = w.cg;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        mc[q] = m2s[col0 + q];
        if constexpr (DT > 0) {
#pragma unroll
          for (int d = 0; d < DT; ++d) zc[q][d] = z2s[d * B + col0 + q];
        }
      }
    }
    float d2[V];
#pragma unroll
    for (int q = 0; q < V; ++q) d2[q] = 0.0f;
    if constexpr (DT > 0) {
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const float a = z1s[w.row * DT + d];
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float diff = a - zc[q][d];
          d2[q] = dev_fma(diff, diff, d2[q]);
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const float a = z1s[w.row * D + d];
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float diff = a - z2s[d * B + col0 + q];
          d2[q] = dev_fma(diff, diff, d2[q]);
        }
      }
    }
    const float mr = m1s[w.row];
    float v[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const float dist = d2[q] > 0.0f ? dev_sqrt(d2[q]) : 0.0f;
      v[q] = (var * cov_poly<float, 1>(dist)) * (mr * mc[q]);
    }
    store_tile16(o + static_cast<long long>(w.row) * B + col0, v);
  }
}

// K5 VJP: the 1 + D partial sums of tile t against its cotangent tbar[t],
//   partial[t, 0]     = sum_ij w_ij P(d_ij)
//   partial[t, 1 + k] = sum_ij w_ij Q(d_ij) dz_ijk^2
// with w = tbar * live * mask[r] (x) mask[c], dz = x_r / l - x_c / l,
// P(d) = (1 - d)^8 (32 d^3 + 25 d^2 + 8 d + 1) and Q(d) = 22 (1 - d)^7
// (16 d^2 + 7 d + 1) on d clipped at 1 (so Q = 0 past the support).  The
// wrapper turns them into dK/dvar = P and dK/dl_k = var Q dz_k^2 / l_k (the
// 1 / d of the chain rule cancels, so d = 0 needs no case).  A read-only
// stream of the cotangent with 16-byte loads, bound by those bytes; the
// sums stay in registers, then warp shuffles and shared memory reduce them
// in a fixed order: deterministic, no atomics.  A dead tile's partial is
// zero and its cotangent is not read.
template <typename InT, int DT>
__global__ void __launch_bounds__(kTileThreads)
tile_cov_vjp_kernel(const float* __restrict__ xb, const float* __restrict__ mask,
                    const int* __restrict__ rows, const int* __restrict__ cols,
                    const unsigned char* __restrict__ live, const float* __restrict__ hps,
                    const InT* __restrict__ tbar, float* __restrict__ partial, int nb, int B,
                    int d_rt, int n_ls) {
  constexpr int V = 16 / static_cast<int>(sizeof(InT));
  constexpr int NS = 1 + (DT > 0 ? DT : kCovMaxD);
  const int D = DT > 0 ? DT : d_rt;
  const int G = B / V;
  const long long t = blockIdx.x;
  const int tid = threadIdx.x;
  float* pt = partial + t * (1 + D);
  if (!live[t]) {
    for (int k = tid; k < 1 + D; k += kTileThreads) pt[k] = 0.0f;
    return;
  }
  extern __shared__ __align__(16) float tile_smem[];
  float* z1s = tile_smem;
  float* z2s = z1s + B * D;
  float* m1s = z2s + B * D;
  float* m2s = m1s + B;
  float* red = m2s + B;   // [8 warps][1 + D]
  const int r = min(max(rows[t], 0), nb - 1), c = min(max(cols[t], 0), nb - 1);
  tile_cov_load(xb, mask, hps, r, c, B, D, n_ls, z1s, z2s, m1s, m2s);
  __syncthreads();

  const InT* tb_t = tbar + t * B * B;
  float s[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) s[k] = 0.0f;
  TileWalk w(G);
  int cg_held = -1;
  float zc[V][DT > 0 ? DT : 1];
  float mc[V];
  for (; w.row < B; w.next()) {
    const int col0 = w.cg * V;
    if (w.cg != cg_held) {
      cg_held = w.cg;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        mc[q] = m2s[col0 + q];
        if constexpr (DT > 0) {
#pragma unroll
          for (int d = 0; d < DT; ++d) zc[q][d] = z2s[d * B + col0 + q];
        }
      }
    }
    float tb[V];
    load_tile16(tb_t + static_cast<long long>(w.row) * B + col0, tb);
    const float mr = m1s[w.row];
    float dz[V][DT > 0 ? DT : 1];
    float d2[V];
#pragma unroll
    for (int q = 0; q < V; ++q) d2[q] = 0.0f;
    if constexpr (DT > 0) {
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const float a = z1s[w.row * DT + d];
#pragma unroll
        for (int q = 0; q < V; ++q) {
          dz[q][d] = a - zc[q][d];
          d2[q] = dev_fma(dz[q][d], dz[q][d], d2[q]);
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const float a = z1s[w.row * D + d];
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float diff = a - z2s[d * B + col0 + q];
          d2[q] = dev_fma(diff, diff, d2[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const float wt = tb[q] * (mr * mc[q]);
      const float dist = d2[q] > 0.0f ? dev_sqrt(d2[q]) : 0.0f;
      const float dd = dist < 1.0f ? dist : 1.0f;
      const float u = 1.0f - dd;
      const float u2 = u * u;
      const float u7 = (u2 * u2) * u2 * u;
      const float p = (u7 * u) * dev_fma(dev_fma(dev_fma(32.0f, dd, 25.0f), dd, 8.0f), dd, 1.0f);
      const float wq = wt * (u7 * dev_fma(dev_fma(352.0f, dd, 154.0f), dd, 22.0f));
      s[0] = dev_fma(wt, p, s[0]);
      if constexpr (DT > 0) {
#pragma unroll
        for (int d = 0; d < DT; ++d) s[1 + d] = dev_fma(wq, dz[q][d] * dz[q][d], s[1 + d]);
      } else {
        for (int d = 0; d < D; ++d) {
          const float diff = z1s[w.row * D + d] - z2s[d * B + col0 + q];
          s[1 + d] = dev_fma(wq, diff * diff, s[1 + d]);
        }
      }
    }
  }
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    if (k > D) break;
    float v = s[k];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp * (1 + D) + k] = v;
  }
  __syncthreads();
  for (int k = tid; k < 1 + D; k += kTileThreads) {
    float v = 0.0f;
    for (int wi = 0; wi < kTileThreads / 32; ++wi) v += red[wi * (1 + D) + k];
    pt[k] = v;
  }
}

// Shared memory of a K5 block: the whitened points and masks (and, for the
// VJP, the warps' partial sums).
inline long long tile_cov_smem(int B, int D, bool vjp) {
  return (2LL * B * D + 2LL * B + (vjp ? (kTileThreads / 32) * (1 + D) : 0)) * 4;
}

constexpr long long kTileMaxSmem = 232448;   // a block's most, opted in

template <typename E, int DT>
int launch_tile_cov_one(const float* xb, const float* mask, const int* rows, const int* cols,
                        const unsigned char* live, const float* hps, const void* tbar,
                        void* out, long long n_tiles, int nb, int B, int D, int n_ls, bool vjp,
                        cudaStream_t s) {
  const int smem = static_cast<int>(tile_cov_smem(B, D, vjp));
  const bool opt_in = smem > 48 * 1024;   // above 48 KB only when asked for
  cudaError_t err = cudaSuccess;
  if (vjp) {
    if (opt_in)
      err = cudaFuncSetAttribute(tile_cov_vjp_kernel<E, DT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_cov_vjp_kernel<E, DT><<<static_cast<unsigned>(n_tiles), kTileThreads, smem, s>>>(
        xb, mask, rows, cols, live, hps, static_cast<const E*>(tbar),
        static_cast<float*>(out), nb, B, D, n_ls);
  } else {
    if (opt_in)
      err = cudaFuncSetAttribute(tile_cov_kernel<E, DT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_cov_kernel<E, DT><<<static_cast<unsigned>(n_tiles), kTileThreads, smem, s>>>(
        xb, mask, rows, cols, live, hps, static_cast<E*>(out), nb, B, D, n_ls);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_tile_cov(const float* xb, const float* mask, const int* rows, const int* cols,
                    const unsigned char* live, const float* hps, const void* tbar, void* out,
                    long long n_tiles, int nb, int B, int D, int n_ls, bool vjp, cudaStream_t s) {
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  if (n_tiles < 0 || nb < 1 || B < V || B % 8 != 0 || D < 1 || D > kCovMaxD ||
      (n_ls != 1 && n_ls != D) || n_tiles > 0x7fffffffLL || tile_cov_smem(B, D, vjp) > kTileMaxSmem ||
      reinterpret_cast<uintptr_t>(vjp ? tbar : out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  // D = 3 (the gp2Scale configuration measured) in registers; every other
  // D in the run-time body
  if (D == 3)
    return launch_tile_cov_one<E, 3>(xb, mask, rows, cols, live, hps, tbar, out, n_tiles, nb, B, D,
                                     n_ls, vjp, s);
  return launch_tile_cov_one<E, 0>(xb, mask, rows, cols, live, hps, tbar, out, n_tiles, nb, B, D,
                                   n_ls, vjp, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (tiles and X alike).  X has nb blocks
// of B rows and ldx columns (a multiple of 8, >= k), of which the first k
// are live; out has nb_out row blocks.  nb_out == nb is the square product;
// a mesh rank multiplies its own nb_out row blocks against the gathered X
// of nb blocks (all-gather: every block; halo: its own blocks and the
// received ones).  row_ptr (nb_out + 1,) are the CSR row offsets, order
// (nb_out,) the row blocks by descending tile count, the launch order for a
// grid of at most two waves.  Each function returns the CUDA error code of
// its launch (0 on success).
extern "C" int fvgp_chunked_spmm(const void* tiles, const void* X, const int* row_ptr,
                                 const int* order, const int* cols, float* out, int nb,
                                 int nb_out, int B, int k, int ldx, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb_out < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(nb) * B;
  const long long n_out = static_cast<long long>(nb_out) * B;
  if (dtype == 0)
    return launch_mma<float, float>(tiles, X, row_ptr, order, cols, out, nb_out, B, k, ldx,
                                    nb, n, n_out, s);
  if (dtype == 1)
    return launch_mma<bf16, float>(tiles, X, row_ptr, order, cols, out, nb_out, B, k, ldx,
                                   nb, n, n_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2: X is (nb, B, ldx), out (n_chunks, B, c) float32.  The dtype picks the
// wgmma body: float32 segment_mma_kernel_wgmma_tf32, bfloat16
// chunk_sums_wgmma_kernel.  Padding tiles (cols >= nb) must be zero: the
// float32 body skips them, the bfloat16 body multiplies them by X's last block.
extern "C" int fvgp_row_chunk_sums(const void* tiles, const void* X, const int* cols,
                                   float* out, long long n_chunks, int C, int nb, int B,
                                   int c, int ldx, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || B < 32 || B % 32 != 0 || c < 1 || ldx < c || ldx % 8 != 0 || nb < 1 ||
      n_chunks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return static_cast<int>(cudaSuccess);
  if (dtype == 0)
    return launch_chunk_sums_tf32(tiles, X, cols, out, n_chunks, C, nb, B, c, ldx, s);
  if (dtype == 1)
    return launch_chunk_sums_bf16(tiles, X, cols, out, n_chunks, C, nb, B, c, ldx, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4: X (x_rows, ldx) and out (out_rows, k) in X's type (dtype 0 = float32,
// 1 = bfloat16), both at most nb * B rows: the rows of X's last block past
// x_rows are read as zero, the rows of the product past out_rows are not
// written.  rows of the tile list >= nb lie past row_ptr[nb] and are skipped.
extern "C" int fvgp_block_spmv(const void* tiles, const void* X, const int* row_ptr,
                               const int* order, const int* cols, void* out, int nb, int B,
                               int k, int ldx, long long x_rows, long long out_rows,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_mma<float, float>(tiles, X, row_ptr, order, cols, out, nb, B, k, ldx,
                                    nb, x_rows, out_rows, s);
  if (dtype == 1)
    return launch_mma<bf16, bf16>(tiles, X, row_ptr, order, cols, out, nb, B, k, ldx, nb,
                                  x_rows, out_rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3: x1 (n1, D), x2 (n2, D), hps (>= 1 + D: the signal variance, then the D
// lengthscales), out (n1, n2); all of one type, dtype 0 = float32, 2 =
// float64; kind 0 = Matern-3/2, 1 = Wendland; flags as for launch_cov.
extern "C" int fvgp_dense_covariance(const void* x1, const void* x2, const void* hps,
                                     void* out, int n1, int n2, int D, int kind,
                                     int dtype, int flags, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_cov<float>(x1, x2, hps, out, n1, n2, D, kind, flags, s);
  if (dtype == 2) return launch_cov<double>(x1, x2, hps, out, n1, n2, D, kind, flags, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5: xb (nb, B, D) and mask (nb, B) float32, rows / cols (T,) int32 point
// blocks (clamped into [0, nb) where read), live (T,) one byte a tile, hps
// (1 + n_ls,) float32: the signal variance, then n_ls = D lengthscales or
// one for every dimension; dtype 0 = float32, 1 = bfloat16 tiles.
// fvgp_tile_covariance writes out (T, B, B) tiles; fvgp_tile_covariance_vjp
// reads tbar (T, B, B) tile cotangents and writes partial (T, 1 + D) float32.
extern "C" int fvgp_tile_covariance(const float* xb, const float* mask, const int* rows,
                                    const int* cols, const unsigned char* live,
                                    const float* hps, void* out, long long T, int nb, int B,
                                    int D, int n_ls, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_tile_cov<float>(xb, mask, rows, cols, live, hps, nullptr, out, T, nb, B, D,
                                  n_ls, false, s);
  if (dtype == 1)
    return launch_tile_cov<bf16>(xb, mask, rows, cols, live, hps, nullptr, out, T, nb, B, D,
                                 n_ls, false, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fvgp_tile_covariance_vjp(const float* xb, const float* mask, const int* rows,
                                        const int* cols, const unsigned char* live,
                                        const float* hps, const void* tbar, float* partial,
                                        long long T, int nb, int B, int D, int n_ls, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_tile_cov<float>(xb, mask, rows, cols, live, hps, tbar, partial, T, nb, B, D,
                                  n_ls, true, s);
  if (dtype == 1)
    return launch_tile_cov<bf16>(xb, mask, rows, cols, live, hps, tbar, partial, T, nb, B, D,
                                 n_ls, true, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

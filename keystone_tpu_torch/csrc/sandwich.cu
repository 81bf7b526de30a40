// Banded GEMM sandwich of the LCS extractor: out = At · Z · B over a stack of
// (H, W) planes Z, in float32 FMA (no TF32).
//
// Replaces the Pallas TPU kernel keystone_tpu/ops/images/pallas_kernels.py:129
// plane_sandwich (body _plane_sandwich_kernel :121):
//   out[b, p, m, n] = Σ_w (Σ_h at[m, h] · planes[b, p, h, w]) · bm[w, n]
//
// Bound on the H100: bytes. The operators are banded: each row of At and each
// column of B of the LCS extractor holds 6 nonzeros (the 1/6 box of one
// sub-patch). Over the bands the serving shape (B = 64, P = 6, 256²,
// M = N = 224) needs about 0.5 GFLOP, against 100.7 MB of planes read and
// 77.1 MB of output written: 178 MB, 0.053 ms at 3.35 TB/s. So the kernel
// reads each plane element from device memory about once (neighbouring
// tiles' overlap comes from L2), keeps T1 = At · Z on chip, writes each
// output once, keeps reads in flight across its work, and multiplies
// little beyond the bands. Unlike a dense sandwich (about 21 GFLOP at the
// serving shape), it is not bound by the FMA rate. What still holds it
// above the bound is latency: shared-memory loads feeding FMAs and the
// block's barriers, which leave the issue slots mostly idle (PERF.md).
//
// Design. The band [lo, hi) of each row of At and of each column of B comes
// from the operator (band_extents in ops/images/kernels.py). Outside it the
// operator is exactly 0, so a term skipped there changes no sum but for the
// sign of a zero, and every sum runs by fmaf in ascending order of its
// reduction index, as in a dense product. A block keeps one tile of BM = 16
// rows of M, in the caller's row order (sorted by band start, so the rows of
// a tile share most of their band: about 21 rows of H for LCS at 256²), and
// one span of the columns of N (all of N where W fits one chunk of CW = 256
// columns; else a share of N sized so that the union of its columns'
// bands, its window of W, mostly fits one chunk), and walks a share of the
// (image, plane) items of that tile; the blocks of all tiles walk the items
// in the same order, so a plane's rows that several tiles need are read
// from device memory once and from L2 after. For each item, the block walks
// its window in chunks of at most CW columns of W:
//   1. T1[r][w] = Σ_h at[m_r, h] · Z[h, w], w over the chunk. The rows of Z
//      in the union of the tile's row bands, with the tile's At values, are
//      staged KH rows at a time by cp.async into a ring of NSTAGE buffers
//      that runs on across chunks and items, so the next rows are in flight
//      while this chunk finishes: 16-byte copies where W is a multiple of 4,
//      4-byte ones otherwise (a chunk starts on a multiple of 32). Each
//      thread owns 4 adjacent rows of the tile (in the sorted order, so their
//      bands nearly coincide) and 4 columns, and sums h over the union of its
//      4 rows' bands: each staged value of Z feeds 4 FMAs. T1 (16 rows × the
//      chunk) stays in shared memory, each row skewed by one bank every 32
//      columns; it never reaches device memory.
//   2. out[b, p, m_r, n] = Σ_w T1[r][w] · bm[w, n], w over the part in the
//      chunk of column n's own band. Lane n of a warp takes a column, 32
//      adjacent columns a warp, and sums all 16 rows in registers: one value
//      of bm feeds 16 FMAs. The first KB values of each column's band are
//      staged once per block in shared memory (the same values serve every
//      item); a longer band reads the rest from bm through L1. Each output
//      row is stored in a 128-byte run of the warp's 32 lanes. A column
//      whose band began in an earlier chunk starts from the sums its lane
//      stored there, so each sum is one chain of FMAs in ascending w
//      whatever the chunking.
// No width is refused: shared memory holds one chunk of T1 and one span's
// staged columns, whatever W and N.

#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int BM = 16;          // rows of M per tile
constexpr int TPB = 256;        // threads per block
constexpr int KH = 8;           // rows of H per staged chunk
constexpr int CW = TPB;         // columns of W per chunk
constexpr int COL_THREADS = 64; // stage 1: threads across a chunk's columns
constexpr int COLS_PER_THREAD = CW / COL_THREADS;
constexpr int ROW_GROUPS = TPB / COL_THREADS;   // stage 1: rows 4g..4g+3 for thread group g
constexpr int ROWS_PER_GROUP = BM / ROW_GROUPS;
constexpr int NSTAGE = 3;       // chunks in the ring
constexpr int KB = 8;           // band values of each column of bm kept in shared memory
constexpr int SPAN_W = 224;     // columns of W a span aims at, where W > CW
constexpr int MAX_SPAN_N = 1024;  // columns of N a span takes at most

constexpr int SLOT = KH * CW + KH * BM;   // one chunk: Z[KH][CW], at[KH][BM]
constexpr int VEC_PER_THREAD = KH * CW / (4 * TPB);  // 16-byte copies per chunk

static_assert(ROWS_PER_GROUP == 4 && COLS_PER_THREAD == 4, "stage 1: 4 x 4 sums a thread");
static_assert(COL_THREADS % 32 == 0, "stage 1: a warp is in one row group");
static_assert(KH * CW % (4 * TPB) == 0, "whole float4s per thread");
static_assert(SLOT % 4 == 0, "float4-aligned slots");
static_assert(MAX_SPAN_N % 32 == 0, "spans of whole warps");

// T1's row stride and the column of w in a row: one bank of skew every 32
// columns, so that columns 32 apart, which 32 lanes often read together in
// stage 2, fall in different banks.
__host__ __device__ constexpr int t1_stride(int W) { return (W + W / 32 + 4) & ~3; }
__device__ __forceinline__ int t1_col(int w) { return w + (w >> 5); }

// Shared memory of a launch: T1 over a chunk, the ring, the span's columns'
// staged band values and their bands.
inline size_t smem_bytes(int chunk_w, int span_n) {
  return sizeof(float) * ((size_t)BM * t1_stride(chunk_w) + (size_t)NSTAGE * SLOT +
                          (size_t)KB * span_n) +
         sizeof(int) * 2 * (size_t)span_n;
}

// CHUNKED: the window may span several chunks (W > CW). A launch with W <=
// CW has one chunk, and compiles without the code that resumes a sum.
template <bool CHUNKED>
__global__ void __launch_bounds__(TPB, 3)
sandwich_kernel(const float* __restrict__ planes, const float* __restrict__ at,
                const float* __restrict__ bm, const int* __restrict__ at_lo,
                const int* __restrict__ at_hi, const int* __restrict__ b_lo,
                const int* __restrict__ b_hi, const int* __restrict__ row_order,
                float* __restrict__ out, int n_items, int H, int W, int M, int N,
                int span_n, int chunk_w) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int tile_rows[BM];               // the tile's rows of M, in the caller's order; −1 past M
  __shared__ int group_band[ROW_GROUPS][2];   // union of each row group's bands
  __shared__ int hband[2];                    // union of the tile's row bands
  __shared__ int window[2];                   // union of the span's column bands
  const int S = t1_stride(chunk_w);
  float* T1 = smem;                           // [BM][S], columns at t1_col(w − c0)
  float* ring = T1 + (size_t)BM * S;          // [NSTAGE][SLOT]
  float* bt = ring + (size_t)NSTAGE * SLOT;   // [KB][span_n]: bm[lo_n + k, n], 0 past the band
  int* cband = reinterpret_cast<int*>(bt + (size_t)KB * span_n);  // [span_n][2]: band of column n

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.z * span_n;         // the span's first column
  const int ns = min(N - n0, span_n);         // and its column count
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) { window[0] = W; window[1] = 0; }
  __syncthreads();
  int wlo = W, whi = 0;
  for (int j = tid; j < ns; j += TPB) {
    const int n = n0 + j;
    const int lo = max(b_lo[n], 0), hi = min(b_hi[n], W);
    cband[2 * j] = lo;
    cband[2 * j + 1] = hi;
    if (lo < hi) { wlo = min(wlo, lo); whi = max(whi, hi); }
#pragma unroll
    for (int k = 0; k < KB; ++k)  // loads at clamped rows, so they issue together
      bt[k * span_n + j] = lo + k < hi ? bm[(size_t)min(lo + k, W - 1) * N + n] : 0.0f;
  }
  if (wlo < whi) {
    atomicMin(&window[0], wlo);
    atomicMax(&window[1], whi);
  }
  // the tile's rows and the unions of their bands, in warp 0
  if (warp == 0) {
    int m = -1, lo = H, hi = 0;
    if (lane < BM && m0 + lane < M) {
      const int r = row_order[m0 + lane];
      if (r >= 0 && r < M) {
        m = r;
        const int l = max(at_lo[r], 0), h = min(at_hi[r], H);
        if (l < h) { lo = l; hi = h; }
      }
    }
    if (lane < BM) tile_rows[lane] = m;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      if (off == ROWS_PER_GROUP / 2 && lane < BM && lane % ROWS_PER_GROUP == 0) {
        group_band[lane / ROWS_PER_GROUP][0] = lo;
        group_band[lane / ROWS_PER_GROUP][1] = hi;
      }
    }
    if (lane == 0) { hband[0] = lo; hband[1] = hi; }
  }
  __syncthreads();  // bt, cband, the window and the tile are ready
  const int hlo = hband[0], hhi = hband[1];
  wlo = window[0];
  whi = window[1];

  // items of this block: blockIdx.y, + gridDim.y, ... < n_items (item = b·P + p)
  const int item0 = blockIdx.y, item_step = gridDim.y;
  const int my_items = item0 < n_items ? (n_items - item0 + item_step - 1) / item_step : 0;
  const bool vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(planes) & 15) == 0;
  // chunks start on a multiple of 32 columns: a multiple of 4 for the
  // 16-byte copies, and a row's copies in as few 128-byte segments as the
  // window allows
  const int c_first = wlo & ~31;
  const int n_chunks = wlo < whi ? (whi - c_first + chunk_w - 1) / chunk_w : 0;
  const int n_h = hlo < hhi ? (hhi - hlo + KH - 1) / KH : 0;
  const int steps_per_item = n_chunks * n_h;

  if (steps_per_item == 0) {  // all-zero rows or columns: a zero output
    for (int it = 0; it < my_items; ++it) {
      const size_t item = (size_t)item0 + (size_t)it * item_step;
      for (int e = tid; e < BM * ns; e += TPB) {
        const int m = tile_rows[e / ns];
        if (m >= 0) out[(item * M + m) * N + n0 + e % ns] = 0.0f;
      }
    }
    return;
  }
  const int n_steps = my_items * steps_per_item;

  // stage 1 thread roles: rows 4g..4g+3, columns cl + 64j of a chunk
  const int g = tid / COL_THREADS, cl = tid % COL_THREADS;
  const int glo = group_band[g][0], ghi = group_band[g][1];

  auto stage = [&](int s) {  // step s: (item, column chunk, row chunk)
    float* buf = ring + (s % NSTAGE) * SLOT;
    const int it = s / steps_per_item, rem = s % steps_per_item;
    const int w0 = c_first + rem / n_h * chunk_w, h0 = hlo + rem % n_h * KH;
    const float* z = planes + (size_t)(item0 + it * item_step) * H * W;
    if (vec) {
#pragma unroll
      for (int i = 0; i < VEC_PER_THREAD; ++i) {
        const int e = tid + i * TPB, hh = e / (CW / 4), c = (e % (CW / 4)) * 4;
        const int h = h0 + hh, w = w0 + c;
        const bool ok = h < hhi && w < W && c < chunk_w;
        cp_async16(buf + hh * CW + c, ok ? z + (size_t)h * W + w : planes, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < KH * CW / TPB; ++i) {
        const int e = tid + i * TPB, hh = e / CW, c = e % CW;
        const int h = h0 + hh, w = w0 + c;
        const bool ok = h < hhi && w < W && c < chunk_w;
        cp_async4(buf + hh * CW + c, ok ? z + (size_t)h * W + w : planes, ok);
      }
    }
    for (int e = tid; e < KH * BM; e += TPB) {
      const int h = h0 + e / BM, m = tile_rows[e % BM];
      const bool ok = h < hhi && m >= 0;
      cp_async4(buf + KH * CW + e, at + (ok ? (size_t)m * H + h : 0), ok);
    }
  };

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_steps) stage(s);
    cp_async_commit();
  }
  for (int it = 0; it < my_items; ++it) {
    const size_t item = (size_t)item0 + (size_t)it * item_step;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int c0 = c_first + ch * chunk_w;
      // -- 1. T1 = at[tile] · Z over the chunk ------------------------------
      float acc[ROWS_PER_GROUP][COLS_PER_THREAD];
#pragma unroll
      for (int i = 0; i < ROWS_PER_GROUP; ++i)
#pragma unroll
        for (int j = 0; j < COLS_PER_THREAD; ++j) acc[i][j] = 0.0f;
      for (int kk = 0; kk < n_h; ++kk) {
        // chunk s is in, and every thread is done with chunk s − 1, whose
        // slot now takes chunk s + NSTAGE − 1
        const int s = (it * n_chunks + ch) * n_h + kk;
        cp_async_wait<NSTAGE - 2>();
        __syncthreads();
        if (s + NSTAGE - 1 < n_steps) stage(s + NSTAGE - 1);
        cp_async_commit();
        const float* buf = ring + (s % NSTAGE) * SLOT;
        const int h0 = hlo + kk * KH;
        const int hb = max(glo, h0) - h0, he = min(ghi, h0 + KH) - h0;
        for (int hh = hb; hh < he; ++hh) {
          const float4 a4 = *reinterpret_cast<const float4*>(buf + KH * CW + hh * BM + g * ROWS_PER_GROUP);
          const float a[ROWS_PER_GROUP] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int j = 0; j < COLS_PER_THREAD; ++j) {
            const float zv = buf[hh * CW + cl + j * COL_THREADS];
#pragma unroll
            for (int i = 0; i < ROWS_PER_GROUP; ++i) acc[i][j] = fmaf(a[i], zv, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < COLS_PER_THREAD; ++j) {
        const int c = cl + j * COL_THREADS;
        if (c < chunk_w) {
#pragma unroll
          for (int i = 0; i < ROWS_PER_GROUP; ++i)
            T1[(g * ROWS_PER_GROUP + i) * S + t1_col(c)] = acc[i][j];
        }
      }
      // T1 is complete; the next chunk rewrites it only after the barrier of
      // its own first step, which every thread reaches after this stage 2
      __syncthreads();

      // -- 2. out[item, tile rows, span] (+)= T1 · bm over the chunk --------
      const int c1 = min(c0 + chunk_w, whi);
      for (int j = warp * 32 + lane; j - lane < ns; j += TPB) {
        if (j >= ns) continue;
        const int n = n0 + j;
        const int lo = cband[2 * j], hi = cband[2 * j + 1];
        const int blo = CHUNKED ? max(lo, c0) : lo, bhi = CHUNKED ? min(hi, c1) : hi;
        // a column stores its part of this chunk, and a zero column once
        if (CHUNKED && !(blo < bhi || (lo >= hi && ch == 0))) continue;
        const bool resume = CHUNKED && lo < hi && lo < c0;
        float o[BM];
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const int m = tile_rows[r];
          o[r] = resume && m >= 0 ? out[(item * M + m) * N + n] : 0.0f;
        }
        for (int w = blo; w < bhi; ++w) {
          const float bv = w - lo < KB ? bt[(w - lo) * span_n + j] : __ldg(bm + (size_t)w * N + n);
          const float* t = T1 + t1_col(w - c0);
#pragma unroll
          for (int r = 0; r < BM; ++r) o[r] = fmaf(t[r * S], bv, o[r]);
        }
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const int m = tile_rows[r];
          if (m >= 0) out[(item * M + m) * N + n] = o[r];
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Per device and instantiation: the shared memory the kernel was last
// allowed and the blocks of that size an SM holds, so that a launch makes the attribute and
// occupancy queries only when the size changes (they cost the host tens of
// microseconds, longer than the kernel at small shapes).
struct LaunchShape {
  size_t smem = 0;
  int per_sm = 0, sms = 0;
};
constexpr int MAX_DEVICES = 64;
LaunchShape launch_shapes[MAX_DEVICES][2];  // [device][chunked]

}  // namespace

extern "C" {

// planes: (B, P, H, W); at: (M, H); b: (W, N); at_lo, at_hi: (M) band of each
// row of at; b_lo, b_hi: (N) band of each column of b (int32, [lo, hi),
// clamped to the operator); row_order: (M) the rows of M in the order the
// tiles take them (a permutation; entries outside [0, M) are skipped); out:
// (B, P, M, N). Any W and N: shared memory holds T1 over one chunk of at
// most 256 columns of W and one span of at most 1,024 columns of N (at most
// about 83 KB).
int ks_plane_sandwich(const float* planes, const float* at, const float* b,
                      const int* at_lo, const int* at_hi, const int* b_lo,
                      const int* b_hi, const int* row_order, float* out, int B,
                      int P, int H, int W, int M, int N, void* stream) {
  if (B < 1 || P < 1 || H < 1 || W < 1 || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  // spans: all of N where W fits one chunk (the serving shapes), else
  // about SPAN_W columns of W each
  int n_spans = W <= CW ? 1 : (W + SPAN_W - 1) / SPAN_W;
  n_spans = std::max(n_spans, (N + MAX_SPAN_N - 1) / MAX_SPAN_N);
  int span_n = (N + n_spans - 1) / n_spans;
  span_n = std::min((span_n + 31) / 32 * 32, MAX_SPAN_N);
  n_spans = (N + span_n - 1) / span_n;
  if (n_spans > 65535) return (int)cudaErrorInvalidValue;
  const int chunk_w = std::min(W, CW);
  const size_t smem = smem_bytes(chunk_w, span_n);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const bool chunked = W > CW;
  auto kernel = chunked ? sandwich_kernel<true> : sandwich_kernel<false>;
  LaunchShape& shape = launch_shapes[dev][chunked];
  if (shape.smem != smem) {
    LaunchShape s;
    s.smem = smem;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, kernel, TPB,
                                                             smem)) != cudaSuccess)
      return (int)err;
    if (s.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    shape = s;
  }
  // enough blocks to fill every SM once, spread over the tiles and spans
  const int tiles = (M + BM - 1) / BM, n_items = B * P;
  const int per_tile = (int)std::min<long long>(
      n_items,
      std::max<long long>(1, (long long)shape.sms * shape.per_sm / ((long long)tiles * n_spans)));
  dim3 grid(tiles, std::min(per_tile, 65535), n_spans);
  kernel<<<grid, TPB, smem, (cudaStream_t)stream>>>(
      planes, at, b, at_lo, at_hi, b_lo, b_hi, row_order, out, n_items, H, W, M, N, span_n,
      chunk_w);
  return (int)cudaGetLastError();
}

}  // extern "C"

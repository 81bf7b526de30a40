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
// walks a share of the (image, plane) items of that tile; the blocks of all
// tiles walk the items in the same order, so a plane's rows that several
// tiles need are read from device memory once and from L2 after. For each
// item:
//   1. T1[r][w] = Σ_h at[m_r, h] · Z[h, w]. The rows of Z in the union of the
//      tile's row bands, with the tile's At values, are staged KH rows at a
//      time by cp.async into a ring of NSTAGE buffers that runs on across
//      items, so the next item's rows are in flight while this one
//      finishes: 16-byte copies where W is a multiple of 4, 4-byte ones
//      otherwise. Each thread owns 4 adjacent rows of the tile (in the
//      sorted order, so their bands nearly coincide) and 4 columns, and
//      sums h over the union of its 4 rows' bands: each staged value of Z
//      feeds 4 FMAs. T1 (16 rows × W floats) stays in shared memory, each
//      row skewed by one bank every 32 columns; it never reaches device
//      memory.
//   2. out[b, p, m_r, n] = Σ_w T1[r][w] · bm[w, n], w over column n's own
//      band. Lane n of a warp takes a column, 32 adjacent columns a warp,
//      and sums all 16 rows in registers: one value of bm feeds 16 FMAs.
//      The first KB values of each column's band are staged once per block
//      in shared memory (the same values serve every item); a longer band
//      reads the rest from bm through L1. Each output row is stored in a
//      128-byte run of the warp's 32 lanes.

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

constexpr int SLOT = KH * CW + KH * BM;   // one chunk: Z[KH][CW], at[KH][BM]
constexpr int VEC_PER_THREAD = KH * CW / (4 * TPB);  // 16-byte copies per chunk

static_assert(ROWS_PER_GROUP == 4 && COLS_PER_THREAD == 4, "stage 1: 4 x 4 sums a thread");
static_assert(COL_THREADS % 32 == 0, "stage 1: a warp is in one row group");
static_assert(KH * CW % (4 * TPB) == 0, "whole float4s per thread");
static_assert(SLOT % 4 == 0, "float4-aligned slots");

// T1's row stride and the column of w in a row: one bank of skew every 32
// columns, so that columns 32 apart, which 32 lanes often read together in
// stage 2, fall in different banks.
__host__ __device__ constexpr int t1_stride(int W) { return (W + W / 32 + 4) & ~3; }
__device__ __forceinline__ int t1_col(int w) { return w + (w >> 5); }

// Shared memory of a launch: T1, the ring, the columns' staged band values
// and their bands.
inline size_t smem_bytes(int W, int N) {
  return sizeof(float) * ((size_t)BM * t1_stride(W) + (size_t)NSTAGE * SLOT + (size_t)KB * N) +
         sizeof(int) * 2 * (size_t)N;
}

__global__ void __launch_bounds__(TPB, 3)
sandwich_kernel(const float* __restrict__ planes, const float* __restrict__ at,
                const float* __restrict__ bm, const int* __restrict__ at_lo,
                const int* __restrict__ at_hi, const int* __restrict__ b_lo,
                const int* __restrict__ b_hi, const int* __restrict__ row_order,
                float* __restrict__ out, int n_items, int H, int W, int M, int N) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int tile_rows[BM];               // the tile's rows of M, in the caller's order; −1 past M
  __shared__ int group_band[ROW_GROUPS][2];   // union of each row group's bands
  __shared__ int hband[2];                    // union of the tile's row bands
  const int S = t1_stride(W);
  float* T1 = smem;                           // [BM][S], columns at t1_col(w)
  float* ring = T1 + (size_t)BM * S;          // [NSTAGE][SLOT]
  float* bt = ring + (size_t)NSTAGE * SLOT;   // [KB][N]: bm[lo_n + k, n], 0 past the band
  int* cband = reinterpret_cast<int*>(bt + (size_t)KB * N);  // [N][2]: band of column n

  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int n = tid; n < N; n += TPB) {
    const int lo = max(b_lo[n], 0), hi = min(b_hi[n], W);
    cband[2 * n] = lo;
    cband[2 * n + 1] = hi;
#pragma unroll
    for (int k = 0; k < KB; ++k)  // loads at clamped rows, so they issue together
      bt[k * N + n] = lo + k < hi ? bm[(size_t)min(lo + k, W - 1) * N + n] : 0.0f;
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
  __syncthreads();
  const int hlo = hband[0], hhi = hband[1];

  // items of this block: blockIdx.y, + gridDim.y, ... < n_items (item = b·P + p)
  const int item0 = blockIdx.y, item_step = gridDim.y;
  const int my_items = item0 < n_items ? (n_items - item0 + item_step - 1) / item_step : 0;
  const int n_h = hlo < hhi ? (hhi - hlo + KH - 1) / KH : 0;
  const int n_wc = (W + CW - 1) / CW;
  const int steps_per_item = n_wc * n_h;   // 0 when every row of the tile is zero
  const int n_steps = my_items * steps_per_item;
  const bool vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(planes) & 15) == 0;

  // stage 1 thread roles: rows 4g..4g+3, columns cl + 64j of a chunk
  const int g = tid / COL_THREADS, cl = tid % COL_THREADS;
  const int glo = group_band[g][0], ghi = group_band[g][1];

  auto stage = [&](int s) {  // step s: (item, column chunk, row chunk)
    float* buf = ring + (s % NSTAGE) * SLOT;
    const int it = s / steps_per_item, rem = s % steps_per_item;
    const int w0 = rem / n_h * CW, h0 = hlo + rem % n_h * KH;
    const float* z = planes + (size_t)(item0 + it * item_step) * H * W;
    if (vec) {
#pragma unroll
      for (int i = 0; i < VEC_PER_THREAD; ++i) {
        const int e = tid + i * TPB, hh = e / (CW / 4), c = (e % (CW / 4)) * 4;
        const int h = h0 + hh, w = w0 + c;
        const bool ok = h < hhi && w < W;
        cp_async16(buf + hh * CW + c, ok ? z + (size_t)h * W + w : planes, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < KH * CW / TPB; ++i) {
        const int e = tid + i * TPB, hh = e / CW, c = e % CW;
        const int h = h0 + hh, w = w0 + c;
        const bool ok = h < hhi && w < W;
        cp_async4(buf + hh * CW + c, ok ? z + (size_t)h * W + w : planes, ok);
      }
    }
    for (int e = tid; e < KH * BM; e += TPB) {
      const int h = h0 + e / BM, m = tile_rows[e % BM];
      const bool ok = h < hhi && m >= 0;
      cp_async4(buf + KH * CW + e, at + (ok ? (size_t)m * H + h : 0), ok);
    }
  };

  // with an all-zero tile there are no steps, and T1 is zero for every item
  if (n_steps == 0) {
    for (int i = tid; i < BM * S; i += TPB) T1[i] = 0.0f;
  }
  __syncthreads();  // bt, cband and T1 are ready
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_steps) stage(s);
    cp_async_commit();
  }
  for (int it = 0; it < my_items; ++it) {
    // -- 1. T1 = at[tile] · Z for this item -------------------------------
    float acc[ROWS_PER_GROUP][COLS_PER_THREAD];
#pragma unroll
    for (int i = 0; i < ROWS_PER_GROUP; ++i)
#pragma unroll
      for (int j = 0; j < COLS_PER_THREAD; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < steps_per_item; ++k) {
      // chunk s is in, and every thread is done with chunk s − 1, whose
      // slot now takes chunk s + NSTAGE − 1
      const int s = it * steps_per_item + k;
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();
      if (s + NSTAGE - 1 < n_steps) stage(s + NSTAGE - 1);
      cp_async_commit();
      const float* buf = ring + (s % NSTAGE) * SLOT;
      const int h0 = hlo + k % n_h * KH;
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
      if (k % n_h == n_h - 1) {  // the last chunk of this column range
        const int w0 = k / n_h * CW;
#pragma unroll
        for (int j = 0; j < COLS_PER_THREAD; ++j) {
          const int w = w0 + cl + j * COL_THREADS;
#pragma unroll
          for (int i = 0; i < ROWS_PER_GROUP; ++i) {
            if (w < W) T1[(g * ROWS_PER_GROUP + i) * S + t1_col(w)] = acc[i][j];
            acc[i][j] = 0.0f;
          }
        }
      }
    }
    // T1 is complete; the next item rewrites it only after the barrier of
    // its own steps, which every thread reaches after this item's stage 2
    __syncthreads();

    // -- 2. out[item, tile rows, :] = T1 · bm, 32 columns a warp ------------
    const size_t item = (size_t)item0 + (size_t)it * item_step;
    for (int n = warp * 32 + lane; n - lane < N; n += TPB) {
      if (n >= N) continue;
      float o[BM];
#pragma unroll
      for (int r = 0; r < BM; ++r) o[r] = 0.0f;
      const int lo = cband[2 * n], hi = cband[2 * n + 1];
      for (int w = lo; w < hi; ++w) {
        const float bv = w - lo < KB ? bt[(w - lo) * N + n] : __ldg(bm + (size_t)w * N + n);
        const float* t = T1 + t1_col(w);
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
  cp_async_wait<0>();
}

// Per device: the shared memory the kernel was last allowed and the blocks
// of that size an SM holds, so that a launch makes the attribute and
// occupancy queries only when the size changes (they cost the host tens of
// microseconds, longer than the kernel at small shapes).
struct LaunchShape {
  size_t smem = 0;
  int per_sm = 0, sms = 0;
};
constexpr int MAX_DEVICES = 64;
LaunchShape launch_shapes[MAX_DEVICES];

}  // namespace

extern "C" {

// planes: (B, P, H, W); at: (M, H); b: (W, N); at_lo, at_hi: (M) band of each
// row of at; b_lo, b_hi: (N) band of each column of b (int32, [lo, hi),
// clamped to the operator); row_order: (M) the rows of M in the order the
// tiles take them (a permutation; entries outside [0, M) are skipped); out:
// (B, P, M, N). Shared memory grows with W (about 66 bytes a column) and
// with N (40 bytes a column); a launch whose shared memory does not fit is
// refused.
int ks_plane_sandwich(const float* planes, const float* at, const float* b,
                      const int* at_lo, const int* at_hi, const int* b_lo,
                      const int* b_hi, const int* row_order, float* out, int B,
                      int P, int H, int W, int M, int N, void* stream) {
  if (B < 1 || P < 1 || H < 1 || W < 1 || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(W, N);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  LaunchShape& shape = launch_shapes[dev];
  if (shape.smem != smem) {
    LaunchShape s;
    s.smem = smem;
    if ((err = cudaFuncSetAttribute(sandwich_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, sandwich_kernel, TPB,
                                                             smem)) != cudaSuccess)
      return (int)err;
    if (s.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    shape = s;
  }
  // enough blocks to fill every SM once, spread over the tiles
  const int tiles = (M + BM - 1) / BM, n_items = B * P;
  const int per_tile = (int)std::min<long long>(
      n_items, std::max<long long>(1, (long long)shape.sms * shape.per_sm / tiles));
  dim3 grid(tiles, std::min(per_tile, 65535));
  sandwich_kernel<<<grid, TPB, smem, (cudaStream_t)stream>>>(
      planes, at, b, at_lo, at_hi, b_lo, b_hi, row_order, out, n_items, H, W, M, N);
  return (int)cudaGetLastError();
}

}  // extern "C"

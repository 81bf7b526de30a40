// Banded SIFT orientation binning and spatial sampling, in float32 FMA (no
// TF32).
//
// Replaces the Pallas TPU kernel keystone_tpu/ops/images/pallas_kernels.py:76
// sift_bin_sample (body _sift_bin_sample_kernel :53):
//   out[b, p, m, n] = Σ_w (Σ_h ayt[m, h] · plane_p[b, h, w]) · ax[w, n]
// where plane_p is the share of the gradient magnitude that the trilinear
// binning gives orientation p.
//
// Bound on the H100: bytes. The operators are banded: a SIFT sampling column
// is one triangle of half-width bin (4 to 19 nonzeros of 256 at 256²). Over
// its band the function needs about 5 GFLOP at the serving shapes (B = 64,
// four scales), and writing the (B, 8, M, N) output (431 MB) takes most of
// the least time.
//
// Design. The band [lo, hi) of each row of ayt and of each column of ax
// comes from the operator (band_extents in ops/images/kernels.py). Outside
// it the operator is exactly 0, so a term skipped there changes no sum but
// for the sign of a zero, and every sum runs in ascending order of its
// reduction index, as in a dense product. One block takes a tile of BM = 8
// rows of M, in the caller's row order (sorted by band start, so the rows
// of a tile share most of their band), for one image b and all 8
// orientations, and one span of the columns of N (all of N where W fits
// one chunk of CW = 256 columns; else a share of N sized so that the
// union of its columns' bands, its window of W, mostly fits one chunk).
// The block walks its window in chunks of at most CW columns of W:
//   1. T1[w][p·8 + r] = Σ_h ayt[m_r, h] · plane_p[h, w], h over the union of
//      the tile's row bands, w over the chunk. Rows of mag and orient, with
//      the tile's ayt values, are staged KH rows at a time by 4-byte
//      cp.async (row strides need not be 16-byte aligned), double-buffered.
//      Each thread owns one column w and all 8 × 8 (r, p) sums in
//      registers, and bins each pixel once per h into its two orientations.
//      T1 (chunk × 64 floats) stays in shared memory; it never reaches
//      device memory.
//   2. out[b, p, m_r, n] = Σ_w T1[w][p·8 + r] · ax[w, n], w over the part in
//      the chunk of the union of the bands of a group of 8 adjacent columns.
//      Each warp walks its own groups of the span with no block barrier: it
//      stages the group's ax rows in its own shared buffers
//      (double-buffered, the next group's rows in flight while this one
//      computes), each lane sums a 4 × 4 tile (4 T1 rows × 4 columns, two
//      float4 reads per 16 FMAs) and stores it straight from registers: a
//      float4 per row, so two lanes write 32 contiguous bytes of an output
//      row, where N is a multiple of 4; element by element otherwise. A
//      group whose band began in an earlier chunk starts from the sums it
//      stored there (the same lane wrote them), so the sum over w is one
//      chain of FMAs in ascending w whatever the chunking: the output is
//      the same bit for bit as in one chunk.
// Inside a union, terms outside a row's or column's own band multiply an
// exact 0 of the operator. No width is refused: shared memory holds one
// chunk, whatever W, and a window wider than a chunk (dense operators) is
// walked chunk by chunk.

#include <cuda_runtime.h>
#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int NUM_ORIENTATIONS = 8;
constexpr int BM = 8;                            // rows of M per block
constexpr int TPB = 256;                         // threads per block
constexpr int ROWS = NUM_ORIENTATIONS * BM;      // T1 row (p, r) -> p·BM + r
constexpr int T1_STRIDE = ROWS + 4;              // conflict-free float4 stores
constexpr int KH = 8;                            // rows of H per stage-1 chunk
constexpr int CW = TPB;                          // columns of W per chunk
constexpr int GW = 8;                            // columns of N per warp group
constexpr int KWW = 32;                          // rows of ax per staged chunk
constexpr int SPAN_W = 192;                      // columns of W a span aims at, where W > CW
constexpr int MAX_SPAN_N = 2048;                 // columns of N a span takes at most

// Stage 1 uses the scratch area as two buffers of mag[KH][CW],
// orient[KH][CW], aT[KH][BM]; stage 2 gives each warp axw[2][KWW][GW].
constexpr int STAGE1_BUF = 2 * KH * CW + KH * BM;
constexpr int STAGE1_FLOATS = 2 * STAGE1_BUF;
constexpr int WARP_FLOATS = 2 * KWW * GW;
constexpr int STAGE2_FLOATS = TPB / 32 * WARP_FLOATS;
constexpr int SCRATCH_FLOATS = STAGE1_FLOATS > STAGE2_FLOATS ? STAGE1_FLOATS : STAGE2_FLOATS;

static_assert(CW == TPB, "stage 1 gives each thread one column");
static_assert(WARP_FLOATS % 4 == 0, "float4-aligned warp areas");
static_assert(ROWS == 16 * 4 && GW == 2 * 4, "stage 2: 16 x 2 lane tiles of 4 x 4");
static_assert(MAX_SPAN_N % GW == 0, "spans of whole groups");

// CHUNKED: the window may span several chunks (W > CW). A launch with W <=
// CW has one chunk, and compiles without the code that resumes a sum.
template <bool CHUNKED>
__global__ void __launch_bounds__(TPB, 2)
sift_bin_kernel(const float* __restrict__ mag, const float* __restrict__ orient,
                const float* __restrict__ ayt, const float* __restrict__ ax,
                const int* __restrict__ ay_lo, const int* __restrict__ ay_hi,
                const int* __restrict__ ax_lo, const int* __restrict__ ax_hi,
                const int* __restrict__ row_order, float* __restrict__ out, int H,
                int W, int M, int N, int span_n, int chunk_w) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int tile_rows[BM];  // the tile's rows of M, in the caller's order; −1 past M
  __shared__ int window[2];      // union of the span's column bands
  const int n0 = blockIdx.y * span_n;                   // the span's first column
  const int n_groups = (min(N - n0, span_n) + GW - 1) / GW;
  float* T1 = smem;                                     // [chunk_w][T1_STRIDE]
  float* scratch = smem + (size_t)chunk_w * T1_STRIDE;  // [SCRATCH_FLOATS]
  int* gband = reinterpret_cast<int*>(scratch + SCRATCH_FLOATS);  // [n_groups][2]

  const int m0 = blockIdx.x * BM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* magb = mag + (size_t)b * H * W;
  const float* orb = orient + (size_t)b * H * W;

  if (CHUNKED) {
    if (tid == 0) { window[0] = W; window[1] = 0; }
    __syncthreads();
  }
  // union of the column bands of each group of GW columns, for stage 2,
  // and, when the window may span chunks, of all of them, the window
  int wlo = W, whi = 0;
  for (int gi = tid; gi < n_groups; gi += TPB) {
    int lo = W, hi = 0;
#pragma unroll
    for (int j = 0; j < GW; ++j) {  // loads at clamped indices, so they issue together
      const int n = min(n0 + gi * GW + j, N - 1);
      const int l = max(ax_lo[n], 0), h = min(ax_hi[n], W);
      if (gi * GW + j < span_n && n0 + gi * GW + j < N && l < h) { lo = min(lo, l); hi = max(hi, h); }
    }
    gband[2 * gi] = lo;
    gband[2 * gi + 1] = hi;
    if (lo < hi) { wlo = min(wlo, lo); whi = max(whi, hi); }
  }
  if (CHUNKED && wlo < whi) {
    atomicMin(&window[0], wlo);
    atomicMax(&window[1], whi);
  }

  if (tid < BM) {
    const int m = m0 + tid < M ? row_order[m0 + tid] : -1;
    tile_rows[tid] = m >= 0 && m < M ? m : -1;
  }
  __syncthreads();
  // one chunk (W <= CW) takes all of W, as a window would cost the block's
  // prologue a barrier and atomics for nothing
  wlo = CHUNKED ? window[0] : 0;
  whi = CHUNKED ? window[1] : W;
  // output rows 16-byte aligned: float4 stores and loads
  const bool vec4 = N % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int rq = lane >> 1, cq = lane & 1;  // stage 2 lane tile: T1 rows rq·4.., columns cq·4..

  if (CHUNKED && wlo >= whi) {  // every column of the span is zero: so is its output
    for (int gi = warp; gi < n_groups; gi += TPB / 32) {
      const int n = n0 + gi * GW + cq * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = rq * 4 + i, m = tile_rows[row % BM];
        if (m < 0) continue;
        float* dst = out + (((size_t)b * NUM_ORIENTATIONS + row / BM) * M + m) * N + n;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (cq * 4 + j < GW && gi * GW + cq * 4 + j < span_n && n + j < N) dst[j] = 0.0f;
      }
    }
    return;
  }

  int hlo = H, hhi = 0;  // union of the tile's row bands
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int m = tile_rows[r];
    const int lo = max(ay_lo[max(m, 0)], 0), hi = min(ay_hi[max(m, 0)], H);
    if (m >= 0 && lo < hi) { hlo = min(hlo, lo); hhi = max(hhi, hi); }
  }

  // chunks start on a multiple of 32 columns, so that a warp's loads of a
  // row in stage 1 fall in as few 128-byte segments as the window allows
  const int c_first = wlo & ~31;
  for (int c0 = c_first; c0 < whi; c0 += chunk_w) {
    const int c1 = min(c0 + chunk_w, whi);  // this chunk: columns [c0, c1) of W
    const bool first_chunk = c0 == c_first;

    // -- 1. T1 = ayt[tile] · plane_p over the chunk, all p -----------------
    if (hlo >= hhi) {  // every row of the tile is zero
      for (int i = tid; i < chunk_w * T1_STRIDE; i += TPB) T1[i] = 0.0f;
    } else {
      const int n_h = (hhi - hlo + KH - 1) / KH;
      const int w = c0 + tid;
      const bool w_ok = w < c1;
      auto stage = [&](int it) {
        float* buf = scratch + (it & 1) * STAGE1_BUF;
        const int h0 = hlo + it * KH;
#pragma unroll
        for (int hh = 0; hh < KH; ++hh) {
          const int h = h0 + hh;
          const bool ok = h < hhi && w_ok;
          const size_t g = ok ? (size_t)h * W + w : 0;
          cp_async4(buf + hh * CW + tid, magb + g, ok);
          cp_async4(buf + (KH + hh) * CW + tid, orb + g, ok);
        }
        if (tid < KH * BM) {
          const int h = h0 + tid / BM, m = tile_rows[tid % BM];
          const bool ok = h < hhi && m >= 0;
          cp_async4(buf + 2 * KH * CW + tid, ayt + (ok ? (size_t)m * H + h : 0), ok);
        }
      };

      float acc[BM][NUM_ORIENTATIONS];
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int p = 0; p < NUM_ORIENTATIONS; ++p) acc[r][p] = 0.0f;

      stage(0);
      cp_async_commit();
      for (int it = 0; it < n_h; ++it) {
        if (it + 1 < n_h) stage(it + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const float* buf = scratch + (it & 1) * STAGE1_BUF;
        const int kh = min(KH, hhi - (hlo + it * KH));
        for (int hh = 0; hh < kh; ++hh) {
          const float4 a0 = *reinterpret_cast<const float4*>(buf + 2 * KH * CW + hh * BM);
          const float4 a1 = *reinterpret_cast<const float4*>(buf + 2 * KH * CW + hh * BM + 4);
          const float a[BM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          // the TPU kernel's trilinear binning, in the same arithmetic:
          // orientation b0 takes mag·(1 − frac), b1 takes mag·frac
          const float mg = buf[hh * CW + tid];
          const float o = buf[(KH + hh) * CW + tid];
          const float b0f = floorf(o);
          const float frac = o - b0f;
          int b0 = ((int)b0f) % NUM_ORIENTATIONS;
          if (b0 < 0) b0 += NUM_ORIENTATIONS;
          const int b1 = (b0 + 1) % NUM_ORIENTATIONS;
          const float v0 = mg * (1.0f - frac), v1 = mg * frac;
#pragma unroll
          for (int p = 0; p < NUM_ORIENTATIONS; ++p) {
            const float v = p == b0 ? v0 : (p == b1 ? v1 : 0.0f);
#pragma unroll
            for (int r = 0; r < BM; ++r) acc[r][p] = fmaf(a[r], v, acc[r][p]);
          }
        }
        __syncthreads();
      }
      if (w_ok) {
        float* dst = T1 + (size_t)tid * T1_STRIDE;
#pragma unroll
        for (int p = 0; p < NUM_ORIENTATIONS; ++p)
#pragma unroll
          for (int r = 0; r < BM; r += 4)
            *reinterpret_cast<float4*>(dst + p * BM + r) =
                make_float4(acc[r][p], acc[r + 1][p], acc[r + 2][p], acc[r + 3][p]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // -- 2. out = T1 · ax over the chunk, each warp on its own groups ------
    float* axw = scratch + warp * WARP_FLOATS;   // [2][KWW][GW] staged ax rows
    // group gi's band [lo, hi) and its part [blo, bhi) in the chunk
    auto group_band = [&](int gi, int& blo, int& bhi) {
      blo = gi < n_groups ? max(gband[2 * gi], c0) : W;
      bhi = gi < n_groups ? min(gband[2 * gi + 1], c1) : 0;
    };
    auto stage_rows = [&](float* buf, int gi, int w0, int hi) {
#pragma unroll
      for (int e = lane; e < KWW * GW; e += 32) {
        const int w = w0 + e / GW, j = gi * GW + e % GW, n = n0 + j;
        const bool ok = w < hi && j < span_n && n < N;
        cp_async4(buf + e, ax + (ok ? (size_t)w * N + n : 0), ok);
      }
    };

    float acc[4][4];
    int gi = warp, w0, hi, cur = 0;  // this step: rows w0.. of group gi's part [.., hi)
    group_band(gi, w0, hi);
    if (gi < n_groups && w0 < hi) stage_rows(axw, gi, w0, hi);
    cp_async_commit();
    bool fresh = true;  // acc not yet loaded for group gi
    while (gi < n_groups) {
      const int glo = gband[2 * gi], ghi = gband[2 * gi + 1];
      const int n = n0 + gi * GW + cq * 4;
      const bool col_ok = gi * GW + cq * 4 < span_n && n < N;
      if (fresh) {
        // a group whose band began in an earlier chunk and goes on in this
        // one starts from the sums it stored there
        const bool resume = CHUNKED && glo < c0 && min(ghi, c1) > c0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = rq * 4 + i, m = tile_rows[row % BM];
          const float* src = out + (((size_t)b * NUM_ORIENTATIONS + row / BM) * M + max(m, 0)) * N + n;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = resume && m >= 0 && col_ok && cq * 4 + j < GW &&
                                gi * GW + cq * 4 + j < span_n && n + j < N
                            ? src[j]
                            : 0.0f;
        }
        fresh = false;
      }
      // the step after this one: the group's next rows, or the next group
      int gi2 = gi, hi2 = hi, w02 = w0 + KWW;
      if (w02 >= hi) {
        gi2 = gi + TPB / 32;
        group_band(gi2, w02, hi2);
      }
      if (gi2 < n_groups && w02 < hi2) stage_rows(axw + (cur ^ 1) * KWW * GW, gi2, w02, hi2);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();
      const float* buf = axw + cur * KWW * GW;
      const int we = min(hi, w0 + KWW);
#pragma unroll 2
      for (int w = w0; w < we; ++w) {
        const float4 x = *reinterpret_cast<const float4*>(buf + (w - w0) * GW + cq * 4);
        const float4 t = *reinterpret_cast<const float4*>(T1 + (size_t)(w - c0) * T1_STRIDE + rq * 4);
        const float xv[4] = {x.x, x.y, x.z, x.w}, tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(tv[i], xv[j], acc[i][j]);
      }
      if (gi2 != gi) {
        // the group's part in this chunk is done: store it where it has one,
        // and a group of zero columns in the first chunk
        int blo, bhi;
        group_band(gi, blo, bhi);
        if (!CHUNKED || blo < bhi || (glo >= ghi && first_chunk)) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = rq * 4 + i, m = tile_rows[row % BM];
            if (m >= 0 && col_ok) {
              float* dst = out + (((size_t)b * NUM_ORIENTATIONS + row / BM) * M + m) * N + n;
              const bool whole = n + 4 <= N && gi * GW + cq * 4 + 4 <= span_n;
              if (vec4 && whole) {
                *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
              } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  if (n + j < N && gi * GW + cq * 4 + j < span_n) dst[j] = acc[i][j];
              }
            }
          }
        }
        fresh = true;
      }
      __syncwarp();
      gi = gi2; hi = hi2; w0 = w02; cur ^= 1;
    }
    cp_async_wait<0>();
    __syncthreads();  // T1 and the scratch area are free for the next chunk
  }
}

}  // namespace

extern "C" {

// mag, orient: (B, H, W); ayt: (M, H); ax: (W, N); ay_lo, ay_hi: (M) band of
// each row of ayt; ax_lo, ax_hi: (N) band of each column of ax (int32, [lo,
// hi), clamped to the operator); row_order: (M) the rows of M in the order
// the tiles take them (a permutation; entries outside [0, M) are skipped);
// out: (B, 8, M, N). Any W: shared memory holds one chunk of at most 256
// columns of W (about 107 KB) and the span's column groups.
int ks_sift_bin_sample(const float* mag, const float* orient, const float* ayt,
                       const float* ax, const int* ay_lo, const int* ay_hi,
                       const int* ax_lo, const int* ax_hi, const int* row_order,
                       float* out, int B, int H, int W, int M, int N, void* stream) {
  if (B < 1 || H < 1 || W < 1 || M < 1 || N < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  // spans: all of N where W fits one chunk (the serving shapes), else
  // about SPAN_W columns of W each
  int n_spans = W <= CW ? 1 : (W + SPAN_W - 1) / SPAN_W;
  n_spans = max(n_spans, (N + MAX_SPAN_N - 1) / MAX_SPAN_N);
  int span_n = (N + n_spans - 1) / n_spans;
  span_n = (span_n + GW - 1) / GW * GW;
  n_spans = (N + span_n - 1) / span_n;
  const int chunk_w = min(W, CW);
  const size_t smem = sizeof(float) * ((size_t)chunk_w * T1_STRIDE + SCRATCH_FLOATS) +
                      sizeof(int) * 2 * (span_n / GW);
  auto kernel = W > CW ? sift_bin_kernel<true> : sift_bin_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, n_spans, B);
  kernel<<<grid, TPB, smem, (cudaStream_t)stream>>>(
      mag, orient, ayt, ax, ay_lo, ay_hi, ax_lo, ax_hi, row_order, out, H, W, M, N,
      span_n, chunk_w);
  return (int)cudaGetLastError();
}

}  // extern "C"

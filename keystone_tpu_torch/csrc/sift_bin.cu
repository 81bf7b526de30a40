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
// orientations:
//   1. T1[w][p·8 + r] = Σ_h ayt[m_r, h] · plane_p[h, w], h over the union of
//      the tile's row bands. Rows of mag and orient, with the tile's ayt
//      values, are staged KH rows at a time by 4-byte cp.async (row strides
//      need not be 16-byte aligned), double-buffered. Each thread owns one
//      column w and all 8 × 8 (r, p) sums in registers, and bins each pixel
//      once per h into its two orientations. T1 (W × 64 floats) stays in
//      shared memory; it never reaches device memory.
//   2. out[b, p, m_r, n] = Σ_w T1[w][p·8 + r] · ax[w, n], w over the union of
//      the bands of a group of 8 adjacent columns. Each warp walks its own
//      groups with no block barrier: it stages the group's ax rows in its
//      own shared buffers (double-buffered, the next group's rows in flight
//      while this one computes), each lane sums a 4 × 4 tile (4 T1 rows × 4
//      columns, two float4 reads per 16 FMAs) and stores it straight from
//      registers: a float4 per row, so two lanes write 32 contiguous bytes
//      of an output row, where N is a multiple of 4; element by element
//      otherwise.
// Inside a union, terms outside a row's or column's own band multiply an
// exact 0 of the operator.

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
constexpr int CW = TPB;                          // columns of W per stage-1 chunk
constexpr int GW = 8;                            // columns of N per warp group
constexpr int KWW = 32;                          // rows of ax per staged chunk

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

__global__ void __launch_bounds__(TPB, 2)
sift_bin_kernel(const float* __restrict__ mag, const float* __restrict__ orient,
                const float* __restrict__ ayt, const float* __restrict__ ax,
                const int* __restrict__ ay_lo, const int* __restrict__ ay_hi,
                const int* __restrict__ ax_lo, const int* __restrict__ ax_hi,
                const int* __restrict__ row_order, float* __restrict__ out, int H,
                int W, int M, int N) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int tile_rows[BM];  // the tile's rows of M, in the caller's order; −1 past M
  const int n_groups = (N + GW - 1) / GW;
  float* T1 = smem;                                  // [W][T1_STRIDE]
  float* scratch = smem + (size_t)W * T1_STRIDE;     // [SCRATCH_FLOATS]
  int* gband = reinterpret_cast<int*>(scratch + SCRATCH_FLOATS);  // [n_groups][2]

  const int m0 = blockIdx.x * BM;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* magb = mag + (size_t)b * H * W;
  const float* orb = orient + (size_t)b * H * W;

  // union of the column bands of each group of GW columns, for stage 2
  for (int gi = tid; gi < n_groups; gi += TPB) {
    int lo = W, hi = 0;
#pragma unroll
    for (int j = 0; j < GW; ++j) {  // loads at clamped indices, so they issue together
      const int n = min(gi * GW + j, N - 1);
      const int l = max(ax_lo[n], 0), h = min(ax_hi[n], W);
      if (gi * GW + j < N && l < h) { lo = min(lo, l); hi = max(hi, h); }
    }
    gband[2 * gi] = lo;
    gband[2 * gi + 1] = hi;
  }

  if (tid < BM) {
    const int m = m0 + tid < M ? row_order[m0 + tid] : -1;
    tile_rows[tid] = m >= 0 && m < M ? m : -1;
  }
  __syncthreads();

  // -- 1. T1 = ayt[tile] · plane_p, all p ----------------------------------
  int hlo = H, hhi = 0;  // union of the tile's row bands
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int m = tile_rows[r];
    const int lo = max(ay_lo[max(m, 0)], 0), hi = min(ay_hi[max(m, 0)], H);
    if (m >= 0 && lo < hi) { hlo = min(hlo, lo); hhi = max(hhi, hi); }
  }
  if (hlo >= hhi) {  // every row of the tile is zero
    for (int i = tid; i < W * T1_STRIDE; i += TPB) T1[i] = 0.0f;
  } else {
    const int n_h = (hhi - hlo + KH - 1) / KH;
    const int n_it = n_h * ((W + CW - 1) / CW);
    auto stage = [&](int it) {
      float* buf = scratch + (it & 1) * STAGE1_BUF;
      const int w = (it / n_h) * CW + tid, h0 = hlo + (it % n_h) * KH;
#pragma unroll
      for (int hh = 0; hh < KH; ++hh) {
        const int h = h0 + hh;
        const bool ok = h < hhi && w < W;
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
    for (int it = 0; it < n_it; ++it) {
      if (it + 1 < n_it) stage(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* buf = scratch + (it & 1) * STAGE1_BUF;
      const int hc = it % n_h;
      const int kh = min(KH, hhi - (hlo + hc * KH));
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
      if (hc == n_h - 1) {  // the last chunk of this column range
        const int w = (it / n_h) * CW + tid;
        if (w < W) {
          float* dst = T1 + (size_t)w * T1_STRIDE;
#pragma unroll
          for (int p = 0; p < NUM_ORIENTATIONS; ++p)
#pragma unroll
            for (int r = 0; r < BM; r += 4)
              *reinterpret_cast<float4*>(dst + p * BM + r) =
                  make_float4(acc[r][p], acc[r + 1][p], acc[r + 2][p], acc[r + 3][p]);
        }
#pragma unroll
        for (int r = 0; r < BM; ++r)
#pragma unroll
          for (int p = 0; p < NUM_ORIENTATIONS; ++p) acc[r][p] = 0.0f;
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // -- 2. out = T1 · ax, each warp on its own groups of 8 columns ----------
  float* axw = scratch + warp * WARP_FLOATS;   // [2][KWW][GW] staged ax rows
  // output rows 16-byte aligned: float4 stores
  const bool vec4 = N % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  auto group_band = [&](int gi, int& lo, int& hi) {
    lo = gi < n_groups ? gband[2 * gi] : W;
    hi = gi < n_groups ? gband[2 * gi + 1] : 0;
  };
  auto stage_rows = [&](float* buf, int gi, int w0, int hi) {
#pragma unroll
    for (int e = lane; e < KWW * GW; e += 32) {
      const int w = w0 + e / GW, n = gi * GW + e % GW;
      const bool ok = w < hi && n < N;
      cp_async4(buf + e, ax + (ok ? (size_t)w * N + n : 0), ok);
    }
  };

  // lane tile: T1 rows rq·4..+4 x group columns cq·4..+4
  const int rq = lane >> 1, cq = lane & 1;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  int gi = warp, w0, hi, cur = 0;  // this step: rows w0.. of group gi's band [.., hi)
  group_band(gi, w0, hi);
  if (gi < n_groups && w0 < hi) stage_rows(axw, gi, w0, hi);
  cp_async_commit();
  while (gi < n_groups) {
    // the step after this one: the group's next chunk, or the next group
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
      const float4 t = *reinterpret_cast<const float4*>(T1 + (size_t)w * T1_STRIDE + rq * 4);
      const float xv[4] = {x.x, x.y, x.z, x.w}, tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(tv[i], xv[j], acc[i][j]);
    }
    if (gi2 != gi) {  // the group is done: out[b, p, m, its columns]
      const int n = gi * GW + cq * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = rq * 4 + i, m = tile_rows[row % BM];
        if (m >= 0 && n < N) {
          float* dst = out + (((size_t)b * NUM_ORIENTATIONS + row / BM) * M + m) * N + n;
          if (vec4 && n + 4 <= N) {
            *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (n + j < N) dst[j] = acc[i][j];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      }
    }
    __syncwarp();
    gi = gi2; hi = hi2; w0 = w02; cur ^= 1;
  }
}

}  // namespace

extern "C" {

// mag, orient: (B, H, W); ayt: (M, H); ax: (W, N); ay_lo, ay_hi: (M) band of
// each row of ayt; ax_lo, ax_hi: (N) band of each column of ax (int32, [lo,
// hi), clamped to the operator); row_order: (M) the rows of M in the order
// the tiles take them (a permutation; entries outside [0, M) are skipped);
// out: (B, 8, M, N). Shared memory grows with W (272 bytes a column); a W
// whose T1 does not fit is refused.
int ks_sift_bin_sample(const float* mag, const float* orient, const float* ayt,
                       const float* ax, const int* ay_lo, const int* ay_hi,
                       const int* ax_lo, const int* ax_hi, const int* row_order,
                       float* out, int B, int H, int W, int M, int N, void* stream) {
  if (B < 1 || H < 1 || W < 1 || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)W * T1_STRIDE + SCRATCH_FLOATS) +
                      sizeof(int) * 2 * ((N + GW - 1) / GW);
  cudaError_t err = cudaFuncSetAttribute(
      sift_bin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, B);
  sift_bin_kernel<<<grid, TPB, smem, (cudaStream_t)stream>>>(
      mag, orient, ayt, ax, ay_lo, ay_hi, ax_lo, ax_hi, row_order, out, H, W, M, N);
  return (int)cudaGetLastError();
}

}  // extern "C"

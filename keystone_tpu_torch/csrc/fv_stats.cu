// Fused Fisher-vector statistics.
//
// Replaces the Pallas TPU kernel keystone_tpu/ops/images/fv_pallas.py:80
// fisher_vector_stats_pallas (body _fv_stats_kernel :36). For each image,
// x is a (d, m) descriptor matrix; per descriptor (row of xᵀ):
//   logits = −½·x²·inv_var + x·proj + const          (k values)
//   q      = softmax(logits); q = q·[q > thresh]; q /= Σq
// and s0 = Σ q, s1 = x qᵀ, s2 = x² qᵀ over the descriptors, each / m.
// The (m, k) posterior never reaches device memory. Partial sums go per
// slab of descriptors, and one thread per (output, image) sums them in slab
// order (fv_reduce_kernel): no atomics, the output is identical from run
// to run.
//
// Two paths, chosen by shape:
//
// d, k <= 64 (the serving shapes), in float32 FMA on the CUDA cores. Per
// descriptor the kernel does about 8·d·k flops (two products for the
// logits, two for s1/s2) against 4·d bytes of input, ≈ 64 flop/byte at
// k = 32, above the float32 ops-per-byte balance (≈ 20): bound by
// operations.
//   pass 0: one block computes the GMM terms of the logits (inv_var, proj,
//     const) into a scratch buffer, as the plain version's gmm_terms does;
//   pass 1: one block per (slab of rows_per_block descriptors, image). Per
//     chunk of R = 128 descriptors the (d × R) x tile is staged in shared
//     memory once, by 4-byte cp.async, double-buffered. Then
//       logits: −½·(x² · inv_var) + x · proj + const, two (R × d) · (d × k)
//         products against inv_var and proj in shared memory, summed
//         apart as the reference sums them (at the serving magnitudes the
//         logits are large, their rounding decides near-ties of the
//         softmax, and one interleaved sum rounds apart from the
//         reference); each thread owns 4 descriptors × k/8 mixtures;
//       softmax, threshold and renormalisation across a descriptor's k
//         values, held by 8 lanes of a warp, by shuffles, and one
//         reciprocal per descriptor and sum; q goes to shared memory;
//       s1, s2: each thread owns 2 rows of d × k/8 mixtures in registers
//         for the whole slab and adds the outer product of its x/x² values
//         and a row of q per descriptor; s0 sums q in registers.
//   pass 2: fv_reduce_kernel.
//
// Any other d and k (VOC's (80, 256), the flagship at vocabulary 256),
// on the tensor cores. Bound by operations: at VOC's chunk of 64 images
// (m = 73,866 each) the four products are 8·m·d·k flops an image, 0.77
// TFLOP for the chunk, 2.3 TFLOP of TF32 in 3xTF32: ≈ 4.7 ms at 495
// TFLOP/s, against ≈ 0.45 ms of bytes (x read once). The passes below form
// the logits three times, so the kernels' own products are twice that
// bound, and mma.sync itself reaches about two thirds of the TF32 peak
// (~320 TFLOP/s on an H100 SXM at 700 W, mma_rate.py); the full rate
// needs wgmma. What held the earlier float32 design: every
// product on the CUDA cores fed from shared memory, the logits formed
// again for each 64-row d tile, padded rows and mixtures doing full work,
// and a per-descriptor logit store in shared memory that bounded k and
// let one block onto an SM. This design:
//   - products in 3xTF32 by mma.sync.m16n8k8 (mma_tf32.cuh): each f32
//     operand split into a TF32 high and low part, hi·hi + hi·lo + lo·hi
//     in f32, which holds the reference's Precision.HIGHEST bars where
//     one TF32 product does not; the two logits products in two
//     accumulators, combined as the reference combines them;
//   - pass 0: the logits' constants, a warp per mixture (fv_const_kernel),
//     and inv_var and proj split once per call into fragment-major order
//     (fv_frag_kernel); where one d tile covers d the passes stage them
//     in shared memory by 16-byte cp.async (pass 1 a pair of m-tiles at a
//     time, pass 2 its k tile's once), else a warp reads them as float4s
//     through L1;
//   - pass 1 (fv_norm_kernel): per descriptor, max and softmax sum in one
//     online sweep over the mixtures, then the thresholded sum in a second
//     sweep that forms the logits again; 3 floats a descriptor to device
//     memory, nothing per mixture on chip, so no bound on k;
//   - pass 2 (fv_stats_kernel): per (slab, k tile of 64, d tile of 128),
//     the k tile's logits formed once per chunk, q kept in registers as
//     the A fragments of s1ᵀ and s2ᵀ (no shared-memory round trip); one d
//     tile covers d <= 128; m-tiles and k-steps past d and k are skipped,
//     not fed zeros;
//   - x staged by cp.async in 16-byte copies where m % 4 == 0 and x is
//     16-byte aligned, 8-byte where m is even, else 4-byte (VOC's m =
//     73,866 takes 8, the flagship's 13,165 takes 4); pass 2
//     double-buffers across chunks where one d tile covers d. No TMA: x's
//     row stride is not 16-byte aligned at the main path's m;
//   - slabs sized by the wrapper so that one image still fills the card.

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "mma_tf32.cuh"

namespace {

constexpr int TPB = 256;
constexpr int R = 128;              // descriptors per staged chunk
constexpr int DMAX = 64;            // largest d the thread tiles cover
constexpr int XS_STRIDE = R + 4;    // x tile row stride: float4-aligned, conflict-free
constexpr int WARPS = TPB / 32;
constexpr int ROW_GROUPS = WARPS * 4;  // logits: 4 descriptors per lane group of 8

static_assert(WARPS * 16 == R, "logits: each warp takes 16 descriptors");
static_assert(DMAX / 2 * 8 == TPB, "s1/s2: 32 row pairs x 8 mixture groups");

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int KMAX>
constexpr size_t smem_floats() {
  // x tiles [2][DMAX][XS_STRIDE], ivs and pjs [DMAX][KMAX], cs [KMAX], qs [R][KMAX]
  return (size_t)2 * DMAX * XS_STRIDE + 2 * DMAX * KMAX + KMAX + R * KMAX;
}

template <int KMAX>
__global__ void __launch_bounds__(TPB, 2)
fv_partial_kernel(const float* __restrict__ x, const float* __restrict__ inv_var,
                  const float* __restrict__ proj, const float* __restrict__ cst,
                  float thresh, float* __restrict__ partial, int d, int m, int k,
                  int rows_per_block) {
  constexpr int CT = KMAX / 8;  // mixtures per thread
  static_assert(CT % 4 == 0, "float4 reads of mixtures");
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [2][DMAX][XS_STRIDE]
  float* ivs = xs + 2 * DMAX * XS_STRIDE;    // [DMAX][KMAX]: inv_var, 0 past d, k
  float* pjs = ivs + DMAX * KMAX;            // [DMAX][KMAX]: proj, 0 past d, k
  float* cs = pjs + DMAX * KMAX;             // [KMAX]: const, −inf past k
  float* qs = cs + KMAX;                     // [R][KMAX]: posteriors of a chunk

  const int blk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xb = x + (size_t)b * d * m;
  const int n_out = (1 + 2 * d) * k;

  for (int i = tid; i < DMAX * KMAX; i += TPB) {
    const int dd = i / KMAX, c = i % KMAX;
    const bool ok = dd < d && c < k;
    ivs[i] = ok ? inv_var[dd * k + c] : 0.0f;
    pjs[i] = ok ? proj[dd * k + c] : 0.0f;
  }
  for (int c = tid; c < KMAX; c += TPB) cs[c] = c < k ? cst[c] : -INFINITY;

  const int row_begin = blk * rows_per_block;
  const int row_end = min(m, row_begin + rows_per_block);
  const int n_chunks = (row_end - row_begin + R - 1) / R;
  auto stage = [&](int c) {
    float* dst = xs + (c & 1) * DMAX * XS_STRIDE;
    const int base = row_begin + c * R;
    for (int e = tid; e < DMAX * R; e += TPB) {
      const int dd = e / R, i = e % R, row = base + i;
      const bool ok = dd < d && row < row_end;
      cp_async4(dst + dd * XS_STRIDE + i, xb + (ok ? (size_t)dd * m + row : 0), ok);
    }
  };

  // logits tile: descriptors i0..i0+3 of the chunk, mixtures kl·CT..+CT
  const int rg = lane >> 3, kl = lane & 7;
  const int i0 = warp * 16 + rg * 4;
  // s1/s2 tile: x rows 2g, 2g+1, mixtures cg·CT..+CT
  const int g = tid >> 3, cg = tid & 7;
  float s1[2][CT], s2[2][CT], s0[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    s0[c] = 0.0f;
    s1[0][c] = s1[1][c] = s2[0][c] = s2[1][c] = 0.0f;
  }

  stage(0);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) stage(ch + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* xt = xs + (ch & 1) * DMAX * XS_STRIDE;
    const int rows = min(R, row_end - (row_begin + ch * R));

    // -- logits, softmax, threshold: q of 4 descriptors x CT mixtures -----
    {
      // a = x²·inv_var and b = x·proj as two sums, then −½·a + b + const:
      // the reference's (and the plain version's) order of operations
      float a[4][CT], l[4][CT];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CT; ++c) { a[r][c] = 0.0f; l[r][c] = 0.0f; }
      for (int dd = 0; dd < d; ++dd) {
        const float4 xv = *reinterpret_cast<const float4*>(xt + dd * XS_STRIDE + i0);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
        float iv[CT], pj[CT];
#pragma unroll
        for (int c = 0; c < CT; c += 4) {
          const float4 u = *reinterpret_cast<const float4*>(ivs + dd * KMAX + kl * CT + c);
          const float4 p = *reinterpret_cast<const float4*>(pjs + dd * KMAX + kl * CT + c);
          iv[c] = u.x; iv[c + 1] = u.y; iv[c + 2] = u.z; iv[c + 3] = u.w;
          pj[c] = p.x; pj[c + 1] = p.y; pj[c + 2] = p.z; pj[c + 3] = p.w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x2 = xr[r] * xr[r];
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            a[r][c] = fmaf(x2, iv[c], a[r][c]);
            l[r][c] = fmaf(xr[r], pj[c], l[r][c]);
          }
        }
      }
      // softmax, threshold and renormalisation of the 4 descriptors, each
      // step over all 4 at once so their shuffle chains overlap
      float mx[4], sum[4], sum2[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        mx[r] = -INFINITY;
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          l[r][c] = -0.5f * a[r][c] + l[r][c] + cs[kl * CT + c];
          mx[r] = fmaxf(mx[r], l[r][c]);
        }
      }
#pragma unroll
      for (int s = 1; s < 8; s <<= 1)
#pragma unroll
        for (int r = 0; r < 4; ++r) mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], s));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sum[r] = 0.0f;
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          l[r][c] = expf(l[r][c] - mx[r]);
          sum[r] += l[r][c];
        }
      }
#pragma unroll
      for (int s = 1; s < 8; s <<= 1)
#pragma unroll
        for (int r = 0; r < 4; ++r) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], s);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float inv_sum = 1.0f / sum[r];
        sum2[r] = 0.0f;
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const float q = l[r][c] * inv_sum;
          l[r][c] = q > thresh ? q : 0.0f;
          sum2[r] += l[r][c];
        }
      }
#pragma unroll
      for (int s = 1; s < 8; s <<= 1)
#pragma unroll
        for (int r = 0; r < 4; ++r) sum2[r] += __shfl_xor_sync(0xffffffffu, sum2[r], s);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool valid = i0 + r < rows;
        const float inv_sum2 = 1.0f / sum2[r];
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          l[r][c] = valid ? l[r][c] * inv_sum2 : 0.0f;
          s0[c] += l[r][c];
        }
#pragma unroll
        for (int c = 0; c < CT; c += 4)
          *reinterpret_cast<float4*>(qs + (i0 + r) * KMAX + kl * CT + c) =
              make_float4(l[r][c], l[r][c + 1], l[r][c + 2], l[r][c + 3]);
      }
    }
    __syncthreads();

    // -- s1 += x qᵀ, s2 += x² qᵀ over this chunk's descriptors -------------
    {
      const float* x0p = xt + (2 * g) * XS_STRIDE;
      const float* x1p = x0p + XS_STRIDE;
      for (int i = 0; i < rows; ++i) {
        const float x0 = x0p[i], x1 = x1p[i];
        const float a0 = x0 * x0, a1 = x1 * x1;
        float q[CT];
#pragma unroll
        for (int c = 0; c < CT; c += 4) {
          const float4 v = *reinterpret_cast<const float4*>(qs + i * KMAX + cg * CT + c);
          q[c] = v.x; q[c + 1] = v.y; q[c + 2] = v.z; q[c + 3] = v.w;
        }
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          s1[0][c] = fmaf(x0, q[c], s1[0][c]);
          s1[1][c] = fmaf(x1, q[c], s1[1][c]);
          s2[0][c] = fmaf(a0, q[c], s2[0][c]);
          s2[1][c] = fmaf(a1, q[c], s2[1][c]);
        }
      }
    }
    __syncthreads();
  }

  // -- this slab's partial sums ---------------------------------------------
  float* dst = partial + ((size_t)b * gridDim.x + blk) * n_out;
  float* red = qs;  // [ROW_GROUPS][KMAX]: s0 of each logits lane group
#pragma unroll
  for (int c = 0; c < CT; ++c) red[(warp * 4 + rg) * KMAX + kl * CT + c] = s0[c];
  __syncthreads();
  for (int c = tid; c < k; c += TPB) {
    float s = 0.0f;
    for (int i = 0; i < ROW_GROUPS; ++i) s += red[i * KMAX + c];
    dst[c] = s;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int dd = 2 * g + j;
    if (dd >= d) continue;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int cc = cg * CT + c;
      if (cc < k) {
        dst[(1 + dd) * k + cc] = s1[j][c];
        dst[(1 + d + dd) * k + cc] = s2[j][c];
      }
    }
  }
}

// terms = [inv_var (d, k), proj (d, k), const (k)] of the logits: the
// plain version's gmm_terms, one block
__global__ void __launch_bounds__(TPB)
fv_terms_kernel(const float* __restrict__ means, const float* __restrict__ variances,
                const float* __restrict__ weights, float* __restrict__ terms, int d,
                int k) {
  float* inv_var = terms;
  float* proj = terms + d * k;
  for (int i = threadIdx.x; i < d * k; i += TPB) {
    inv_var[i] = 1.0f / variances[i];
    proj[i] = means[i] / variances[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += TPB) {
    float lv = 0.0f, mp = 0.0f;
    for (int dd = 0; dd < d; ++dd) {
      lv += logf(6.2831855f * variances[dd * k + c]);
      mp += means[dd * k + c] * proj[dd * k + c];
    }
    terms[2 * d * k + c] = logf(weights[c]) - 0.5f * lv - 0.5f * mp;
  }
}

// out[b] = (Σ over slabs, in slab order, of partial[b, slab]) / m
__global__ void __launch_bounds__(TPB)
fv_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                 int n_out, int n_blocks, float inv_m) {
  const int b = blockIdx.y;
  const int o = blockIdx.x * TPB + threadIdx.x;
  if (o >= n_out) return;
  const float* src = partial + (size_t)b * n_blocks * n_out + o;
  float s = 0.0f;
  for (int i = 0; i < n_blocks; ++i) s += src[(size_t)i * n_out];
  out[(size_t)b * n_out + o] = s * inv_m;
}

// -- any d and k: the tiled path, on the tensor cores --------------------------

constexpr int DC = 128;          // rows of d staged at a time (one d tile up to 128)
constexpr int NRM_MT = 2, NRM_NT = 2;  // a norm warp's tile: 32 mixtures x 16 descriptors
constexpr int NRM_R = 8 * NRM_NT * 8;  // descriptors of a norm block: 8 warps x 16
constexpr int ST_R = 64;         // descriptors per chunk of a statistics block: 2 warps x 32
constexpr int ST_KT = 64;        // mixtures of a statistics block: 4 warps x 16
constexpr int FRAG_F4 = 4 * 32;  // float4s of one (16 mixtures, 8 rows of d) fragment tile
// x tile row strides ≡ 8 (mod 32): a B fragment's 32 lanes hit 32 banks
constexpr int NRM_XS = NRM_R + 8;
constexpr int ST_XS = ST_R + 8;

__host__ __device__ constexpr int round8(int v) { return (v + 7) & ~7; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Where the fragment-major terms start in the terms scratch (floats, a
// multiple of 4), and how many floats they take.
__host__ __device__ constexpr size_t frag_offset(int d, int k) {
  return ((size_t)(2 * d + 1) * k + 3) & ~(size_t)3;
}
__host__ __device__ constexpr size_t frag_floats(int d, int k) {
  return (size_t)((k + 15) / 16) * ((d + 7) / 8) * FRAG_F4 * 4;
}

// BYTES (4, 8 or 16) bytes into shared memory, of which the first src_bytes
// are read and the rest zero-filled; dst and src BYTES-aligned, src a
// global address even when nothing is read.
template <int BYTES>
__device__ __forceinline__ void cp_async_bytes(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(s), "l"(src), "n"(BYTES), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x rows dc0 .. dc0 + nd of d (zero from nd up to a multiple of 8) and
// descriptors row0 .. row0 + rows (zero up to r) into xs[row][stride], in
// copies of BYTES. Every thread of the block calls it.
template <int BYTES>
__device__ __forceinline__ void stage_x_by(float* xs, int stride, int r, const float* xb, int m,
                                           int dc0, int nd, int row0, int rows) {
  constexpr int V = BYTES / 4;
  const int per_row = r / V, n = round8(nd) * per_row;
  const float* base = xb + (size_t)dc0 * m + row0;
  for (int e = threadIdx.x; e < n; e += TPB) {
    const int dd = e / per_row, i = (e % per_row) * V;
    const int valid = dd < nd ? max(0, min(V, rows - i)) : 0;
    cp_async_bytes<BYTES>(xs + dd * stride + i, valid ? base + (size_t)dd * m + i : xb, 4 * valid);
  }
}
__device__ __forceinline__ void stage_x(float* xs, int stride, int r, const float* xb, int m,
                                        int dc0, int nd, int row0, int rows, int copy_bytes) {
  if (copy_bytes == 16)
    stage_x_by<16>(xs, stride, r, xb, m, dc0, nd, row0, rows);
  else if (copy_bytes == 8)
    stage_x_by<8>(xs, stride, r, xb, m, dc0, nd, row0, rows);
  else
    stage_x_by<4>(xs, stride, r, xb, m, dc0, nd, row0, rows);
}

// The logits' GMM terms inv_var = 1 / var and proj = mean / var as the A
// fragments of mma (mixtures x rows of d), split into TF32 high and low
// parts once per call: tf[((mt · n_ks + ks) · 4 + arr) · 32 + lane] holds
// lane's a0..a3 for mixtures 16·mt .. and rows 8·ks .. of d, arr = inv_var
// hi, inv_var lo, proj hi, proj lo; 0 past d and k. A warp reads a
// fragment as 4 coalesced float4 loads, from shared memory where the
// passes stage the fragments.
__global__ void __launch_bounds__(TPB)
fv_frag_kernel(const float* __restrict__ means, const float* __restrict__ variances,
               float4* __restrict__ tf, int d, int k) {
  const int n_ks = (d + 7) / 8;
  const int total = ((k + 15) / 16) * n_ks * FRAG_F4;
  for (int e = blockIdx.x * TPB + threadIdx.x; e < total; e += gridDim.x * TPB) {
    const int lane = e & 31, arr = (e >> 5) & 3, tile = e >> 7;
    const int ks = tile % n_ks, mt = tile / n_ks;
    const int g = lane >> 2, t = lane & 3;
    float v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = mt * 16 + g + (r & 1) * 8, dd = ks * 8 + t + (r >> 1) * 4;
      const size_t i = (size_t)dd * k + c;
      const bool ok = c < k && dd < d;
      uint32_t hi, lo;
      split_tf32(!ok ? 0.0f : arr < 2 ? 1.0f / variances[i] : means[i] / variances[i], hi, lo);
      v[r] = __uint_as_float(arr & 1 ? lo : hi);
    }
    tf[e] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// const[c] = log w_c − ½·Σ_d log(2π·var) − ½·Σ_d mean·proj, the last term
// of the logits: one warp per mixture, its lanes over d, summed by a fixed
// shuffle tree (fv_terms_kernel's single block, a mixture a thread, took
// about a tenth of one VOC image's call on the H100).
__global__ void __launch_bounds__(TPB)
fv_const_kernel(const float* __restrict__ means, const float* __restrict__ variances,
                const float* __restrict__ weights, float* __restrict__ cst, int d, int k) {
  const int c = blockIdx.x * (TPB / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (c >= k) return;
  float lv = 0.0f, mp = 0.0f;
  for (int dd = lane; dd < d; dd += 32) {
    const float var = variances[(size_t)dd * k + c], mu = means[(size_t)dd * k + c];
    lv += logf(6.2831855f * var);
    mp += mu * (mu / var);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    lv += __shfl_xor_sync(0xffffffffu, lv, s);
    mp += __shfl_xor_sync(0xffffffffu, mp, s);
  }
  if (lane == 0) cst[c] = logf(weights[c]) - 0.5f * lv - 0.5f * mp;
}

// −½·(x²·inv_var) + x·proj + const, in the reference's order. Both passes
// form every logit by this one expression from the same products, and the
// posterior by the next, so they agree bit for bit on which posteriors pass
// the threshold.
__device__ __forceinline__ float logit(float a, float b, float c) {
  return __fadd_rn(__fmaf_rn(-0.5f, a, b), c);
}
__device__ __forceinline__ float posterior(float l, float mx, float inv_sum) {
  return __fmul_rn(expf(__fsub_rn(l, mx)), inv_sum);
}

// a += x² · inv_var and b += x · proj (3xTF32, two accumulators) for MT
// m-tiles of 16 mixtures from m-tile mt0 (the first `live` of them hold a
// mixture < k) by NT n-tiles of 8 descriptors from column col0 of the x
// tile, over the k-steps ks0 .. ks1 of d (8 rows each; row 8·ks of d is row
// 8·(ks − ks_base) of the tile). a and b are C fragments: rows mixtures,
// columns descriptors. The fragments tf are in shared memory (SMEM_TF) or
// in device memory, read through L1. Each x value is split where it is
// loaded: splitting the tile once into shared-memory planes measured
// slower on the H100.
template <int MT, int NT, bool SMEM_TF = false>
__device__ __forceinline__ void logits_mma(float (&a)[MT][NT][4], float (&b)[MT][NT][4],
                                           const float* __restrict__ xs, int xs_stride, int col0,
                                           int ks0, int ks1, int ks_base,
                                           const float4* __restrict__ tf, int n_ks, int mt0,
                                           int live, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int ks = ks0; ks < ks1; ++ks) {
    // B fragments: b0 = x[row t][descriptor g], b1 = row t + 4
    const float* xr = xs + ((ks - ks_base) * 8 + t) * xs_stride + col0 + g;
    uint32_t xh[NT][2], xl[NT][2], x2h[NT][2], x2l[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = xr[r * 4 * xs_stride + nt * 8];
        split_tf32(v, xh[nt][r], xl[nt][r]);
        split_tf32(__fmul_rn(v, v), x2h[nt][r], x2l[nt][r]);
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt < live) {
        const float4* f = tf + ((size_t)(mt0 + mt) * n_ks + ks) * FRAG_F4 + lane;
        float4 u, v, p, q;
        if constexpr (SMEM_TF) {
          u = f[0]; v = f[32]; p = f[64]; q = f[96];
        } else {
          u = __ldg(f); v = __ldg(f + 32); p = __ldg(f + 64); q = __ldg(f + 96);
        }
        const uint32_t ivh[4] = {__float_as_uint(u.x), __float_as_uint(u.y),
                                 __float_as_uint(u.z), __float_as_uint(u.w)};
        const uint32_t ivl[4] = {__float_as_uint(v.x), __float_as_uint(v.y),
                                 __float_as_uint(v.z), __float_as_uint(v.w)};
        const uint32_t pjh[4] = {__float_as_uint(p.x), __float_as_uint(p.y),
                                 __float_as_uint(p.z), __float_as_uint(p.w)};
        const uint32_t pjl[4] = {__float_as_uint(q.x), __float_as_uint(q.y),
                                 __float_as_uint(q.z), __float_as_uint(q.w)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_3xtf32(a[mt][nt], ivh, ivl, x2h[nt], x2l[nt]);
          mma_3xtf32(b[mt][nt], pjh, pjl, xh[nt], xl[nt]);
        }
      }
    }
  }
}

// Pass 1: norms[b, row] = (max logit, 1 / softmax sum, 1 / thresholded sum)
// over all k. A block takes 128 descriptors, a warp 16 of them, and sweeps
// the mixtures 32 at a time, twice: first a running max and softmax sum per
// descriptor (the sum rescaled when the max rises), then the thresholded
// sum, forming the logits again. Nothing is kept per mixture, so k has no
// bound. A thread's 4 columns (descriptors) of a C fragment each gather
// their sums over the rows it holds; the 8 lanes of a column combine them
// at the end of a sweep. Two blocks share an SM (at most 128 registers a
// thread): 16 warps hide more latency than 8 warps of twice the tile.
__global__ void __launch_bounds__(TPB, 2)
fv_norm_kernel(const float* __restrict__ x, const float4* __restrict__ tf,
               const float* __restrict__ cst, float thresh, float* __restrict__ norms, int d,
               int m, int k, int copy_bytes) {
  constexpr int MT = NRM_MT, NT = NRM_NT;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // [round8(min(d, DC))][NRM_XS]
  const int b = blockIdx.y, row0 = blockIdx.x * NRM_R, rows = min(NRM_R, m - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, col0 = warp * NT * 8;
  const float* xb = x + (size_t)b * d * m;
  const int n_ks = (d + 7) / 8, n_mt = (k + 15) / 16, n_dc = (d + DC - 1) / DC;
  // where one d tile covers d, each pair of m-tiles' fragments is staged
  // in shared memory, read by all 8 warps (from L1 and L2 the pair's
  // fragments of every k tile came through again for each block)
  float4* tfs = reinterpret_cast<float4*>(smem + round8(min(d, DC)) * NRM_XS);

  float mx[NT][2], sum[NT][2], sum2[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[nt][e] = -FLT_MAX;  // finite: exp(−inf − max) is 0, never NaN
      sum[nt][e] = sum2[nt][e] = 0.0f;
    }
  if (n_dc == 1) {
    stage_x(xs, NRM_XS, NRM_R, xb, m, 0, d, row0, rows, copy_bytes);
    cp_async_commit();
    cp_async_wait0();
    __syncthreads();
  }
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int mt0 = 0; mt0 < n_mt; mt0 += MT) {
      const int live = min(MT, n_mt - mt0);
      float a[MT][NT][4], l[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) a[mt][nt][i] = l[mt][nt][i] = 0.0f;
      if (n_dc == 1) {
        __syncthreads();  // every warp is done with the last pair's fragments
        const float4* src = tf + (size_t)mt0 * n_ks * FRAG_F4;
        for (int e = threadIdx.x; e < live * n_ks * FRAG_F4; e += TPB)
          cp_async_bytes<16>(reinterpret_cast<float*>(tfs + e),
                             reinterpret_cast<const float*>(src + e), 16);
        cp_async_commit();
        cp_async_wait0();
        __syncthreads();
        logits_mma<MT, NT, true>(a, l, xs, NRM_XS, col0, 0, n_ks, 0, tfs, n_ks, 0, live, lane);
      } else {
        for (int j = 0; j < n_dc; ++j) {
          __syncthreads();
          stage_x(xs, NRM_XS, NRM_R, xb, m, j * DC, min(DC, d - j * DC), row0, rows, copy_bytes);
          cp_async_commit();
          cp_async_wait0();
          __syncthreads();
          logits_mma<MT, NT>(a, l, xs, NRM_XS, col0, j * 16, min(n_ks, j * 16 + 16), j * 16, tf,
                             n_ks, mt0, live, lane);
        }
      }
      // element i = 2h + e of a C fragment: mixture g + 8h, descriptor 2t + e
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = (mt0 + mt) * 16 + g + 8 * h;
          const bool ok = mt < live && c < k;
          const float cc = ok ? cst[c] : 0.0f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              l[mt][nt][2 * h + e] =
                  ok ? logit(a[mt][nt][2 * h + e], l[mt][nt][2 * h + e], cc) : -INFINITY;
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (sweep == 0) {
            float hi = mx[nt][e];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) hi = fmaxf(hi, l[mt][nt][2 * h + e]);
            if (hi > mx[nt][e]) {
              sum[nt][e] = __fmul_rn(sum[nt][e], expf(__fsub_rn(mx[nt][e], hi)));
              mx[nt][e] = hi;
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                sum[nt][e] = __fadd_rn(sum[nt][e], expf(__fsub_rn(l[mt][nt][2 * h + e], mx[nt][e])));
          } else {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float q = posterior(l[mt][nt][2 * h + e], mx[nt][e], sum[nt][e]);
                sum2[nt][e] = __fadd_rn(sum2[nt][e], q > thresh ? q : 0.0f);
              }
          }
        }
    }
    if (sweep == 0) {
      // combine the 8 lanes of each column (lanes t, t + 4, ..); the
      // combination is symmetric in its two sides, so all 8 end equal;
      // then sum holds 1 / sum for the second sweep
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int s = 4; s < 32; s <<= 1) {
            const float om = __shfl_xor_sync(0xffffffffu, mx[nt][e], s);
            const float os = __shfl_xor_sync(0xffffffffu, sum[nt][e], s);
            const float nm = fmaxf(mx[nt][e], om);
            sum[nt][e] = __fadd_rn(__fmul_rn(sum[nt][e], expf(__fsub_rn(mx[nt][e], nm))),
                                   __fmul_rn(os, expf(__fsub_rn(om, nm))));
            mx[nt][e] = nm;
          }
          sum[nt][e] = 1.0f / sum[nt][e];
        }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int s = 4; s < 32; s <<= 1)
        sum2[nt][e] = __fadd_rn(sum2[nt][e], __shfl_xor_sync(0xffffffffu, sum2[nt][e], s));
      const int col = col0 + nt * 8 + 2 * t + e;
      if (g == 0 && col < rows) {
        float* dst = norms + ((size_t)b * m + row0 + col) * 3;
        dst[0] = mx[nt][e];
        dst[1] = sum[nt][e];
        dst[2] = 1.0f / sum2[nt][e];
      }
    }
}

// Pass 2: one block per (slab of rows_per_block descriptors, k tile of 64
// mixtures, d tile of 128 rows; image). Warp (wm, wn) takes mixtures
// 16·wm .. of the k tile and descriptors 32·wn .. of each chunk of 64: it
// forms their logits once on the tensor cores, q from them and pass 1's
// three numbers, and keeps q in registers as the A fragments of
// s1ᵀ += q · x and s2ᵀ += q · x² over the d tile. (C fragment columns 2t and
// 2t + 1 serve as A fragment columns t and t + 4, so the B fragments take
// descriptor 2t in row t and 2t + 1 in row t + 4: one float2 load.) The
// chunks' x and norms are staged by cp.async, double-buffered where one d
// tile covers d; past 128 rows the logits walk d in staged chunks and the
// d tile is staged again for s1/s2. The two warps of a mixture group add
// their sums at the end of the slab; the slab's partial sums go to
// `partial` once.
template <int NTD>
__global__ void __launch_bounds__(TPB, 1)
fv_stats_kernel(const float* __restrict__ x, const float4* __restrict__ tf,
                const float* __restrict__ cst, const float* __restrict__ norms, float thresh,
                float* __restrict__ partial, int d, int m, int k, int rows_per_block, int n_kd,
                int copy_bytes) {
  constexpr int NT = 4, NACC = NTD * 8 + 2;
  extern __shared__ __align__(16) float smem[];
  const int n_dc = (d + DC - 1) / DC, n_ks = (d + 7) / 8;
  const int drows = round8(min(d, DC)), nbuf = n_dc == 1 ? 2 : 1;
  float* xs = smem;                       // [nbuf][drows][ST_XS]
  float* ns = xs + nbuf * drows * ST_XS;  // [nbuf][ST_R][3]
  // where one d tile covers d, the k tile's fragments, staged once
  float4* tfs = reinterpret_cast<float4*>(ns + nbuf * ST_R * 3);
  const int slab = blockIdx.x / n_kd, kd = blockIdx.x % n_kd, b = blockIdx.y;
  const int n_kt = (k + ST_KT - 1) / ST_KT, kt = kd % n_kt, dt = kd / n_kt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp & 3, wn = warp >> 2, col0 = wn * 32;
  const int mt = kt * 4 + wm;  // this warp's mixtures: 16·mt ..
  const bool live = mt * 16 < k;
  const int dt0 = dt * DC, n_td = (min(DC, d - dt0) + 7) / 8;
  const float* xb = x + (size_t)b * d * m;
  const float* nb = norms + (size_t)b * m * 3;
  const int row_begin = slab * rows_per_block, row_end = min(m, row_begin + rows_per_block);
  const int n_ch = (row_end - row_begin + ST_R - 1) / ST_R;

  float cc[2];
  bool kk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = mt * 16 + g + 8 * h;
    kk[h] = c < k;
    cc[h] = kk[h] ? cst[c] : 0.0f;
  }
  float s1[NTD][4], s2[NTD][4], s0[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < NTD; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s1[n][i] = s2[n][i] = 0.0f;

  auto stage = [&](int ch, int buf, int dc0, int nd, bool with_norms) {
    const int row0 = row_begin + ch * ST_R, rows = min(ST_R, row_end - row0);
    stage_x(xs + buf * drows * ST_XS, ST_XS, ST_R, xb, m, dc0, nd, row0, rows, copy_bytes);
    if (with_norms)
      for (int e = tid; e < ST_R * 3; e += TPB) {
        const bool ok = e < rows * 3;
        cp_async4(ns + buf * ST_R * 3 + e, nb + (ok ? (size_t)row0 * 3 + e : 0), ok);
      }
  };

  if (n_dc == 1) {
    const int n4 = min(4, (k + 15) / 16 - kt * 4) * n_ks * FRAG_F4;
    const float4* src = tf + (size_t)kt * 4 * n_ks * FRAG_F4;
    for (int e = tid; e < n4; e += TPB)
      cp_async_bytes<16>(reinterpret_cast<float*>(tfs + e), reinterpret_cast<const float*>(src + e),
                         16);
    stage(0, 0, 0, d, true);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_ch; ++ch) {
    const int rows = min(ST_R, row_end - (row_begin + ch * ST_R));
    float a[1][NT][4], q[1][NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[0][nt][i] = q[0][nt][i] = 0.0f;
    const float* xt = xs;
    const float* nt3 = ns;
    if (n_dc == 1) {
      if (ch + 1 < n_ch) stage(ch + 1, (ch + 1) & 1, 0, d, true);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();
      xt = xs + (ch & 1) * drows * ST_XS;
      nt3 = ns + (ch & 1) * ST_R * 3;
      if (live) logits_mma<1, NT, true>(a, q, xt, ST_XS, col0, 0, n_ks, 0, tfs, n_ks, wm, 1, lane);
    } else {
      for (int j = 0; j < n_dc; ++j) {
        __syncthreads();
        stage(ch, 0, j * DC, min(DC, d - j * DC), j == 0);
        cp_async_commit();
        cp_async_wait0();
        __syncthreads();
        if (live)
          logits_mma<1, NT>(a, q, xs, ST_XS, col0, j * 16, min(n_ks, j * 16 + 16), j * 16, tf,
                            n_ks, mt, 1, lane);
      }
      if (dt != n_dc - 1) {  // xs holds the last d chunk: stage this d tile's rows
        __syncthreads();
        stage(ch, 0, dt0, min(DC, d - dt0), false);
        cp_async_commit();
        cp_async_wait0();
        __syncthreads();
      }
    }
    if (live) {
      // q: the thresholded, renormalised posterior; 0 past k and past the chunk
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + nt * 8 + 2 * t + e;
          const bool ok = col < rows;
          const float mxv = nt3[col * 3], is = nt3[col * 3 + 1], is2 = nt3[col * 3 + 2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 2 * h + e;
            const float p = posterior(logit(a[0][nt][i], q[0][nt][i], cc[h]), mxv, is);
            q[0][nt][i] = ok && kk[h] && p > thresh ? __fmul_rn(p, is2) : 0.0f;
            s0[h] += q[0][nt][i];
          }
        }
      // s1ᵀ += q · x, s2ᵀ += q · x² over this warp's 32 descriptors of the chunk
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t qh[4], ql[4];
        split_tf32(q[0][j][0], qh[0], ql[0]);  // a0 (g, t)         <- c0 (g, 2t)
        split_tf32(q[0][j][2], qh[1], ql[1]);  // a1 (g + 8, t)     <- c2 (g + 8, 2t)
        split_tf32(q[0][j][1], qh[2], ql[2]);  // a2 (g, t + 4)     <- c1 (g, 2t + 1)
        split_tf32(q[0][j][3], qh[3], ql[3]);  // a3 (g + 8, t + 4) <- c3 (g + 8, 2t + 1)
        const int at = g * ST_XS + col0 + j * 8 + 2 * t;
#pragma unroll
        for (int n = 0; n < NTD; ++n) {
          if (n < n_td) {
            uint32_t bh[2], bl[2], b2h[2], b2l[2];
            const float2 v = *reinterpret_cast<const float2*>(xt + at + n * 8 * ST_XS);
            split_tf32(v.x, bh[0], bl[0]);
            split_tf32(v.y, bh[1], bl[1]);
            split_tf32(__fmul_rn(v.x, v.x), b2h[0], b2l[0]);
            split_tf32(__fmul_rn(v.y, v.y), b2h[1], b2l[1]);
            mma_3xtf32(s1[n], qh, ql, bh, bl);
            mma_3xtf32(s2[n], qh, ql, b2h, b2l);
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait0();

  // wn = 1 hands its sums to wn = 0 of its mixture group, which writes them
  float* red = smem;  // [4][NACC][32]
  float* mine = red + wm * NACC * 32 + lane;
  if (wn == 1 && live) {
#pragma unroll
    for (int n = 0; n < NTD; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mine[(n * 8 + i) * 32] = s1[n][i];
        mine[(n * 8 + 4 + i) * 32] = s2[n][i];
      }
    mine[(NTD * 8) * 32] = s0[0];
    mine[(NTD * 8 + 1) * 32] = s0[1];
  }
  __syncthreads();
  if (wn != 0 || !live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s0[h] += mine[(NTD * 8 + h) * 32];
    s0[h] += __shfl_xor_sync(0xffffffffu, s0[h], 1);
    s0[h] += __shfl_xor_sync(0xffffffffu, s0[h], 2);
  }
  const size_t n_out = (size_t)(1 + 2 * d) * k;
  float* dst = partial + ((size_t)b * (gridDim.x / n_kd) + slab) * n_out;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (dt == 0 && t == 0 && kk[h]) dst[mt * 16 + g + 8 * h] = s0[h];
  // s1ᵀ element i of a C fragment: mixture g + 8·(i / 2), row 2t + i % 2 of the n-tile
#pragma unroll
  for (int n = 0; n < NTD; ++n) {
    if (n >= n_td) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = mt * 16 + g + 8 * (i >> 1), dd = dt0 + n * 8 + 2 * t + (i & 1);
      if (c < k && dd < d) {
        dst[(size_t)(1 + dd) * k + c] = s1[n][i] + mine[(n * 8 + i) * 32];
        dst[(size_t)(1 + d + dd) * k + c] = s2[n][i] + mine[(n * 8 + 4 + i) * 32];
      }
    }
  }
}

template <int NTD>
cudaError_t launch_stats(const float* x, const float4* tf, const float* cst, const float* norms,
                         float thresh, float* partial, int B, int d, int m, int k,
                         int rows_per_block, int n_blocks, int n_kd, int copy_bytes,
                         cudaStream_t stream) {
  const int drows = round8(imin(d, DC)), nbuf = (d + DC - 1) / DC == 1 ? 2 : 1;
  const size_t tiles = (size_t)nbuf * (drows * ST_XS + ST_R * 3) +
                       (nbuf == 2 ? (size_t)4 * ((d + 7) / 8) * FRAG_F4 * 4 : 0);
  const size_t red = (size_t)4 * (NTD * 8 + 2) * 32;
  const size_t smem = sizeof(float) * (tiles > red ? tiles : red);
  cudaError_t err = cudaFuncSetAttribute(
      fv_stats_kernel<NTD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fv_stats_kernel<NTD><<<dim3(n_blocks * n_kd, B), TPB, smem, stream>>>(
      x, tf, cst, norms, thresh, partial, d, m, k, rows_per_block, n_kd, copy_bytes);
  return cudaGetLastError();
}

// The tiled path: the logits' constants and fragment-major terms, pass 1
// (norms), pass 2 (partial)
cudaError_t launch_tiled(const float* x, const float* means, const float* variances,
                         const float* weights, float* terms, float thresh, float* norms,
                         float* partial, int B, int d, int m, int k, int rows_per_block,
                         int n_blocks, cudaStream_t stream) {
  float* cst = terms + 2 * (size_t)d * k;
  float4* tf = reinterpret_cast<float4*>(terms + frag_offset(d, k));
  const int n_frag = (int)(frag_floats(d, k) / 4);
  fv_const_kernel<<<(k + TPB / 32 - 1) / (TPB / 32), TPB, 0, stream>>>(means, variances, weights,
                                                                       cst, d, k);
  fv_frag_kernel<<<imin((n_frag + TPB - 1) / TPB, 1024), TPB, 0, stream>>>(means, variances, tf,
                                                                          d, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 16-byte copies where x's rows (4·m bytes apart) and base allow, else 8, else 4
  const uintptr_t p = reinterpret_cast<uintptr_t>(x);
  const int copy_bytes = m % 4 == 0 && p % 16 == 0 ? 16 : m % 2 == 0 && p % 8 == 0 ? 8 : 4;
  const size_t nsmem = sizeof(float) * round8(imin(d, DC)) * NRM_XS +
                       (d <= DC ? sizeof(float4) * NRM_MT * ((d + 7) / 8) * FRAG_F4 : 0);
  err = cudaFuncSetAttribute(fv_norm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)nsmem);
  if (err != cudaSuccess) return err;
  fv_norm_kernel<<<dim3((m + NRM_R - 1) / NRM_R, B), TPB, nsmem, stream>>>(
      x, tf, cst, thresh, norms, d, m, k, copy_bytes);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n_kd = ((k + ST_KT - 1) / ST_KT) * ((d + DC - 1) / DC);
  const int dt_rows = imin(d, DC);
  return dt_rows <= 64 ? launch_stats<8>(x, tf, cst, norms, thresh, partial, B, d, m, k, rows_per_block, n_blocks, n_kd, copy_bytes, stream)
       : dt_rows <= 80 ? launch_stats<10>(x, tf, cst, norms, thresh, partial, B, d, m, k, rows_per_block, n_blocks, n_kd, copy_bytes, stream)
       : dt_rows <= 96 ? launch_stats<12>(x, tf, cst, norms, thresh, partial, B, d, m, k, rows_per_block, n_blocks, n_kd, copy_bytes, stream)
                       : launch_stats<16>(x, tf, cst, norms, thresh, partial, B, d, m, k, rows_per_block, n_blocks, n_kd, copy_bytes, stream);
}

template <int KMAX>
int launch_partial(const float* x, const float* inv_var, const float* proj,
                   const float* cst, float thresh, float* partial, int B, int d,
                   int m, int k, int rows_per_block, int n_blocks,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<KMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      fv_partial_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fv_partial_kernel<KMAX><<<dim3(n_blocks, B), TPB, smem, stream>>>(
      x, inv_var, proj, cst, thresh, partial, d, m, k, rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, d, m); means, variances: (d, k); weights: (k); terms: scratch of
// frag_offset(d, k) + frag_floats(d, k) floats (the GMM terms, then their
// fragment-major TF32 split); norms: scratch of B · m · 3 floats (used where
// d > 64 or k > 64); partial: scratch of B · ceil(m / rows_per_block) ·
// (1 + 2d) · k floats; out: (B, 1 + 2d, k) holding s0, s1 (d rows), s2 (d
// rows). Any d and k; rows_per_block a multiple of 128.
int ks_fv_stats(const float* x, const float* means, const float* variances,
                const float* weights, float thresh, float* terms, float* norms,
                float* partial, float* out, int B, int d, int m, int k, int rows_per_block,
                void* stream) {
  if (d < 1 || k < 1 || rows_per_block < R || rows_per_block % R != 0 || m < 1 || B < 1 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* inv_var = terms;
  const float* proj = terms + (size_t)d * k;
  const float* cst = terms + 2 * (size_t)d * k;
  const int n_blocks = (m + rows_per_block - 1) / rows_per_block;
  int err;
  if (d <= DMAX && k <= 64) {
    fv_terms_kernel<<<1, TPB, 0, s>>>(means, variances, weights, terms, d, k);
    err = k <= 32
        ? launch_partial<32>(x, inv_var, proj, cst, thresh, partial, B, d, m, k, rows_per_block, n_blocks, s)
        : launch_partial<64>(x, inv_var, proj, cst, thresh, partial, B, d, m, k, rows_per_block, n_blocks, s);
  } else {
    err = (int)launch_tiled(x, means, variances, weights, terms, thresh, norms, partial, B, d, m,
                            k, rows_per_block, n_blocks, s);
  }
  if (err != 0) return err;
  const int n_out = (1 + 2 * d) * k;
  const float inv_m = (float)(1.0 / (double)m);
  fv_reduce_kernel<<<dim3((n_out + TPB - 1) / TPB, B), TPB, 0, s>>>(
      partial, out, n_out, n_blocks, inv_m);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Fused Fisher-vector statistics, in float32 FMA (no TF32).
//
// Replaces the Pallas TPU kernel keystone_tpu/ops/images/fv_pallas.py:80
// fisher_vector_stats_pallas (body _fv_stats_kernel :36). For each image,
// x is a (d, m) descriptor matrix; per descriptor (row of xᵀ):
//   logits = −½·x²·inv_var + x·proj + const          (k values)
//   q      = softmax(logits); q = q·[q > thresh]; q /= Σq
// and s0 = Σ q, s1 = x qᵀ, s2 = x² qᵀ over the descriptors, each / m.
// The (m, k) posterior never reaches device memory.
//
// Bound on the H100: operations. Per descriptor the kernel does about
// 8·d·k flops (two products for the logits, two for s1/s2) against 4·d
// bytes of input, ≈ 64 flop/byte at k = 32, above the float32
// ops-per-byte balance (≈ 20). Float32 on the CUDA cores, so the
// JAX package's tolerances hold.
//
// Design. The TPU grid walks m-tiles in order and accumulates into its
// output blocks; GPU blocks run in no order. So:
//   pass 0: one block computes the GMM terms of the logits (inv_var, proj,
//     const) into a scratch buffer, as the plain version's gmm_terms does;
//   pass 1: one block per (slab of rows_per_block descriptors, image). Per
//     chunk of R = 128 descriptors the (d × R) x tile is staged in shared
//     memory once, by 4-byte cp.async (x's row stride, 4·m bytes, is not
//     16-byte aligned at the serving m), double-buffered. Then
//       logits: −½·(x² · inv_var) + x · proj + const, two (R × d) · (d × k)
//         products against inv_var and proj in shared memory, summed
//         apart as the reference sums them (at the serving magnitudes the
//         logits are large, their rounding decides near-ties of the
//         softmax, and one interleaved sum rounds apart from the
//         reference); each thread owns 4 descriptors × k/8
//         mixtures of both in registers and reads float4s; x² is formed
//         in registers;
//       softmax, threshold and renormalisation across a descriptor's k
//         values, held by 8 lanes of a warp, by shuffles, each step over a
//         thread's 4 descriptors at once so their shuffle chains overlap,
//         and by one reciprocal per descriptor and sum (an IEEE division
//         per value takes a slow path on subnormal exponentials; the
//         product differs from the quotient by an ulp or two); q goes to
//         shared memory as float4 rows (each quarter-warp writes one
//         128-byte row: no bank conflicts);
//       s1, s2: each thread owns 2 rows of d × k/8 mixtures of both, in
//         registers for the whole slab, and adds the outer product of its
//         x/x² values and a float4 row of q per descriptor; s0 sums q in
//         registers.
//     The block writes its partial sums once, at the end of the slab.
//   pass 2: one thread per (output, image) sums the partials in slab order
//     and divides by m. No atomics: the output is identical from run to run.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

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
// (2d + 1) · k floats; partial: scratch of B · ceil(m / rows_per_block) ·
// (1 + 2d) · k floats; out: (B, 1 + 2d, k) holding s0, s1 (d rows), s2 (d
// rows). Needs d <= 64, k <= 64 and rows_per_block a multiple of 128.
int ks_fv_stats(const float* x, const float* means, const float* variances,
                const float* weights, float thresh, float* terms, float* partial,
                float* out, int B, int d, int m, int k, int rows_per_block,
                void* stream) {
  if (d < 1 || d > DMAX || k < 1 || k > 64 || rows_per_block < R ||
      rows_per_block % R != 0 || m < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  fv_terms_kernel<<<1, TPB, 0, s>>>(means, variances, weights, terms, d, k);
  const float* inv_var = terms;
  const float* proj = terms + d * k;
  const float* cst = terms + 2 * d * k;
  const int n_blocks = (m + rows_per_block - 1) / rows_per_block;
  int err = k <= 32
      ? launch_partial<32>(x, inv_var, proj, cst, thresh, partial, B, d, m, k, rows_per_block, n_blocks, s)
      : launch_partial<64>(x, inv_var, proj, cst, thresh, partial, B, d, m, k, rows_per_block, n_blocks, s);
  if (err != 0) return err;
  const int n_out = (1 + 2 * d) * k;
  const float inv_m = (float)(1.0 / (double)m);
  fv_reduce_kernel<<<dim3((n_out + TPB - 1) / TPB, B), TPB, 0, s>>>(
      partial, out, n_out, n_blocks, inv_m);
  return (int)cudaGetLastError();
}

}  // extern "C"

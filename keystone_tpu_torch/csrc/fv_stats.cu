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
//   pass 1: one block per (image, slab of rows_per_block descriptors). In
//     sub-chunks of 256 descriptors, each thread computes one descriptor's
//     posterior in registers (x read coalesced from (d, m), the GMM terms
//     from shared memory) and writes it to shared memory; then the block
//     forms that sub-chunk's s0/s1/s2 contributions and adds them to a
//     per-block accumulator in shared memory, each output owned by one
//     thread. The block writes its partial sums to a scratch buffer.
//   pass 2: one block per image sums the partials in slab order and
//     divides by m. No atomics: the output is identical from run to run.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int TPB = 256;

template <int KMAX>
__global__ void __launch_bounds__(TPB)
fv_partial_kernel(const float* __restrict__ x, const float* __restrict__ inv_var,
                  const float* __restrict__ proj, const float* __restrict__ cst,
                  float thresh, float* __restrict__ partial, int d, int m, int k,
                  int rows_per_block) {
  extern __shared__ float smem[];
  const int n_out = (1 + 2 * d) * k;
  float* ivs = smem;            // [d][k]
  float* pjs = ivs + d * k;     // [d][k]
  float* cs = pjs + d * k;      // [k]
  float* qs = cs + k;           // [TPB][k]
  float* acc = qs + TPB * k;    // [1 + 2d][k]: s0, then s1 rows, then s2 rows

  const int blk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float* xb = x + (size_t)b * d * m;

  for (int i = tid; i < d * k; i += TPB) {
    ivs[i] = inv_var[i];
    pjs[i] = proj[i];
  }
  for (int i = tid; i < k; i += TPB) cs[i] = cst[i];
  for (int i = tid; i < n_out; i += TPB) acc[i] = 0.0f;
  __syncthreads();

  const int row_begin = blk * rows_per_block;
  const int row_end = min(m, row_begin + rows_per_block);
  for (int base = row_begin; base < row_end; base += TPB) {
    const int rows = min(TPB, row_end - base);
    // -- posterior of one descriptor per thread -----------------------------
    {
      float q[KMAX];
      const int row = base + tid;
      if (tid < rows) {
        float a[KMAX], bb[KMAX];
#pragma unroll
        for (int c = 0; c < KMAX; ++c) { a[c] = 0.0f; bb[c] = 0.0f; }
        for (int dd = 0; dd < d; ++dd) {
          const float xv = xb[(size_t)dd * m + row];
          const float x2 = xv * xv;
#pragma unroll
          for (int c = 0; c < KMAX; ++c) {
            if (c < k) {
              a[c] = fmaf(x2, ivs[dd * k + c], a[c]);
              bb[c] = fmaf(xv, pjs[dd * k + c], bb[c]);
            }
          }
        }
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < KMAX; ++c) {
          if (c < k) {
            q[c] = -0.5f * a[c] + bb[c] + cs[c];
            mx = fmaxf(mx, q[c]);
          }
        }
        float sum = 0.0f;
#pragma unroll
        for (int c = 0; c < KMAX; ++c) {
          if (c < k) {
            q[c] = expf(q[c] - mx);
            sum += q[c];
          }
        }
        float sum2 = 0.0f;
#pragma unroll
        for (int c = 0; c < KMAX; ++c) {
          if (c < k) {
            q[c] = q[c] / sum;
            q[c] = q[c] > thresh ? q[c] : 0.0f;
            sum2 += q[c];
          }
        }
#pragma unroll
        for (int c = 0; c < KMAX; ++c)
          if (c < k) q[c] = q[c] / sum2;
      } else {
#pragma unroll
        for (int c = 0; c < KMAX; ++c) q[c] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < KMAX; ++c)
        if (c < k) qs[tid * k + c] = q[c];
    }
    __syncthreads();
    // -- this sub-chunk's s0 / s1 / s2, each output owned by one thread ----
    for (int o = tid; o < n_out; o += TPB) {
      const int j = o / k, c = o % k;
      float s = 0.0f;
      if (j == 0) {
        for (int r = 0; r < rows; ++r) s += qs[r * k + c];
      } else if (j <= d) {
        const float* xr = xb + (size_t)(j - 1) * m + base;
        for (int r = 0; r < rows; ++r) s = fmaf(xr[r], qs[r * k + c], s);
      } else {
        const float* xr = xb + (size_t)(j - 1 - d) * m + base;
        for (int r = 0; r < rows; ++r) {
          const float xv = xr[r];
          s = fmaf(xv * xv, qs[r * k + c], s);
        }
      }
      acc[o] += s;
    }
    __syncthreads();
  }
  float* dst = partial + ((size_t)b * gridDim.x + blk) * n_out;
  for (int o = tid; o < n_out; o += TPB) dst[o] = acc[o];
}

// out[b] = (Σ over slabs, in slab order, of partial[b, slab]) / m
__global__ void __launch_bounds__(TPB)
fv_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                 int n_out, int n_blocks, float inv_m) {
  const int b = blockIdx.x;
  const float* src = partial + (size_t)b * n_blocks * n_out;
  for (int o = threadIdx.x; o < n_out; o += TPB) {
    float s = 0.0f;
    for (int i = 0; i < n_blocks; ++i) s += src[(size_t)i * n_out + o];
    out[(size_t)b * n_out + o] = s * inv_m;
  }
}

template <int KMAX>
int launch_partial(const float* x, const float* inv_var, const float* proj,
                   const float* cst, float thresh, float* partial, int B, int d,
                   int m, int k, int rows_per_block, int n_blocks,
                   cudaStream_t stream) {
  size_t smem = sizeof(float) * ((size_t)2 * d * k + k + (size_t)TPB * k + (size_t)(1 + 2 * d) * k);
  cudaError_t err = cudaFuncSetAttribute(
      fv_partial_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fv_partial_kernel<KMAX><<<dim3(n_blocks, B), TPB, smem, stream>>>(
      x, inv_var, proj, cst, thresh, partial, d, m, k, rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, d, m); inv_var, proj: (d, k); cst: (k); partial: scratch of
// B · ceil(m / rows_per_block) · (1 + 2d) · k floats; out: (B, 1 + 2d, k)
// holding s0, s1 (d rows), s2 (d rows). Needs k <= 64 and rows_per_block a
// multiple of 256.
int ks_fv_stats(const float* x, const float* inv_var, const float* proj,
                const float* cst, float thresh, float* partial, float* out, int B,
                int d, int m, int k, int rows_per_block, void* stream) {
  if (k < 1 || k > 64 || rows_per_block % TPB != 0 || m < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_blocks = (m + rows_per_block - 1) / rows_per_block;
  int err = k <= 32
      ? launch_partial<32>(x, inv_var, proj, cst, thresh, partial, B, d, m, k, rows_per_block, n_blocks, s)
      : launch_partial<64>(x, inv_var, proj, cst, thresh, partial, B, d, m, k, rows_per_block, n_blocks, s);
  if (err != 0) return err;
  const float inv_m = (float)(1.0 / (double)m);
  fv_reduce_kernel<<<B, TPB, 0, s>>>(partial, out, (1 + 2 * d) * k, n_blocks, inv_m);
  return (int)cudaGetLastError();
}

}  // extern "C"

// GEMM sandwich kernel of the LCS extractor: out = At · Z · B over a stack
// of (H, W) planes Z, in float32 FMA (no TF32).
//
// Replaces the Pallas TPU kernel in keystone_tpu/ops/images/pallas_kernels.py:
//   ks_plane_sandwich   <- plane_sandwich  (:129, body _plane_sandwich_kernel :121)
//
// Bound on the H100: bytes, counting only the operators' bands (an LCS
// column holds 6 nonzeros): about 0.5 GFLOP against 178 MB at B = 64. This
// kernel multiplies the operators dense: at 256x256 a plane costs
// 2·M·H·W + 2·M·W·N ≈ 55 MFLOP against 0.25 MB of input, far above the
// card's float32 ops-per-byte balance (67 TFLOP/s / 3.35 TB/s ≈ 20), so its
// float32 FMA rate sets its pace. Both products run on the CUDA cores in
// float32: tensor cores would mean TF32, which misses the JAX package's
// 1e-4 tolerances.
//
// Design. The TPU kernel holds a whole (H, W) plane in VMEM; at 256² that is
// 256 KiB, more than the 227 KB of shared memory a block may use. So one
// block takes (image b, plane p, a tile of BM = 64 rows of M) and:
//   1. for each BW = 128-wide column tile of W, streams H in BK-deep chunks:
//      the chunk of the plane is staged in shared memory, and
//      T1 = At[tile, :] · Z[:, wtile] accumulates in registers; each
//      finished T1 tile is stored, transposed, to a shared-memory buffer of
//      W × BM;
//   2. computes T1 · B tile by tile (BN = 128 columns) into the output.
// Neither the plane stack nor T1 reaches device memory, which is the point of
// the TPU kernel. 128 threads each own an 8x8 register tile (rows
// ty*4+{0..3} and 32+ty*4+{0..3}, columns tx*4+{0..3} and 64+tx*4+{0..3}), so
// every shared-memory read is a float4 and feeds 64 FMAs per 4 loads.
// Each output sums its products in ascending order of the reduction index.
// The operators At and B are banded (LCS's box spans the patch), but are
// multiplied dense here, as on the TPU; the SIFT kernel (sift_bin.cu) walks
// only the bands.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 64;   // rows of M per block
constexpr int BW = 128;  // W tile of the first product
constexpr int BN = 128;  // N tile of the second product
constexpr int BK = 8;    // reduction chunk
constexpr int TPB = 128; // 8 x 16 threads, 8 x 8 outputs each

// Plane p of image b of a (B, P, H, W) stack.
struct StackPlane {
  const float* planes;
  int P, H, W;
  using Raw = float;
  __device__ __forceinline__ Raw load(int b, int p, int h, int w) const {
    return planes[(((size_t)b * P + p) * H + h) * W + w];
  }
  __device__ __forceinline__ float value(Raw r, int) const { return r; }
};

// Shared memory: T1t (Wr x BM) + As (BK x BM) + Zs (BK x BW) + Bs (BK x BN).
inline size_t smem_bytes(int W) {
  size_t Wr = (size_t)((W + BW - 1) / BW) * BW;
  return sizeof(float) * (Wr * BM + BK * BM + BK * BW + BK * BN);
}

// acc[i][j] += a[i] * z[j] over one BK chunk; a from a (BK x BM) tile, z
// from a (BK x 128) tile, both row-major in shared memory.
__device__ __forceinline__ void mma_chunk(float (&acc)[8][8], const float* A,
                                          const float* Z, int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + kk * BM + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(A + kk * BM + 32 + ty * 4);
    const float4 z0 = *reinterpret_cast<const float4*>(Z + kk * 128 + tx * 4);
    const float4 z1 = *reinterpret_cast<const float4*>(Z + kk * 128 + 64 + tx * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float z[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], z[j], acc[i][j]);
  }
}

__device__ __forceinline__ int row_of(int ty, int i) { return (i < 4 ? 0 : 32) + ty * 4 + (i & 3); }
__device__ __forceinline__ int col_of(int tx, int j) { return (j < 4 ? 0 : 64) + tx * 4 + (j & 3); }

template <typename Plane>
__global__ void __launch_bounds__(TPB)
sandwich_kernel(Plane plane, const float* __restrict__ at,
                const float* __restrict__ bm, float* __restrict__ out,
                int P, int H, int W, int M, int N) {
  extern __shared__ __align__(16) float smem[];
  const int Wr = ((W + BW - 1) / BW) * BW;
  float* T1t = smem;                 // [Wr][BM]: T1 transposed
  float* As = T1t + Wr * BM;         // [BK][BM]
  float* Zs = As + BK * BM;          // [BK][BW]
  float* Bs = Zs + BK * BW;          // [BK][BN]

  const int m0 = blockIdx.x * BM;
  const int p = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // Each thread loads the same slots of every chunk: As elements
  // e = tid + r·TPB (kk = e % BK walks H, coalesced), Zs/Bs elements
  // e = tid + r·TPB (kk = e / 128, column = e % 128, coalesced).
  constexpr int NA = BK * BM / TPB;   // 4
  constexpr int NZ = BK * BW / TPB;   // 8
  float ra[NA];
  typename Plane::Raw rz[NZ];
  float rb[NZ];

  auto load_a = [&](int h0) {
#pragma unroll
    for (int r = 0; r < NA; ++r) {
      int e = tid + r * TPB, kk = e % BK, m = m0 + e / BK, h = h0 + kk;
      ra[r] = (m < M && h < H) ? at[(size_t)m * H + h] : 0.0f;
    }
  };
  auto store_a = [&]() {
#pragma unroll
    for (int r = 0; r < NA; ++r) {
      int e = tid + r * TPB;
      As[(e % BK) * BM + e / BK] = ra[r];
    }
  };
  auto load_z = [&](int h0, int w0) {
#pragma unroll
    for (int r = 0; r < NZ; ++r) {
      int e = tid + r * TPB, h = h0 + e / BW, w = w0 + e % BW;
      rz[r] = (h < H && w < W) ? plane.load(b, p, h, w) : typename Plane::Raw{};
    }
  };
  auto store_z = [&]() {
#pragma unroll
    for (int r = 0; r < NZ; ++r) Zs[tid + r * TPB] = plane.value(rz[r], p);
  };
  auto load_b = [&](int k0, int n0) {
#pragma unroll
    for (int r = 0; r < NZ; ++r) {
      int e = tid + r * TPB, k = k0 + e / BN, n = n0 + e % BN;
      rb[r] = (k < W && n < N) ? bm[(size_t)k * N + n] : 0.0f;
    }
  };
  auto store_b = [&]() {
#pragma unroll
    for (int r = 0; r < NZ; ++r) Bs[tid + r * TPB] = rb[r];
  };

  // -- 1. T1[BM][W] = At[m0:m0+BM, :] · plane --------------------------------
  for (int w0 = 0; w0 < Wr; w0 += BW) {
    float acc[8][8] = {};
    load_a(0);
    load_z(0, w0);
    for (int h0 = 0; h0 < H; h0 += BK) {
      store_a();
      store_z();
      __syncthreads();
      if (h0 + BK < H) {  // next chunk's loads fly while this one computes
        load_a(h0 + BK);
        load_z(h0 + BK, w0);
      }
      mma_chunk(acc, As, Zs, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) T1t[(w0 + col_of(tx, j)) * BM + row_of(ty, i)] = acc[i][j];
  }
  __syncthreads();

  // -- 2. out[b, p, m0:m0+BM, :] = T1 · B ------------------------------------
  float* o = out + ((size_t)b * P + p) * M * N;
  for (int n0 = 0; n0 < N; n0 += BN) {
    float acc[8][8] = {};
    load_b(0, n0);
    for (int k0 = 0; k0 < W; k0 += BK) {
      store_b();
      __syncthreads();
      if (k0 + BK < W) load_b(k0 + BK, n0);
      // T1t rows k0.. are W-tile columns of T1: the (BK x BM) A operand
      mma_chunk(acc, T1t + k0 * BM, Bs, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int m = m0 + row_of(ty, i);
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int n = n0 + col_of(tx, j);
        if (n < N) o[(size_t)m * N + n] = acc[i][j];
      }
    }
  }
}

template <typename Plane>
int launch(Plane plane, const float* at, const float* bm, float* out, int B,
           int P, int H, int W, int M, int N, void* stream) {
  size_t smem = smem_bytes(W);
  cudaError_t err = cudaFuncSetAttribute(
      sandwich_kernel<Plane>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, P, B);
  sandwich_kernel<Plane><<<grid, TPB, smem, (cudaStream_t)stream>>>(
      plane, at, bm, out, P, H, W, M, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// planes: (B, P, H, W); at: (M, H); b: (W, N); out: (B, P, M, N).
int ks_plane_sandwich(const float* planes, const float* at, const float* b,
                      float* out, int B, int P, int H, int W, int M, int N,
                      void* stream) {
  StackPlane plane{planes, P, H, W};
  return launch(plane, at, b, out, B, P, H, W, M, N, stream);
}

}  // extern "C"

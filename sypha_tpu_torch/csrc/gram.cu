// Batched column-scaled Gram matrices on Hopper (sm_90a):
//
//     M[b, i, j] = sum_k (A[i, k] * w[b, k]) * (A[j, k] * w[b, k])
//
// A: [m, n] f32 (shared by every lane), w: [B, n] f32, M: [B, m, m] f32.
//
// Replaces the Pallas TPU kernel sypha_tpu/ops/pallas_gram.py:pallas_gram,
// which formed the same matrices from a materialised [B, m, n] Aw = A * w.
//
// What bounds it on this card: per lane the kernel does 2 m^2 n FLOPs and
// reads m n floats of A (the same A for every lane, so it stays in the 50 MB
// L2 after the first lanes) plus n floats of w.  At the main path's shapes
// (m = 200, n = 1280 and m = 504, n = 5504) that is hundreds of FLOPs per
// byte, so the kernel is bound by fp32 FMA throughput, not by memory.  The
// products must be IEEE fp32: the f32 Cholesky that consumes M breaks under
// TF32, so the tensor cores are not used and fast-math is not enabled.
//
// What the design does about it: the column scale w[b] is applied while a
// tile of A is staged in shared memory, so the [B, m, n] Aw temporary never
// exists in device memory.  Each block computes one 64 x 64 output tile of
// one lane (grid: tiles_j x tiles_i x B) and walks k in chunks of 16; each
// of its 256 threads keeps a 4 x 4 register tile of accumulators, so every
// 8 shared-memory loads feed 16 FMAs.  Ragged edges stage zeros, so any
// m, n and B work.  There are no atomics: every output element is summed
// by one thread in a fixed k order, so results are the same run to run and
// M[b, i, j] == M[b, j, i] bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;                 // output tile edge
constexpr int kChunk = 16;                // k values staged per step
constexpr int kThreadsPerEdge = 16;       // 16 x 16 = 256 threads per block
constexpr int kReg = kTile / kThreadsPerEdge;  // 4 x 4 accumulators per thread

__global__ void __launch_bounds__(kThreadsPerEdge * kThreadsPerEdge)
    gram_kernel(const float* __restrict__ A, const float* __restrict__ w,
                float* __restrict__ M, int m, int n) {
  // k-major so that the inner loop reads a row of the tile; the +1 column
  // spreads the transposing stores over the banks
  __shared__ float s_i[kChunk][kTile + 1];
  __shared__ float s_j[kChunk][kTile + 1];

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x;  // output columns j0 + tx + 16 p
  const int ty = threadIdx.y;  // output rows    i0 + ty + 16 q
  const int t = ty * kThreadsPerEdge + tx;
  // staging: 16 neighbouring threads read 16 neighbouring k of one row
  const int lk = t % kChunk;
  const int lr = t / kChunk;  // 0..15; rows lr + 16 q
  const float* wb = w + static_cast<size_t>(b) * n;

  float acc[kReg][kReg] = {};
  for (int k0 = 0; k0 < n; k0 += kChunk) {
    const int k = k0 + lk;
    const bool k_in = k < n;
    const float wk = k_in ? wb[k] : 0.f;
#pragma unroll
    for (int q = 0; q < kReg; ++q) {
      const int r = lr + q * kThreadsPerEdge;
      const int gi = i0 + r;
      const int gj = j0 + r;
      s_i[lk][r] = (k_in && gi < m) ? A[static_cast<size_t>(gi) * n + k] * wk : 0.f;
      s_j[lk][r] = (k_in && gj < m) ? A[static_cast<size_t>(gj) * n + k] * wk : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[kReg];
      float c[kReg];
#pragma unroll
      for (int q = 0; q < kReg; ++q) {
        a[q] = s_i[kk][ty + q * kThreadsPerEdge];
        c[q] = s_j[kk][tx + q * kThreadsPerEdge];
      }
#pragma unroll
      for (int q = 0; q < kReg; ++q) {
#pragma unroll
        for (int p = 0; p < kReg; ++p) {
          acc[q][p] = fmaf(a[q], c[p], acc[q][p]);
        }
      }
    }
    __syncthreads();
  }

  float* Mb = M + static_cast<size_t>(b) * m * m;
#pragma unroll
  for (int q = 0; q < kReg; ++q) {
    const int gi = i0 + ty + q * kThreadsPerEdge;
    if (gi >= m) continue;
#pragma unroll
    for (int p = 0; p < kReg; ++p) {
      const int gj = j0 + tx + p * kThreadsPerEdge;
      if (gj < m) Mb[static_cast<size_t>(gi) * m + gj] = acc[q][p];
    }
  }
}

}  // namespace

// Launches the kernel on `stream` of `device`.  Returns cudaGetLastError()
// after the launch (0 on success); the caller owns every buffer.
extern "C" int sypha_gram_f32(const float* A, const float* w, float* M, int B,
                              int m, int n, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (m + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, B);
  const dim3 block(kThreadsPerEdge, kThreadsPerEdge);
  gram_kernel<<<grid, block, 0, stream>>>(A, w, M, m, n);
  return static_cast<int>(cudaGetLastError());
}

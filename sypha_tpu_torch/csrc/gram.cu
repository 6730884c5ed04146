// Batched column-scaled Gram matrices on Hopper (sm_90a):
//
//     M[b, i, j] = sum_k (A[i, k] * w[b, k]) * (A[j, k] * w[b, k])
//
// A: [m, n] f32 (shared by every lane), w: [B, n] f32, M: [B, m, m] f32.
//
// Replaces the Pallas TPU kernel sypha_tpu/ops/pallas_gram.py:pallas_gram,
// which formed the same matrices from a materialised [B, m, n] Aw = A * w
// with a dot_general at "highest" precision; on the TPU that f32 product is
// itself several bf16 passes of the matrix unit.
//
// What bounds it on this card: per lane the kernel does 2 m^2 n FLOPs and
// reads m n floats of A (the same A for every lane, so it stays in the 50 MB
// L2) plus n floats of w.  At the main path's shapes (m = 200, n = 1280 and
// m = 504, n = 5504) that is hundreds of FLOPs per byte, so it is bound by
// arithmetic.  fp32 FMAs on the CUDA cores give about 67 TFLOP/s; the bf16
// tensor cores give 989.  The f32 Cholesky that consumes M needs products
// good to f32 (TF32 or a single bf16 pass breaks it).
//
// What the design does about it:
//  * bf16x6 split.  Each scaled operand x = A[i, k] * w[b, k], rounded to
//    f32 as the plain version rounds it, is split exactly into three bf16
//    pieces hi + mid + lo (bf16 has f32's exponent range and 3 x 8 bits of
//    significand cover f32's 24).  The six products hi.hi, hi.mid, mid.hi,
//    hi.lo, lo.hi, mid.mid are exact in the tensor core's f32 accumulator;
//    the dropped ones are below 2^-23 of each term.  Products that fall in
//    the f32 denormal range (the tensor cores may flush them) are below
//    2^-126, which for |A| >= 1 and w >= 1e-15 (the IPM's clamp on d2) is
//    below 2^-26 of the term they belong to.
//  * mma.sync.m16n8k16 bf16 -> f32, fed by ldmatrix.  The tensor cores add
//    with truncation, not round-to-nearest, so a sum kept in the MMA
//    accumulator drifts low by about an ulp per MMA (3e-5 relative at
//    n = 5504).  Each 16-wide k block of each fragment therefore sums its
//    six products into a fresh accumulator, smallest first, so only the
//    last MMA truncates at the block's scale, and the block is added to the
//    running sum in f32 with round-to-nearest.
//  * SYRK: only the lower-triangle 64 x 64 tiles run (grid.x walks
//    T(T+1)/2 tiles, grid.y the lanes).  An off-diagonal tile writes its
//    sum to M[b, i, j] and M[b, j, i]; a diagonal tile stages one side only
//    and writes its lower half to both places, so M == M^T bit for bit.
//  * The column scale is applied and the split made while staging, so the
//    [B, m, n] Aw temporary never exists in device memory.  Rows past m and
//    k past n stage zeros, so any m, n and B <= 65535 work.  There are no
//    atomics: each element is summed in one fixed order, run to run.
//  * Staging overlaps compute.  The fp32 rows of A and the chunk of w go
//    to shared memory by cp.async (16-byte copies when n % 4 == 0 and the
//    pointers are 16-byte aligned, 4-byte copies otherwise; a template
//    parameter chosen at launch), two chunks ahead of the MMAs.  The split
//    into bf16 planes is double-buffered too: in each step a warp issues
//    its MMAs on chunk c, then splits chunk c + 1 while the tensor cores
//    work through them; one barrier per step.
//
// Each block has 4 warps, each owning a 32 x 32 quarter of the tile.  The
// epilogue goes through shared memory so both the tile and its mirror are
// written with coalesced rows.
//
// What bounds it now (H100 80GB HBM3 at 700 W, 64 lanes, m = 504,
// n = 5504): 2.5 ms a call.  The MMA stream alone takes 1.7 ms (5.9e11
// tensor-core FLOP, 344 TFLOP/s of the 989 bf16 peak); the copies and the
// split alone take 1.3 ms and hide only partly behind it.  A 128 x 64 tile
// (less split work per output) and a tighter register budget measured no
// faster.  The levers left are wgmma, and for A in {0, +-1} a split of w^2
// alone with three products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 64;               // output tile edge
constexpr int kChunk = 16;              // k values staged per step
constexpr int kWarps = 4;               // 2 x 2 warps, 32 x 32 each
constexpr int kThreads = 32 * kWarps;
constexpr int kPlanes = 3;              // hi, mid, lo
constexpr int kQuads = kChunk / 4;      // 4-float groups per staged row
constexpr int kRowPitch = kChunk + 8;   // bf16 per split row: 8 rows of an
                                        // ldmatrix hit 8 distinct 16-byte
                                        // bank groups
constexpr int kOutPitch = kTile + 1;    // f32 per epilogue row

struct Raw {  // one chunk as copied from device memory
  float a[2][kTile][kChunk];  // [side][row][k]
  float w[kChunk];
};
struct Split {  // one chunk split into bf16 planes (raw bits)
  uint16_t x[2][kPlanes][kTile][kRowPitch];  // [side][plane][row][k]
};
struct Pipe {
  Raw raw[2];
  Split split[2];
};
struct Epilogue {
  float c[kTile][kOutPitch];
};
union Smem {
  Pipe pipe;
  Epilogue out;
};

// dst <- src (kBytes), or zeros when !valid; src must be a valid address
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int src_bytes = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(kBytes), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint16_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a * b on a 16 x 8 x 16 bf16 fragment, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy chunk [k0, k0 + kChunk) of the tile's rows of A and of w into `r`;
// rows past m and k past n become zeros.  A diagonal tile copies one side.
template <int kVec>
__device__ __forceinline__ void load_chunk(Raw& r, const float* __restrict__ A,
                                           const float* __restrict__ wb, int i0, int j0,
                                           bool diag, int m, int n, int k0) {
  constexpr int kPerRow = kChunk / kVec;  // copies per row
  static_assert(kTile * kPerRow % kThreads == 0 && kPerRow <= kThreads, "copy mapping");
  for (int side = 0; side < (diag ? 1 : 2); ++side) {
    const int row0 = side == 0 ? i0 : j0;
#pragma unroll
    for (int s = 0; s < kTile * kPerRow / kThreads; ++s) {
      const int idx = threadIdx.x + s * kThreads;
      const int row = idx / kPerRow;
      const int k = k0 + (idx % kPerRow) * kVec;
      const bool valid = row0 + row < m && k < n;
      const float* src = valid ? A + static_cast<size_t>(row0 + row) * n + k : A;
      cp_async<4 * kVec>(&r.a[side][row][k - k0], src, valid);
    }
  }
  if (threadIdx.x < kPerRow) {
    const int k = k0 + threadIdx.x * kVec;
    cp_async<4 * kVec>(&r.w[k - k0], k < n ? wb + k : wb, k < n);
  }
}

// x = A * w, rounded to f32 as in the plain version (__fmul_rn is never
// fused with the subtractions below), split exactly into hi + mid + lo.
// Thread t splits the 4-float group t % kQuads of every (kThreads /
// kQuads)-th row from t / kQuads on.
__device__ __forceinline__ void split_chunk(Split& s, const Raw& r, bool diag) {
  constexpr int kRowStep = kThreads / kQuads;
  static_assert(kTile % kRowStep == 0, "split mapping");
  const int q = threadIdx.x % kQuads;
  const float4 wq = *reinterpret_cast<const float4*>(&r.w[4 * q]);
  for (int side = 0; side < (diag ? 1 : 2); ++side) {
#pragma unroll
    for (int step = 0; step < kTile / kRowStep; ++step) {
      const int row = threadIdx.x / kQuads + step * kRowStep;
      const float4 a = *reinterpret_cast<const float4*>(&r.a[side][row][4 * q]);
      const float2 x01 = make_float2(__fmul_rn(a.x, wq.x), __fmul_rn(a.y, wq.y));
      const float2 x23 = make_float2(__fmul_rn(a.z, wq.z), __fmul_rn(a.w, wq.w));
      const __nv_bfloat162 hi01 = __float22bfloat162_rn(x01);
      const __nv_bfloat162 hi23 = __float22bfloat162_rn(x23);
      const float2 r01 = make_float2(x01.x - __low2float(hi01), x01.y - __high2float(hi01));
      const float2 r23 = make_float2(x23.x - __low2float(hi23), x23.y - __high2float(hi23));
      const __nv_bfloat162 mid01 = __float22bfloat162_rn(r01);
      const __nv_bfloat162 mid23 = __float22bfloat162_rn(r23);
      const __nv_bfloat162 lo01 = __floats2bfloat162_rn(r01.x - __low2float(mid01),
                                                        r01.y - __high2float(mid01));
      const __nv_bfloat162 lo23 = __floats2bfloat162_rn(r23.x - __low2float(mid23),
                                                        r23.y - __high2float(mid23));
      *reinterpret_cast<uint2*>(&s.x[side][0][row][4 * q]) = make_uint2(bits(hi01), bits(hi23));
      *reinterpret_cast<uint2*>(&s.x[side][1][row][4 * q]) = make_uint2(bits(mid01), bits(mid23));
      *reinterpret_cast<uint2*>(&s.x[side][2][row][4 * q]) = make_uint2(bits(lo01), bits(lo23));
    }
  }
}

// The warp's 32 x 32 quarter: acc += the six kept products of one chunk.
__device__ __forceinline__ void mma_chunk(float (&acc)[2][4][4], const Split& s, int wy, int wx,
                                          int j_side) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < kChunk; ks += 16) {
    uint32_t a[kPlanes][2][4];   // [plane][m16 fragment]
    uint32_t bf[kPlanes][2][4];  // [plane][pair of n8 fragments]
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        ldmatrix_x4(a[p][f], &s.x[0][p][32 * wy + 16 * f + lane % 16][ks + (lane / 16) * 8]);
        ldmatrix_x4(bf[p][f], &s.x[j_side][p][32 * wx + 16 * f + (lane / 16) * 8 + lane % 8]
                                            [ks + ((lane / 8) % 2) * 8]);
      }
    }
#pragma unroll
    for (int fi = 0; fi < 2; ++fi) {
#pragma unroll
      for (int fj = 0; fj < 4; ++fj) {
        const int g = fj / 2, h = 2 * (fj % 2);
        // a fresh sum per k16: small products first, so only the last
        // (hi.hi) is truncated at the scale of the whole block
        float d[4] = {};
        mma_bf16(d, a[2][fi], bf[0][g][h], bf[0][g][h + 1]);  // lo.hi
        mma_bf16(d, a[0][fi], bf[2][g][h], bf[2][g][h + 1]);  // hi.lo
        mma_bf16(d, a[1][fi], bf[1][g][h], bf[1][g][h + 1]);  // mid.mid
        mma_bf16(d, a[1][fi], bf[0][g][h], bf[0][g][h + 1]);  // mid.hi
        mma_bf16(d, a[0][fi], bf[1][g][h], bf[1][g][h + 1]);  // hi.mid
        mma_bf16(d, a[0][fi], bf[0][g][h], bf[0][g][h + 1]);  // hi.hi
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[fi][fj][e] += d[e];
      }
    }
  }
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    gram_kernel(const float* __restrict__ A, const float* __restrict__ w,
                float* __restrict__ M, int m, int n) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Smem& smem = *reinterpret_cast<Smem*>(smem_bytes);

  // lower-triangle tile t -> (ti, tj), tj <= ti
  const int t = blockIdx.x;
  int ti = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  while (ti * (ti + 1) / 2 > t) --ti;
  const int tj = t - ti * (ti + 1) / 2;
  const bool diag = ti == tj;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const int b = blockIdx.y;
  const float* wb = w + static_cast<size_t>(b) * n;

  const int warp = threadIdx.x / 32;
  const int wy = warp / 2;  // rows 32 wy .. of the tile (i side)
  const int wx = warp % 2;  // cols 32 wx .. of the tile (j side)
  // on a diagonal tile the upper-right quarter is never read
  const bool active = !(diag && wx > wy);
  const int j_side = diag ? 0 : 1;

  // chunk c is copied into raw[c % 2] two steps ahead, split into
  // split[c % 2] one step ahead, and multiplied in step c
  Pipe& pipe = smem.pipe;
  const int chunks = (n + kChunk - 1) / kChunk;
  load_chunk<kVec>(pipe.raw[0], A, wb, i0, j0, diag, m, n, 0);
  cp_async_commit();
  load_chunk<kVec>(pipe.raw[1], A, wb, i0, j0, diag, m, n, kChunk);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  split_chunk(pipe.split[0], pipe.raw[0], diag);

  float acc[2][4][4] = {};
  for (int c = 0; c < chunks; ++c) {
    // chunk c + 1 has landed; chunk c is split; the buffers of step c - 1
    // are free
    cp_async_wait<0>();
    __syncthreads();
    if (c + 2 < chunks) {
      load_chunk<kVec>(pipe.raw[c % 2], A, wb, i0, j0, diag, m, n, (c + 2) * kChunk);
      cp_async_commit();
    }
    // MMAs first: the tensor cores work through them while the warp splits
    if (active) mma_chunk(acc, pipe.split[c % 2], wy, wx, j_side);
    if (c + 1 < chunks) split_chunk(pipe.split[(c + 1) % 2], pipe.raw[(c + 1) % 2], diag);
  }
  cp_async_wait<0>();
  __syncthreads();

  // accumulators -> shared tile (fragment rows g and g + 8, cols 2 q, 2 q + 1)
  if (active) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int fi = 0; fi < 2; ++fi) {
#pragma unroll
      for (int fj = 0; fj < 4; ++fj) {
        const int r = 32 * wy + 16 * fi + lane / 4;
        const int c = 32 * wx + 8 * fj + 2 * (lane % 4);
        smem.out.c[r][c] = acc[fi][fj][0];
        smem.out.c[r][c + 1] = acc[fi][fj][1];
        smem.out.c[r + 8][c] = acc[fi][fj][2];
        smem.out.c[r + 8][c + 1] = acc[fi][fj][3];
      }
    }
  }
  __syncthreads();

  float* Mb = M + static_cast<size_t>(b) * m * m;
  const int c = threadIdx.x % kTile;
  for (int r = threadIdx.x / kTile; r < kTile; r += kThreads / kTile) {
    // the tile at (i0, j0); a diagonal tile takes its lower half both ways
    const int gi = i0 + r;
    const int gj = j0 + c;
    if (gi < m && gj < m) {
      Mb[static_cast<size_t>(gi) * m + gj] =
          (!diag || r >= c) ? smem.out.c[r][c] : smem.out.c[c][r];
    }
    // the mirrored tile at (j0, i0)
    const int mi = j0 + r;
    const int mj = i0 + c;
    if (!diag && mi < m && mj < m) Mb[static_cast<size_t>(mi) * m + mj] = smem.out.c[c][r];
  }
}

template <int kVec>
cudaError_t launch(const float* A, const float* w, float* M, int B, int m, int n,
                   cudaStream_t stream) {
  constexpr int kBytes = sizeof(Smem);  // above the 48 KB static limit
  cudaError_t err = cudaFuncSetAttribute(gram_kernel<kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  const int tiles = (m + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, B);
  gram_kernel<kVec><<<grid, kThreads, kBytes, stream>>>(A, w, M, m, n);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` of `device`.  Returns cudaGetLastError()
// after the launch (0 on success); the caller owns every buffer.
extern "C" int sypha_gram_f32(const float* A, const float* w, float* M, int B, int m, int n,
                              int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = n % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  err = aligned ? launch<4>(A, w, M, B, m, n, stream) : launch<1>(A, w, M, B, m, n, stream);
  return static_cast<int>(err);
}

// Batched column-scaled Gram matrices on Hopper (sm_90a):
//
//     M[b, i, j] = sum_k (A_b[i, k] * w[b, k]) * (A_b[j, k] * w[b, k])
//
// A: [m, n] f32 shared by every lane (A_b = A, lane stride 0), [B, m, n]
// f32 with a matrix per lane (A_b = A + b m n, lane stride m n), or [G, m, n]
// f32 with one matrix per group of L consecutive lanes (A_b = A + (b / L) m n,
// the grouped shared-matrix batch); w: [B, n] f32 (B = G L); M: [B, m, m] f32.
//
// Replaces the Pallas TPU kernel sypha_tpu/ops/pallas_gram.py:pallas_gram,
// which formed the same matrices from a materialised [B, m, n] Aw = A * w
// with a dot_general at "highest" precision; on the TPU that f32 product is
// itself several bf16 passes of the matrix unit.
//
// What bounds it on this card: per lane the kernel does 2 m^2 n FLOPs and
// reads n floats of w and m n floats of A.  A shared A is read by every lane
// and stays in the 50 MB L2, so only one copy crosses HBM.  A per-lane A
// crosses HBM once per lane, 4 B m n bytes in all (about 710 MB at 64 lanes
// of 504 x 5504); the lane's tiles are neighbours on grid.x, so they run
// together and share each row block through L2.  A grouped A crosses HBM
// once per group: a group's lanes are consecutive on grid.y, so they run
// close together and read their matrix from L2.  At the main path's shapes
// (m = 200, n = 1280 and m = 504, n = 5504) that is still 50-125 FLOPs per
// byte for a per-lane A and hundreds for a shared one, so it is bound by
// arithmetic.  fp32 FMAs on the CUDA cores give about 67 TFLOP/s; the bf16
// tensor cores give 989.  The f32 Cholesky that consumes M needs products
// good to f32 (TF32 or a single bf16 pass breaks it).
//
// Three paths, chosen by the caller (ops/gram.py) per launch:
//
//  * bf16x6, any f32 A.  Each scaled operand x = A[i, k] * w[b, k], rounded
//    to f32 as the plain version rounds it, is split exactly into three bf16
//    pieces hi + mid + lo (bf16 has f32's exponent range and 3 x 8 bits of
//    significand cover f32's 24).  The six products hi.hi, hi.mid, mid.hi,
//    hi.lo, lo.hi, mid.mid are exact in the tensor core's f32 accumulator;
//    the dropped ones are below 2^-23 of each term.  Products that fall in
//    the f32 denormal range (the tensor cores may flush them) are below
//    2^-126, which for |A| >= 1 and w >= 1e-15 (the IPM's clamp on d2) is
//    below 2^-26 of the term they belong to.
//  * bf16x3, when every entry of A equals its bf16 rounding (the 0/+-1 rows
//    of an SCP standard form [A | -I], small-integer cut rows; the caller
//    decides once per solve).  Then M = A diag(w^2) A^T with the left
//    operand A itself, one bf16 plane with no split, and the right operand
//    u[j, k] = A[j, k] * fl(w[k] w[k]), formed in f32 while staging and split
//    exactly into hi + mid + lo: three products A.lo, A.mid, A.hi, none
//    dropped, each exact in f32.  The only roundings are fl(w w) (at most
//    2^-24 relative), A fl(w^2) for entries other than 0, +-1 and powers of
//    two, and the sums.  With d2 clamped to [1e-30, 1e30] (w = 0 on fixed
//    columns is exact) u's lo piece is at least about 2^-16 1e-30 = 1.5e-35,
//    above f32's 2^-126 = 1.2e-38, so no kept product is a denormal that
//    the tensor cores could flush.  Half the MMAs of bf16x6, and one split
//    and one conversion per element where bf16x6 has two splits.
//  * split-k, either product path, when the lanes' lower tiles do not fill
//    the card (B = 1 and 2 at m <= 1024: 10 CTAs at m = 200, 36 at m = 504,
//    on 132 SMs).  grid.z cuts the k chunks into `splits` slices of nearly
//    equal length (ops/gram.py:_plan picks about two CTAs a SM, each slice
//    8 to 64 chunks long where n allows); each CTA writes its tile's
//    partial sum over its slice to a workspace [splits, B, tiles, 64, 64]
//    f32 that the caller allocates, and a second kernel sums the partials
//    of each element in the fixed order 0 .. splits - 1 with f32
//    round-to-nearest adds and writes M and its mirror as the one-pass
//    epilogue does.  No atomics, so two calls give the same bits.  With
//    splits == 1 the kernel writes M itself, exactly as without split-k.
//
// Common to all paths:
//  * mma.sync.m16n8k16 bf16 -> f32, fed by ldmatrix.  The tensor cores add
//    with truncation, not round-to-nearest, so a sum kept in the MMA
//    accumulator drifts low by about an ulp per MMA (3e-5 relative at
//    n = 5504).  Each 16-wide k block of each fragment therefore sums its
//    products into a fresh accumulator, smallest first, so only the last
//    MMA truncates at the block's scale, and the block is added to the
//    running sum in f32 with round-to-nearest.
//  * SYRK: only the lower-triangle 64 x 64 tiles run (grid.x walks
//    T(T+1)/2 tiles, grid.y the lanes).  An off-diagonal tile writes its
//    sum to M[b, i, j] and M[b, j, i]; a diagonal tile writes its lower
//    half to both places, so M == M^T bit for bit.  A diagonal tile copies
//    one side of A; bf16x6 splits it once (both operands are A w), bf16x3
//    makes both of its operands (A and u) from that side.
//  * The column scale is applied and the split made while staging, so the
//    [B, m, n] Aw temporary never exists in device memory.  Rows past m and
//    k past n stage zeros, so any m, n and B <= 65535 work.  Each element
//    is summed in one fixed order, run to run.
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
// written with coalesced rows.  Shared memory a block: 53,376 bytes for
// bf16x6 (two raw chunks, two sides x three bf16 planes twice), 41,088 for
// bf16x3 (one plane of A and three of u twice).
//
// What bounds it now (H100 80GB HBM3 at 700 W).  At 64 lanes of 504 x
// 5504, bf16x6 takes 2.5 ms a call: the MMA stream alone 1.7 ms (5.9e11
// tensor-core FLOP, 344 TFLOP/s of the 989 bf16 peak), the copies and the
// split alone 1.3 ms, hiding only partly behind it (a 128 x 64 tile and a
// tighter register budget measured no faster).  bf16x3 takes 1.78 ms
// there, 75% of the f32 FLOP bound: half the MMAs, and one split where
// bf16x6 has two.  At one lane of 200 x 1280, split-k's 17 us of device
// time are two launches and 100 CTAs walking ten chunks each, and one f32
// cuBLAS GEMM (12.5 us) is still faster; at 504 x 5504 and 1024 x 11264
// split-k takes 0.05 and 0.25 ms, under cuBLAS.  wgmma is the lever left
// for both product paths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

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
constexpr int kReduceThreads = 256;     // split-k reduction: 16 elements each

struct Raw {  // one chunk as copied from device memory
  float a[2][kTile][kChunk];  // [side][row][k]
  float w[kChunk];
};
struct Split6 {  // bf16x6: one chunk of A w, both sides, in bf16 planes (raw bits)
  uint16_t x[2][kPlanes][kTile][kRowPitch];  // [side][plane][row][k]
};
struct Split3 {  // bf16x3: the left side's A, the right side's u = A w^2 split
  uint16_t a[kTile][kRowPitch];          // [row][k]
  uint16_t u[kPlanes][kTile][kRowPitch];  // [plane][row][k]
};
template <bool kExact>
struct Pipe {
  Raw raw[2];
  std::conditional_t<kExact, Split3, Split6> split[2];
};
struct Epilogue {
  float c[kTile][kOutPitch];
};
template <bool kExact>
union Smem {
  Pipe<kExact> pipe;
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

// lower-triangle tile t -> (ti, tj), tj <= ti
__device__ __forceinline__ void tile_coords(int t, int& ti, int& tj) {
  ti = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  while (ti * (ti + 1) / 2 > t) --ti;
  tj = t - ti * (ti + 1) / 2;
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

// Two floats split exactly into hi + mid + lo, packed bf16 pairs.  The
// subtractions are exact and never fused with a multiplication.
__device__ __forceinline__ void split_pair(float2 x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __float22bfloat162_rn(x);
  const float2 r = make_float2(x.x - __low2float(h), x.y - __high2float(h));
  const __nv_bfloat162 md = __float22bfloat162_rn(r);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r.x - __low2float(md), r.y - __high2float(md));
  hi = bits(h);
  mid = bits(md);
  lo = bits(l);
}

// Four consecutive floats split into the planes hi, mid, lo at the same offset.
__device__ __forceinline__ void store_split(uint16_t* hi, uint16_t* mid, uint16_t* lo, float4 x) {
  uint32_t h0, m0, l0, h1, m1, l1;
  split_pair(make_float2(x.x, x.y), h0, m0, l0);
  split_pair(make_float2(x.z, x.w), h1, m1, l1);
  *reinterpret_cast<uint2*>(hi) = make_uint2(h0, h1);
  *reinterpret_cast<uint2*>(mid) = make_uint2(m0, m1);
  *reinterpret_cast<uint2*>(lo) = make_uint2(l0, l1);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}

// Thread t splits the 4-float group t % kQuads of every (kThreads /
// kQuads)-th row from t / kQuads on.
constexpr int kRowStep = kThreads / kQuads;
static_assert(kTile % kRowStep == 0, "split mapping");

// bf16x6: x = A * w, rounded to f32 as in the plain version (__fmul_rn),
// split into hi + mid + lo on each side (one side on a diagonal tile).
__device__ __forceinline__ void split_chunk(Split6& s, const Raw& r, bool diag) {
  const int q = threadIdx.x % kQuads;
  const float4 wq = *reinterpret_cast<const float4*>(&r.w[4 * q]);
  for (int side = 0; side < (diag ? 1 : 2); ++side) {
#pragma unroll
    for (int step = 0; step < kTile / kRowStep; ++step) {
      const int row = threadIdx.x / kQuads + step * kRowStep;
      const float4 x = mul4(*reinterpret_cast<const float4*>(&r.a[side][row][4 * q]), wq);
      store_split(&s.x[side][0][row][4 * q], &s.x[side][1][row][4 * q],
                  &s.x[side][2][row][4 * q], x);
    }
  }
}

// bf16x3: the left side's A as one bf16 plane (exact by the caller's
// check), and u = A * fl(w * w) of the right side (the left side's rows on
// a diagonal tile) split into hi + mid + lo.
__device__ __forceinline__ void split_chunk(Split3& s, const Raw& r, bool diag) {
  const int q = threadIdx.x % kQuads;
  const float4 wq = *reinterpret_cast<const float4*>(&r.w[4 * q]);
  const float4 w2 = mul4(wq, wq);
  const int u_side = diag ? 0 : 1;
#pragma unroll
  for (int step = 0; step < kTile / kRowStep; ++step) {
    const int row = threadIdx.x / kQuads + step * kRowStep;
    const float4 a = *reinterpret_cast<const float4*>(&r.a[0][row][4 * q]);
    *reinterpret_cast<uint2*>(&s.a[row][4 * q]) =
        make_uint2(bits(__float22bfloat162_rn(make_float2(a.x, a.y))),
                   bits(__float22bfloat162_rn(make_float2(a.z, a.w))));
    const float4 u = mul4(*reinterpret_cast<const float4*>(&r.a[u_side][row][4 * q]), w2);
    store_split(&s.u[0][row][4 * q], &s.u[1][row][4 * q], &s.u[2][row][4 * q], u);
  }
}

// The warp's 32 x 32 quarter: acc += the six kept products of one chunk.
__device__ __forceinline__ void mma_chunk(float (&acc)[2][4][4], const Split6& s, int wy, int wx,
                                          bool diag) {
  const int lane = threadIdx.x % 32;
  const int j_side = diag ? 0 : 1;
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

// The warp's 32 x 32 quarter: acc += A.lo + A.mid + A.hi of one chunk.
__device__ __forceinline__ void mma_chunk(float (&acc)[2][4][4], const Split3& s, int wy, int wx,
                                          bool) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < kChunk; ks += 16) {
    uint32_t a[2][4];            // [m16 fragment]
    uint32_t bf[kPlanes][2][4];  // [plane][pair of n8 fragments]
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      ldmatrix_x4(a[f], &s.a[32 * wy + 16 * f + lane % 16][ks + (lane / 16) * 8]);
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        ldmatrix_x4(bf[p][f],
                    &s.u[p][32 * wx + 16 * f + (lane / 16) * 8 + lane % 8][ks + ((lane / 8) % 2) * 8]);
      }
    }
#pragma unroll
    for (int fi = 0; fi < 2; ++fi) {
#pragma unroll
      for (int fj = 0; fj < 4; ++fj) {
        const int g = fj / 2, h = 2 * (fj % 2);
        // a fresh sum per k16, smallest first, as in bf16x6
        float d[4] = {};
        mma_bf16(d, a[fi], bf[2][g][h], bf[2][g][h + 1]);  // A.lo
        mma_bf16(d, a[fi], bf[1][g][h], bf[1][g][h + 1]);  // A.mid
        mma_bf16(d, a[fi], bf[0][g][h], bf[0][g][h + 1]);  // A.hi
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[fi][fj][e] += d[e];
      }
    }
  }
}

// Write the tile at (i0, j0) of Mb from `out`, and its mirror at (j0, i0);
// a diagonal tile takes its lower half both ways.  kN threads, coalesced rows.
template <int kN>
__device__ __forceinline__ void write_tile(float* __restrict__ Mb, const Epilogue& out, int i0,
                                           int j0, bool diag, int m) {
  const int c = threadIdx.x % kTile;
  for (int r = threadIdx.x / kTile; r < kTile; r += kN / kTile) {
    const int gi = i0 + r;
    const int gj = j0 + c;
    if (gi < m && gj < m) {
      Mb[static_cast<size_t>(gi) * m + gj] = (!diag || r >= c) ? out.c[r][c] : out.c[c][r];
    }
    const int mi = j0 + r;
    const int mj = i0 + c;
    if (!diag && mi < m && mj < m) Mb[static_cast<size_t>(mi) * m + mj] = out.c[c][r];
  }
}

// One lower tile (blockIdx.x) of lane blockIdx.y over k slice blockIdx.z of
// gridDim.z.  With one slice the tile goes to M; with more, its partial sum
// goes to partial[blockIdx.z][blockIdx.y][blockIdx.x] (64 x 64, row-major).
template <int kVec, bool kExact>
__global__ void __launch_bounds__(kThreads)
    gram_kernel(const float* __restrict__ A, const float* __restrict__ w,
                float* __restrict__ M, float* __restrict__ partial, int m, int n,
                long long a_stride, int lanes_per_matrix) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Smem<kExact>& smem = *reinterpret_cast<Smem<kExact>*>(smem_bytes);

  int ti, tj;
  tile_coords(blockIdx.x, ti, tj);
  const bool diag = ti == tj;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const int b = blockIdx.y;
  const float* Ab = A + static_cast<size_t>(b / lanes_per_matrix) * a_stride;
  const float* wb = w + static_cast<size_t>(b) * n;

  const int warp = threadIdx.x / 32;
  const int wy = warp / 2;  // rows 32 wy .. of the tile (i side)
  const int wx = warp % 2;  // cols 32 wx .. of the tile (j side)
  // on a diagonal tile the upper-right quarter is never read
  const bool active = !(diag && wx > wy);

  // this slice's chunks [c0, c0 + chunks) of the k range
  const long long all_chunks = (n + kChunk - 1) / kChunk;
  const int c0 = static_cast<int>(blockIdx.z * all_chunks / gridDim.z);
  const int chunks = static_cast<int>((blockIdx.z + 1) * all_chunks / gridDim.z) - c0;
  const int k_base = c0 * kChunk;

  // chunk c is copied into raw[c % 2] two steps ahead, split into
  // split[c % 2] one step ahead, and multiplied in step c
  Pipe<kExact>& pipe = smem.pipe;
  load_chunk<kVec>(pipe.raw[0], Ab, wb, i0, j0, diag, m, n, k_base);
  cp_async_commit();
  load_chunk<kVec>(pipe.raw[1], Ab, wb, i0, j0, diag, m, n, k_base + kChunk);
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
      load_chunk<kVec>(pipe.raw[c % 2], Ab, wb, i0, j0, diag, m, n, k_base + (c + 2) * kChunk);
      cp_async_commit();
    }
    // MMAs first: the tensor cores work through them while the warp splits
    if (active) mma_chunk(acc, pipe.split[c % 2], wy, wx, diag);
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

  if (gridDim.z == 1) {
    write_tile<kThreads>(M + static_cast<size_t>(b) * m * m, smem.out, i0, j0, diag, m);
    return;
  }
  // the reduction reads only the lower half of a diagonal tile, so its
  // upper-right quarter (never computed) goes out as it is
  float* P = partial +
             ((static_cast<size_t>(blockIdx.z) * gridDim.y + b) * gridDim.x + blockIdx.x) *
                 (kTile * kTile);
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    P[idx] = smem.out.c[idx / kTile][idx % kTile];
  }
}

// Split-k's second pass: tile blockIdx.x of lane blockIdx.y summed over its
// `splits` partials in the order 0, 1, .., splits - 1, then written to M
// and its mirror as the one-pass epilogue writes them.
__global__ void __launch_bounds__(kReduceThreads)
    gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ M, int m, int splits) {
  constexpr int kPer = kTile * kTile / kReduceThreads;
  __shared__ Epilogue out;
  const size_t slice = static_cast<size_t>(gridDim.y) * gridDim.x * (kTile * kTile);
  const float* P =
      partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * (kTile * kTile);
  float v[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) v[e] = P[threadIdx.x + e * kReduceThreads];
  // four slices' loads in flight before their adds, which stay in order
  int z = 1;
  for (; z + 4 <= splits; z += 4) {
    float t[4][kPer];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) t[j][e] = P[(z + j) * slice + threadIdx.x + e * kReduceThreads];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) v[e] += t[j][e];
    }
  }
  for (; z < splits; ++z) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) v[e] += P[z * slice + threadIdx.x + e * kReduceThreads];
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int idx = threadIdx.x + e * kReduceThreads;
    out.c[idx / kTile][idx % kTile] = v[e];
  }
  __syncthreads();
  int ti, tj;
  tile_coords(blockIdx.x, ti, tj);
  write_tile<kReduceThreads>(M + static_cast<size_t>(blockIdx.y) * m * m, out, ti * kTile,
                             tj * kTile, ti == tj, m);
}

template <int kVec, bool kExact>
cudaError_t launch(const float* A, const float* w, float* M, float* partial, int B, int m, int n,
                   long long a_stride, int lanes_per_matrix, int splits, int device,
                   cudaStream_t stream) {
  constexpr int kBytes = sizeof(Smem<kExact>);
  // the shared-memory limit is set once per device and instance (bit d of
  // `ready` for device d; devices past 63 set it every time)
  static std::atomic<uint64_t> ready{0};
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_kernel<kVec, kExact>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  const int tiles = (m + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, B, splits);
  gram_kernel<kVec, kExact><<<grid, kThreads, kBytes, stream>>>(A, w, M, partial, m, n, a_stride,
                                                                lanes_per_matrix);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  gram_reduce_kernel<<<dim3(grid.x, B), kReduceThreads, 0, stream>>>(partial, M, m, splits);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` of `device`.  Lane b reads the matrix at
// A + (b / lanes_per_matrix) a_stride: `a_stride` is the distance in floats
// between two consecutive matrices (0 for one A shared by every lane, m n
// otherwise) and `lanes_per_matrix` the number of consecutive lanes that
// share one (1 for one A per lane, L for groups of L lanes).  `exact` != 0
// takes the bf16x3 path, which is right only when every entry of A equals
// its bf16 rounding; 0 takes bf16x6.  `splits` > 1 cuts the k range into
// that many slices, with `partial` a workspace of splits B T(T+1)/2 64 64
// floats (T = ceil(m / 64)); with splits == 1 `partial` is not read.
// Returns cudaGetLastError() after the launches (0 on success),
// cudaErrorInvalidValue for lanes_per_matrix < 1, splits outside [1, 65535]
// or a missing workspace; the caller owns every buffer.  Switches the
// calling thread to `device` only when it is on another one.
extern "C" int sypha_gram_f32(const float* A, const float* w, float* M, float* partial, int B,
                              int m, int n, long long a_stride, int lanes_per_matrix, int splits,
                              int exact, int device, cudaStream_t stream) {
  if (lanes_per_matrix < 1 || splits < 1 || splits > 65535 || (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies need every row of every lane's A and of w on a 16-byte
  // boundary: n % 4 == 0 and a_stride % 4 == 0 keep the base's alignment
  const bool aligned = n % 4 == 0 && a_stride % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (aligned) {
    err = exact ? launch<4, true>(A, w, M, partial, B, m, n, a_stride, lanes_per_matrix, splits,
                                  device, stream)
                : launch<4, false>(A, w, M, partial, B, m, n, a_stride, lanes_per_matrix, splits,
                                   device, stream);
  } else {
    err = exact ? launch<1, true>(A, w, M, partial, B, m, n, a_stride, lanes_per_matrix, splits,
                                  device, stream)
                : launch<1, false>(A, w, M, partial, B, m, n, a_stride, lanes_per_matrix, splits,
                                   device, stream);
  }
  return static_cast<int>(err);
}

// Multi-head softmax attention on the packed (B, S, H*Dh) layout.
//
// Replaces: egotap_tpu/ops/attention.py `_attn_kernel_packed` /
// `_attention_pallas_packed` (per (batch, head): softmax(q k^T / sqrt(Dh)) v
// with the head taken as a column block of the packed last dim).
//
// Numerics follow the TPU kernel: scores are f32 dot products times the
// scale; p = exp(s - max) / sum with each row's max and sum over all S
// keys in f32; p v accumulates in f32; the output is rounded once to the
// input dtype. In bf16, p is normalised BEFORE it is rounded to bf16, so
// a row's max and sum must be known before any of its p: two passes over
// the keys. In f32 nothing is rounded between the softmax and p v, so the
// one-pass online form (flash-style: a running max m and sum l per row,
// the f32 context scaled by exp(m_old - m_new) when the max moves and
// divided by l once at the end) is the same function up to f32 rounding:
// exp(a) exp(b) for exp(a + b), and one division moved after the sum, a
// few ulps where the limit allows hundreds.
//
// Bound on the H100: at the Grid-ViT's shapes (B=32, S=576, H=8, Dh=128,
// bf16) one launch is 43.5 GFLOP and 151 MB, so the tensor-core bound
// (~44 us) and the memory bound (~45 us) are about equal. In f32 one TF32
// product rounds each operand to 11 bits (~4e-4 off, far outside the
// kernel's limit), so each f32 product is three TF32 products (3xTF32,
// below): 130.5 GFLOP at the 495 TFLOP/s of dense TF32, ~264 us (on the
// CUDA cores the same 43.5 GFLOP at 67 TFLOP/s take ~650 us).
//
// Design: one block per (batch, head, 64-query tile), 2304 blocks at the
// main-path shape. The block indexes the packed layout directly (row
// stride H*Dh, head offset h*Dh): no transposes.
//  * bf16: one warpgroup (4 warps x 16 query rows) a block; both products
//    run on the tensor cores with wgmma (bf16 in, f32 accumulate; a bf16 x
//    bf16 product is exact in f32, so only the summation order differs
//    from an f32 dot). No score tile in shared memory: a 64 x 64 score
//    chunk is the warpgroup's accumulator, and the exact softmax takes two
//    passes over the keys. Pass 1 computes q k^T chunk by chunk and keeps
//    each row's running max and sum; pass 2 computes the same scores
//    again, normalises and rounds p in registers, and feeds it to p v as
//    wgmma's register operand (the accumulator layout of two adjacent
//    8-key tiles is the A layout of one 16-key step). q k^T is thus
//    computed twice: 65 GFLOP a launch. K and V tiles arrive by 16-byte
//    cp.async in a ring of 4 (K only in pass 1), written in the 128-byte
//    swizzle that the wgmma descriptors name; K is the K-major B operand
//    of m64n64k16, V the MN-major (transposed) B operand of m64n128k16,
//    both read by the tensor cores straight from shared memory. 65 KB of
//    shared memory and 168 registers a thread: 3 blocks an SM. The kernel
//    is bound by instruction issue and latency, not by bytes: with 12
//    warps an SM, the products, the softmax and the tile loads of one
//    warpgroup follow each other, and only the SM's other two blocks fill
//    the gaps. So every instruction of the loader counts (each thread's
//    source and swizzled destination are worked out once; a tile is 8
//    cp.async with constant offsets), p / sum is a multiply by 1 / sum
//    with one exact correction step (the same bits as the division).
//    Next steps: the next chunk's scores in flight under the softmax
//    (needs a second score accumulator, more than 168 registers today;
//    and nothing but wgmma may then write an accumulator while a wgmma is
//    in flight, or ptxas serializes them all: its note C7515), TMA tile
//    loads, larger query tiles with warpgroups out of step. No limit on S.
//  * f32: both products on the tensor cores in 3xTF32 (CUTLASS's
//    OpMultiplyAddFastF32): each f32 operand x is big + small, big x
//    rounded to TF32 and small = x - big, and a product is small.big +
//    big.small + big.big with mma.sync m16n8k8 (f32 accumulate): about 22
//    of f32's 24 bits. One pass over the keys in the online form above, no
//    score tile: 4 warps a block, each 16 query rows with a 16 x 64 score
//    chunk and its 16 x 128 context in registers; p goes from the score C
//    fragment to the p v A fragment with no shuffle (keys 2t and 2t + 1
//    as k indices t and t + 4). The tensor cores' f32 sums do not round to
//    nearest, and a chain of them drifts with its length (a context summed
//    on through all keys left the kernel's limit from S = 576 on), so each
//    16-d step pair of q k^T and each 64-key chunk of p v sums into fresh
//    accumulators that the CUDA cores add on. Q, one K and
//    one V tile (64 x 128 f32) in 96 KB, 2 blocks an SM; K and V chunks
//    arrive by 16-byte cp.async, each under the other product; tile rows
//    are unpadded with permuted 16-byte chunks, so every 128-bit fragment
//    load is free of bank conflicts. Operands are split as they are
//    loaded: every warp splits the whole K and V tiles (splitting them
//    once per block needs two more tile planes: 1 block an SM).
//    Exp and division are expf and IEEE. No limit on S.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <cmath>

namespace {

constexpr int DH = 128;       // head dim
constexpr int QT = 64;        // query rows per block
constexpr int KC = 64;        // keys per shared-memory chunk

// --------------------------------------------------------------- bf16 path

typedef __nv_bfloat16 bf16;

constexpr int RING = 4;           // tiles in the cp.async ring
constexpr int BF_THREADS = 128;   // one warpgroup: 4 warps, 16 query rows each
constexpr int BF_QT = 64;         // query rows per block

// A K or V tile in shared memory: 64 rows x 128 bf16 as two panels of 64
// columns (8 KB each); a panel row is 128 bytes, and its 16-byte chunk c
// sits at chunk c ^ (row % 8): the 128-byte swizzle the wgmma descriptors
// name, which wants every tile aligned to 1024 bytes
constexpr int WG_PANEL = KC * 128;            // bytes
constexpr int WG_TILE = 2 * WG_PANEL;
constexpr int BF_SMEM = RING * WG_TILE + 1024;   // + room to align the ring

// 16 bytes global -> shared without passing through registers; with
// src_bytes = 0 nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// e / l correctly rounded, given r = 1 / l correctly rounded: one Newton
// step on the quotient with an exact remainder, which is the fast path of
// IEEE division without its range checks (e is 0 or in [2^-126, 1], l in
// [1, S], so nothing under- or overflows)
__device__ __forceinline__ float div_by(float e, float l, float r) {
  const float q = e * r;
  return fmaf(fmaf(-q, l, e), r, q);
}

// scores = acc * scale, and -inf for keys at or past s (only a chunk that
// starts at key0 and reaches past the end holds any: the last one);
// element e of key tile nt is key key0 + 8 nt + 2t + (e & 1)
__device__ __forceinline__ void scale_mask(float (&acc)[8][4], float scale, int key0,
                                           int t, int s) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] *= scale;
  if (key0 + KC > s) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + 8 * nt + 2 * t + (e & 1) >= s) acc[nt][e] = __int_as_float(0xff800000);
  }
}

// d (64 x 64, f32, the four warps' mma.sync C fragments stacked) (+)= a (64
// x 16 from registers: the four warps' A fragments stacked) times b (16 x
// 64 from shared memory, K-major: keys x Dh rows as stored)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128) += a (64 x 16 from registers) times b (16 x 128 from shared
// memory, MN-major: the transpose bit set, V's (key, Dh) rows as stored)
__device__ __forceinline__ void wgmma_m64n128k16_t(float (&d)[16][4], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: address, leading and
// stride byte offsets in 16-byte units
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)lbo << 16) | ((uint64_t)sbo << 32) |
         (1ull << 62);
}

__global__ void __launch_bounds__(BF_THREADS, 3)
attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      int s, int heads, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;

  const int h = blockIdx.y, b = blockIdx.z;
  const int ld = heads * DH;
  const int64_t base = (int64_t)b * s * ld + (int64_t)h * DH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;                  // mma fragment coords
  const int row_a = blockIdx.x * BF_QT + 16 * warp + g;  // and row_a + 8

  // The tile stream: K chunks 0..nc-1 for pass 1, then K0 V0 K1 V1 .. for
  // pass 2. Tile i lives in ring slot i % RING; one cp.async group a tile.
  const int nc = (s + KC - 1) / KC;
  const int ntiles = 3 * nc;
  // This thread's share of a tile: 16-byte chunk lc of rows lr, lr + 8, ..,
  // lr + 56, whose swizzled places are 1024 bytes apart (the swizzle term
  // depends on the row only through row % 8)
  const int lr = tid / 16, lc = tid % 16;
  const uint32_t ldst = ring + (lc >> 3) * WG_PANEL + lr * 128 + (((lc & 7) ^ (lr & 7)) << 4);
  const int64_t lsrc = base + (int64_t)lr * ld + 8 * lc;
  int issued = 0, taken = 0;
  auto issue = [&]() {
    if (issued < ntiles) {
      const int u = issued - nc;
      const int row0 = KC * (u < 0 ? issued : u >> 1);
      const bf16* src = ((u >= 0 && (u & 1)) ? v : k) + lsrc + (int64_t)row0 * ld;
      const uint32_t dst = ldst + (issued % RING) * WG_TILE;
      if (row0 + KC <= s) {
#pragma unroll
        for (int j = 0; j < 8; ++j) cp_async16(dst + 1024 * j, src + (int64_t)(8 * j) * ld, 16);
      } else {                                          // rows past s: zeros
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool in = row0 + lr + 8 * j < s;
          cp_async16(dst + 1024 * j, in ? src + (int64_t)(8 * j) * ld : k, in ? 16 : 0);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");   // also when empty
    ++issued;
  };
  // the next tile of the stream, landed and visible to the block and to the
  // tensor cores (which read through the async proxy); frees the slot of
  // the tile before it (every warp has waited for its products) and
  // refills that
  auto take = [&]() -> uint32_t {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(RING - 2) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    issue();
    return ring + (taken++ % RING) * WG_TILE;
  };
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) issue();

  // this warp's Q rows as mma A fragments, once, straight from global
  // memory: stacked over the four warps they are wgmma's 64 x 16 A operand
  uint32_t qf[8][4];
  {
    const bf16* qa = q + base + (int64_t)row_a * ld + 2 * t;
    const bool in_a = row_a < s, in_b = row_a + 8 < s;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      qf[ks][0] = in_a ? *reinterpret_cast<const uint32_t*>(qa + 16 * ks) : 0u;
      qf[ks][1] = in_b ? *reinterpret_cast<const uint32_t*>(qa + 8 * ld + 16 * ks) : 0u;
      qf[ks][2] = in_a ? *reinterpret_cast<const uint32_t*>(qa + 16 * ks + 8) : 0u;
      qf[ks][3] = in_b ? *reinterpret_cast<const uint32_t*>(qa + 8 * ld + 16 * ks + 8) : 0u;
    }
  }
  // acc = q times the transpose of one K tile (64 x 64): 8 k-steps of 16
  // over Dh, 4 a panel and 32 bytes apart in it; 8-row groups 1024 bytes
  // apart (the stride offset; the leading offset is not used here)
  auto scores = [&](float (&acc)[8][4], uint32_t tile) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_m64n64k16(acc, qf[ks], wg_desc(tile + (ks >> 2) * WG_PANEL + (ks & 3) * 32, 1, 64),
                      ks > 0);
    wgmma_commit();
    wgmma_wait0();
  };

  // ---- pass 1: each row's max and sum over all keys. Rows g and g + 8
  // live in this thread's quad; the max is exact, the sum is rescaled when
  // the max moves (a few f32 ulps from sum exp(x - final max), the same
  // order as a change of summation order)
  float m[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
  float l[2] = {0.f, 0.f};
  float acc[8][4];
  for (int c = 0; c < nc; ++c) {
    scores(acc, take());
    scale_mask(acc, scale, KC * c, t, s);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float cm = acc[0][2 * hi];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) cm = fmaxf(cm, fmaxf(acc[nt][2 * hi], acc[nt][2 * hi + 1]));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
      const float mn = fmaxf(m[hi], cm);       // finite: key 0 is never masked
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        sum += expf(acc[nt][2 * hi] - mn) + expf(acc[nt][2 * hi + 1] - mn);
      l[hi] = l[hi] * expf(m[hi] - mn) + sum;
      m[hi] = mn;
    }
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
  }
  const float rl[2] = {1.f / l[0], 1.f / l[1]};

  // ---- pass 2: the same scores again (same instructions, same bits),
  // p = exp(x - max) / sum rounded to bf16; the C fragments of key tiles
  // 2i and 2i+1 are the A fragment of k-step i of p v, so p never leaves
  // the registers
  float o[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  for (int c = 0; c < nc; ++c) {
    scores(acc, take());
    scale_mask(acc, scale, KC * c, t, s);
    uint32_t p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nt = 2 * i + (j >> 1), hi = j & 1;
        p[i][j] = pack_bf16(div_by(expf(acc[nt][2 * hi] - m[hi]), l[hi], rl[hi]),
                            div_by(expf(acc[nt][2 * hi + 1] - m[hi]), l[hi], rl[hi]));
      }
    const uint32_t v_tile = take();
    // k-step i of p v: keys 16i..16i+15 are two 8-row groups (1024 bytes
    // apart, the stride offset) of both 64-column panels (one panel apart,
    // the leading offset)
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wgmma_m64n128k16_t(o, p[i], wg_desc(v_tile + i * 2048, WG_PANEL / 16, 64), 1);
    wgmma_commit();
    wgmma_wait0();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");   // only empty groups left

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = row_a + 8 * hi;
    if (row >= s) continue;
    bf16* orow = out + base + (int64_t)row * ld + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nt) =
          __floats2bfloat162_rn(o[nt][2 * hi], o[nt][2 * hi + 1]);
  }
}

// ---------------------------------------------------------------- f32 path

constexpr int F_THREADS = 128;                  // 4 warps, 16 query rows each
constexpr int F_ROW = DH / 4;                   // float4 chunks in a 512-byte tile row
constexpr int F_TILE = KC * F_ROW;              // float4s in a 64 x 128 f32 tile (32 KB)
constexpr int F_SMEM = 16 * 3 * F_TILE;         // Q, K and V tiles: 96 KB

// How a tile's row r permutes its 16-byte chunks (chunk c at c ^ f(r)), so
// that every 128-bit fragment load below is free of bank conflicts: Q and
// K f = 4 (r % 2) (rows g of a quad pair read chunks 4kp + t), V f = 2 ((r
// / 2) % 4) (rows 2t, 2t + 1 read chunks 8mq + g)
enum { F_SWZ_QK, F_SWZ_V };

// rows row0 .. row0 + 63 of src (row stride ld floats) into the tile at
// dst by 16-byte cp.async (not committed); rows at or past s are zeros.
// Thread i copies chunk i % 32 of rows i / 32 + 4n.
template <int SWZ>
__device__ __forceinline__ void load_tile_f32(uint32_t dst, const float* src, int row0,
                                              int s, int ld) {
  const int c = threadIdx.x % 32, r0 = threadIdx.x / 32;
#pragma unroll
  for (int n = 0; n < KC / 4; ++n) {
    const int r = r0 + 4 * n;
    const int f = SWZ == F_SWZ_QK ? 4 * (r % 2) : 2 * ((r / 2) % 4);
    const bool in = row0 + r < s;
    cp_async16(dst + 16 * (r * F_ROW + (c ^ f)),
               in ? src + (int64_t)(row0 + r) * ld + 4 * c : src, in ? 16 : 0);
  }
}

// x = big + small for 3xTF32, as CUTLASS's OpMultiplyAddFastF32 splits it:
// big is x rounded to TF32 (to nearest, ties away from zero: the bits of
// cvt.rna.tf32.f32), small = x - big (exact) goes in unrounded, and the
// tensor cores read its top 19 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b on the tensor cores: m16n8k8, TF32 operands, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, small terms first: small.big + big.small + big.big
// (the small.small term is below f32's precision)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

__global__ void __launch_bounds__(F_THREADS, 2)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int s, int heads, float scale) {
  extern __shared__ float4 smem_f32[];
  const float4* const tQ = smem_f32;
  const float4* const tK = tQ + F_TILE;
  const float4* const tV = tK + F_TILE;
  const uint32_t aQ = (uint32_t)__cvta_generic_to_shared(tQ);
  const uint32_t aK = aQ + 16 * F_TILE, aV = aK + 16 * F_TILE;

  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ld = heads * DH;
  const int64_t base = (int64_t)b * s * ld + (int64_t)h * DH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;                // mma fragment coords
  const int nc = (s + KC - 1) / KC;
  const int fqk = 4 * (g % 2), fv = 2 * t;             // this thread's permutations

  load_tile_f32<F_SWZ_QK>(aQ, q + base, q0, s, ld);
  load_tile_f32<F_SWZ_QK>(aK, k + base, 0, s, ld);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // o: 16 n-tiles of 8 Dh columns; tile n, column j is Dh column
  // 32 (n / 4) + 4j + n % 4, so that one 128-bit load of a V row gives the
  // B fragments of 4 tiles
  float o[16][4], m[2], l[2];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  m[0] = m[1] = __int_as_float(0xff800000);            // -inf
  l[0] = l[1] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int key0 = KC * c;
    // K chunk c landed; every warp is done with V chunk c - 1, so V chunk
    // c may come in under the scores
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    load_tile_f32<F_SWZ_V>(aV, v + base, key0, s, ld);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    // ---- scores: rows 16 warp + g (+ 8) against keys 8n + 2t (+ 1). The
    // 16 d of step pair kp are ordered so that k index t of step 2kp + x is
    // d = 16kp + 4t + 2x and k index t + 4 is the next d: one 128-bit load
    // of a Q or K row gives a fragment pair. Each pair sums into fresh
    // accumulators, added to the scores by the CUDA cores: the tensor
    // cores' f32 sums do not round to nearest, and a chain of them drifts
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll 2
    for (int kp = 0; kp < DH / 16; ++kp) {
      const float4 qa = tQ[(16 * warp + g) * F_ROW + ((4 * kp + t) ^ fqk)];
      const float4 qb = tQ[(16 * warp + g + 8) * F_ROW + ((4 * kp + t) ^ fqk)];
      uint32_t ab[2][4], as[2][4];
      split_tf32(qa.x, ab[0][0], as[0][0]);
      split_tf32(qb.x, ab[0][1], as[0][1]);
      split_tf32(qa.y, ab[0][2], as[0][2]);
      split_tf32(qb.y, ab[0][3], as[0][3]);
      split_tf32(qa.z, ab[1][0], as[1][0]);
      split_tf32(qb.z, ab[1][1], as[1][1]);
      split_tf32(qa.w, ab[1][2], as[1][2]);
      split_tf32(qb.w, ab[1][3], as[1][3]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float4 kb = tK[(8 * n + g) * F_ROW + ((4 * kp + t) ^ fqk)];
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(part, ab[0], as[0], kb.x, kb.y);
        mma_3xtf32(part, ab[1], as[1], kb.z, kb.w);
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] += part[e];
      }
    }

    // ---- online softmax on rows g (hi = 0) and g + 8 (hi = 1): scale,
    // mask keys at or past s, move the max, p = exp(s - max) unnormalised
    float alpha[2];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] *= scale;
    if (key0 + KC > s) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * n + 2 * t + (e & 1) >= s) sc[n][e] = __int_as_float(0xff800000);
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float cm = sc[0][2 * hi];
#pragma unroll
      for (int n = 0; n < 8; ++n) cm = fmaxf(cm, fmaxf(sc[n][2 * hi], sc[n][2 * hi + 1]));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
      const float mn = fmaxf(m[hi], cm);       // finite: key0 < s is never masked
      alpha[hi] = expf(m[hi] - mn);            // 0 on the first chunk
      m[hi] = mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        sc[n][2 * hi] = expf(sc[n][2 * hi] - mn);
        sc[n][2 * hi + 1] = expf(sc[n][2 * hi + 1] - mn);
        sum += sc[n][2 * hi] + sc[n][2 * hi + 1];
      }
      l[hi] = l[hi] * alpha[hi] + sum;
    }
    // V chunk c landed; every warp is done with K chunk c, so K chunk
    // c + 1 may come in under p v
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (c + 1 < nc) {
      load_tile_f32<F_SWZ_QK>(aK, k + base, key0 + KC, s, ld);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    // ---- o = o alpha + p v. Step kk takes keys 8kk .. 8kk + 7, whose p
    // is score tile kk's C fragment; with k index t as key 2t and t + 4 as
    // key 2t + 1 that is the A fragment (c0, c2, c1, c3), with no shuffle,
    // and V's B fragment is rows 2t and 2t + 1 (p and V rows past s are 0)
    uint32_t pb[KC / 8][4], ps[KC / 8][4];
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      split_tf32(sc[kk][0], pb[kk][0], ps[kk][0]);
      split_tf32(sc[kk][2], pb[kk][1], ps[kk][1]);
      split_tf32(sc[kk][1], pb[kk][2], ps[kk][2]);
      split_tf32(sc[kk][3], pb[kk][3], ps[kk][3]);
    }
    // the chunk's p v into fresh accumulators, 4 tiles at a time (a chain
    // as long as S would drift, as above)
#pragma unroll
    for (int mq = 0; mq < 4; ++mq) {
      float part[4][4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[x][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        const float4 v0 = tV[(8 * kk + 2 * t) * F_ROW + ((8 * mq + g) ^ fv)];
        const float4 v1 = tV[(8 * kk + 2 * t + 1) * F_ROW + ((8 * mq + g) ^ fv)];
        mma_3xtf32(part[0], pb[kk], ps[kk], v0.x, v1.x);
        mma_3xtf32(part[1], pb[kk], ps[kk], v0.y, v1.y);
        mma_3xtf32(part[2], pb[kk], ps[kk], v0.z, v1.z);
        mma_3xtf32(part[3], pb[kk], ps[kk], v0.w, v1.w);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[4 * mq + x][e] = fmaf(o[4 * mq + x][e], alpha[e / 2], part[x][e]);
    }
  }

  // o / l, rows g and g + 8: tiles 4mq .. 4mq + 3 hold Dh columns 32mq +
  // 8t .. 32mq + 8t + 7 of this thread's rows (C columns 2t and 2t + 1)
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
    const int row = q0 + 16 * warp + g + 8 * hi;
    if (row >= s) continue;
    float4* orow = reinterpret_cast<float4*>(out + base + (int64_t)row * ld);
#pragma unroll
    for (int mq = 0; mq < 4; ++mq)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 2 * hi + j;
        orow[8 * mq + 2 * t + j] =
            make_float4(o[4 * mq][e] / l[hi], o[4 * mq + 1][e] / l[hi],
                        o[4 * mq + 2][e] / l[hi], o[4 * mq + 3][e] / l[hi]);
      }
  }
}

// ------------------------------------------------------------------ launch

template <typename T, typename K>
cudaError_t launch(K kernel, int threads, int rows, size_t smem, const void* q,
                   const void* k, const void* v, void* out, int b, int s,
                   int heads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + rows - 1) / rows, heads, b);
  const float scale = (float)(1.0 / sqrt((double)DH));  // as f32(1/sqrt(Dh))
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, heads, scale);
  return cudaGetLastError();
}

// the f32 kernel's 96 KB fit twice only in the largest shared-memory
// carveout
cudaError_t carve_f32() {
  return cudaFuncSetAttribute(attention_f32_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// q, k, v, out: contiguous (b, s, heads * head_dim), 16-byte aligned;
// dtype 0 = float32, 1 = bfloat16. head_dim must be 128 (the Python
// wrapper checks all of this).
extern "C" int egotap_attention_packed(const void* q, const void* k,
                                       const void* v, void* out, int b, int s,
                                       int heads, int head_dim, int dtype,
                                       void* stream) {
  if (head_dim != DH || s < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const cudaError_t err = carve_f32();
    if (err != cudaSuccess) return (int)err;
    return (int)launch<float>(attention_f32_kernel, F_THREADS, QT, F_SMEM, q, k, v,
                              out, b, s, heads, st);
  }
  if (dtype == 1)
    return (int)launch<bf16>(attention_bf16_kernel, BF_THREADS, BF_QT, BF_SMEM, q, k, v,
                             out, b, s, heads, st);
  return (int)cudaErrorInvalidValue;
}

// What the kernel of one dtype (0 = float32, 1 = bfloat16) takes of an
// SM: info[0] = blocks of it one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), info[1] = registers a
// thread, info[2] = local (spill) bytes a thread, info[3] = dynamic +
// static shared memory bytes a block, info[4] = threads a block.
extern "C" int egotap_attention_occupancy(int dtype, int* info) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const void* kernel = dtype == 0 ? (const void*)attention_f32_kernel
                                  : (const void*)attention_bf16_kernel;
  const int smem = dtype == 0 ? F_SMEM : BF_SMEM;
  const int threads = dtype == 0 ? F_THREADS : BF_THREADS;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dtype == 0) err = carve_f32();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, threads, smem);
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = smem + (int)attr.sharedSizeBytes;
  info[4] = threads;
  return (int)err;
}

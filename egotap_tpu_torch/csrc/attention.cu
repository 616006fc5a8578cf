// Multi-head softmax attention on the packed (B, S, H*Dh) layout.
//
// Replaces: egotap_tpu/ops/attention.py `_attn_kernel_packed` /
// `_attention_pallas_packed` (per (batch, head): softmax(q k^T / sqrt(Dh)) v
// with the head taken as a column block of the packed last dim).
//
// Numerics follow the TPU kernel, not flash-style online rescaling:
// scores are f32 dot products times the scale; each row's max and sum
// are exact over all S keys; p = exp(s - max) / sum is normalised BEFORE
// it is rounded to v's dtype; p v accumulates in f32; the output is
// rounded once to the input dtype.
//
// Bound on the H100: at the Grid-ViT's shapes (B=32, S=576, H=8, Dh=128,
// bf16) one launch is 43.5 GFLOP and 151 MB, so the tensor-core bound
// (~44 us) and the memory bound (~45 us) are about equal. In f32 the
// products cannot use the tensor cores without TF32 rounding, so f32 is
// bound by the 67 TFLOP/s of the CUDA cores (~650 us).
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
//  * f32: products on the CUDA cores from register micro-tiles (4x4 for
//    q k^T, 8x4 for p v) fed from padded shared memory (row pitch Dh+1).
//    The whole 64 x S f32 score tile stays in shared memory (147 KB at
//    S=576), which limits S to 640.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <cmath>

namespace {

constexpr int DH = 128;       // head dim
constexpr int QT = 64;        // query rows per block
constexpr int KC = 64;        // keys per shared-memory chunk
constexpr int THREADS = 256;
constexpr int MAX_SEQ = 640;  // the f32 wrapper's limit (score tile in smem)
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ---------------------------------------------------------------- f32 path

constexpr int PITCH = DH + 1; // padded row pitch (floats)

__device__ void load_rows_f32(float* dst, const float* __restrict__ src, int row0,
                              int nrows, int s, int ld) {
  // dst[r][d] = src[(row0 + r) * ld + d] for valid rows, 0 past the end
  for (int i = threadIdx.x; i < nrows * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    const int row = row0 + r;
    dst[r * PITCH + d] = row < s ? src[(int64_t)row * ld + d] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int s, int heads, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;                       // QT x PITCH
  float* sKV = sQ + QT * PITCH;           // KC x PITCH
  float* sS = sKV + KC * PITCH;           // QT x ld_s scores / probabilities
  const int ld_s = round_up(s, KC);

  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ld = heads * DH;
  const int64_t base = (int64_t)b * s * ld + (int64_t)h * DH;
  const int tid = threadIdx.x;

  load_rows_f32(sQ, q + base, q0, QT, s, ld);

  // ---- scores: sS[r][key] = (q_r . k_key) * scale
  {
    const int ty = tid / 16, tx = tid % 16;   // rows 4ty.., cols tx + 16c
    for (int k0 = 0; k0 < s; k0 += KC) {
      __syncthreads();                        // sKV free, sQ loaded
      load_rows_f32(sKV, k + base, k0, KC, s, ld);
      __syncthreads();
      float acc[4][4] = {};
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sQ[(4 * ty + i) * PITCH + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) bb[c] = sKV[(tx + 16 * c) * PITCH + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], bb[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + tx + 16 * c;
          if (key < s) sS[(4 * ty + i) * ld_s + key] = acc[i][c] * scale;
        }
    }
  }
  __syncthreads();

  // ---- exact softmax per row: one warp per row, rows strided by 8
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < QT; r += THREADS / 32) {
      if (q0 + r >= s) break;
      float* row = sS + r * ld_s;
      float m = __int_as_float(0xff800000);  // -inf
      for (int j = lane; j < s; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
      for (int j = lane; j < s; j += 32) {
        const float e = expf(row[j] - m);
        row[j] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      for (int j = lane; j < s; j += 32) row[j] = row[j] / sum;
    }
  }

  // ---- context: out[r][:] = sum_key p[r][key] * v[key][:]
  const int ty = tid / 32, tx = tid % 32;        // rows 8ty.., cols tx + 32c
  float acc[8][4] = {};
  for (int k0 = 0; k0 < s; k0 += KC) {
    __syncthreads();
    load_rows_f32(sKV, v + base, k0, KC, s, ld);
    __syncthreads();
    const int kn = min(KC, s - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float p[8], vv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = sS[(8 * ty + i) * ld_s + k0 + kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) vv[c] = sKV[kk * PITCH + tx + 32 * c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + 8 * ty + i;
    if (row >= s) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[base + (int64_t)row * ld + tx + 32 * c] = acc[i][c];
  }
}

size_t smem_bytes_f32(int s) {
  return sizeof(float) * ((size_t)(QT + KC) * PITCH + (size_t)QT * round_up(s, KC));
}

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

}  // namespace

// q, k, v, out: contiguous (b, s, heads * head_dim), 16-byte aligned;
// dtype 0 = float32, 1 = bfloat16. head_dim must be 128; in float32 s is
// at most MAX_SEQ, so that the score tile fits in shared memory (the
// Python wrapper checks all of this).
extern "C" int egotap_attention_packed(const void* q, const void* k,
                                       const void* v, void* out, int b, int s,
                                       int heads, int head_dim, int dtype,
                                       void* stream) {
  if (head_dim != DH || s < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && s <= MAX_SEQ && smem_bytes_f32(s) <= SMEM_LIMIT)
    return (int)launch<float>(attention_f32_kernel, THREADS, QT, smem_bytes_f32(s),
                              q, k, v, out, b, s, heads, st);
  if (dtype == 1)
    return (int)launch<bf16>(attention_bf16_kernel, BF_THREADS, BF_QT, BF_SMEM, q, k, v,
                             out, b, s, heads, st);
  return (int)cudaErrorInvalidValue;
}

// What the bf16 kernel takes of an SM: info[0] = blocks of it one SM holds
// at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), info[1] =
// registers a thread, info[2] = local (spill) bytes a thread, info[3] =
// dynamic + static shared memory bytes a block, info[4] = threads a block.
extern "C" int egotap_attention_bf16_occupancy(int* info) {
  auto kernel = attention_bf16_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BF_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, BF_THREADS, BF_SMEM);
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = BF_SMEM + (int)attr.sharedSizeBytes;
  info[4] = BF_THREADS;
  return (int)err;
}

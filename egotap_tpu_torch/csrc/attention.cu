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
// Design (the first, simple versions): one block per (batch, head,
// 64-query tile), 2304 blocks at the main-path shape. The block indexes
// the packed layout directly (row stride H*Dh, head offset h*Dh): no
// transposes. The whole 64 x S f32 score tile stays in shared memory
// (147 KB at S=576), so K and V are each read once per block and the
// exact softmax needs no second pass over K.
//  * bf16: both products run on the tensor cores with mma.sync m16n8k16
//    (bf16 in, f32 accumulate; a bf16 x bf16 product is exact in f32, so
//    only the summation order differs from an f32 dot). 8 warps: for
//    q k^T warp w owns query rows 16*(w%4) and half of each 64-key chunk,
//    for p v the same rows and half of the 128 output columns. The
//    normalised bf16 probabilities overwrite their own score row in
//    place. Tiles are staged with 16-byte loads into padded shared memory
//    (pitches chosen so fragment loads hit 32 distinct banks). Loads are
//    not pipelined with the products; cp.async / TMA staging and wgmma
//    are later work.
//  * f32: products on the CUDA cores from register micro-tiles (4x4 for
//    q k^T, 8x4 for p v) fed from padded shared memory (row pitch Dh+1).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <cmath>

namespace {

constexpr int DH = 128;       // head dim
constexpr int QT = 64;        // query rows per block
constexpr int KC = 64;        // keys per shared-memory chunk
constexpr int THREADS = 256;
constexpr int MAX_SEQ = 640;  // the wrapper's limit (score tile in smem)
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

constexpr int TP = DH + 8;    // bf16 pitch of the Q / K / V tiles: 68 words,
                              // so rows g = 0..7 start 4 banks apart
typedef __nv_bfloat16 bf16;

// score-tile pitch in floats: a multiple of the key chunk plus 4, so the
// fragment loads of rows g = 0..7 (and of the bf16 p that overwrites them)
// start 4 banks apart
__host__ __device__ __forceinline__ int score_pitch(int s) { return round_up(s, KC) + 4; }

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// dst[r][0:DH] = src[(row0 + r) * ld + 0:DH], 16-byte vectors, 0 past s
__device__ void load_tile_bf16(bf16* dst, const bf16* __restrict__ src, int row0,
                               int s, int ld) {
  constexpr int VPR = DH / 8;                 // 16-byte vectors per row
  for (int i = threadIdx.x; i < QT * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const int row = row0 + r;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row < s) x = *reinterpret_cast<const uint4*>(src + (int64_t)row * ld + c);
    *reinterpret_cast<uint4*>(dst + r * TP + c) = x;
  }
}

__global__ void __launch_bounds__(THREADS)
attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      int s, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);          // QT x TP
  bf16* sKV = sQ + QT * TP;                              // KC x TP
  float* sS = reinterpret_cast<float*>(sKV + KC * TP);   // QT x lds
  const int lds = score_pitch(s);
  const int s_pad = lds - 4;                             // s rounded up to KC

  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ld = heads * DH;
  const int64_t base = (int64_t)b * s * ld + (int64_t)h * DH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;                  // mma fragment coords
  const int r0 = 16 * (warp % 4);                        // this warp's rows
  const int half = warp / 4;

  load_tile_bf16(sQ, q + base, q0, s, ld);

  // ---- scores: sS[r][key] = (q_r . k_key) * scale, keys past s score 0
  for (int k0 = 0; k0 < s; k0 += KC) {
    __syncthreads();                           // sKV free, sQ loaded
    load_tile_bf16(sKV, k + base, k0, s, ld);
    __syncthreads();
    float acc[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      uint32_t a[4];
      const bf16* qa = sQ + (r0 + g) * TP + kk + 2 * t;
      a[0] = ld32(qa);
      a[1] = ld32(qa + 8 * TP);
      a[2] = ld32(qa + 8);
      a[3] = ld32(qa + 8 * TP + 8);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* kb = sKV + (32 * half + 8 * nt + g) * TP + kk + 2 * t;
        uint32_t bb[2] = {ld32(kb), ld32(kb + 8)};
        mma_bf16(acc[nt], a, bb);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int key = k0 + 32 * half + 8 * nt + 2 * t;
      float* row = sS + (r0 + g) * lds + key;
      *reinterpret_cast<float2*>(row) = make_float2(acc[nt][0] * scale, acc[nt][1] * scale);
      *reinterpret_cast<float2*>(row + 8 * lds) =
          make_float2(acc[nt][2] * scale, acc[nt][3] * scale);
    }
  }
  __syncthreads();

  // ---- exact softmax per row (one warp per row, the row held in
  // registers), p rounded to bf16 and written over the row's own scores;
  // keys in [s, s_pad) get p = 0 so they add nothing to p v
  {
    constexpr int PER_LANE = MAX_SEQ / 32;
    bf16* pb = reinterpret_cast<bf16*>(sS);
    for (int r = warp; r < QT; r += THREADS / 32) {
      const float* row = sS + r * lds;
      float x[PER_LANE];
      float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int j = lane + 32 * i;
        x[i] = j < s ? row[j] : __int_as_float(0xff800000);
        m = fmaxf(m, x[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        x[i] = lane + 32 * i < s ? expf(x[i] - m) : 0.f;
        sum += x[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();                          // every lane has read its row
      bf16* prow = pb + 2 * r * lds;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int j = lane + 32 * i;
        if (j < s_pad) prow[j] = __float2bfloat16_rn(x[i] / sum);
      }
    }
  }

  // ---- context: out[r][:] = sum_key p[r][key] * v[key][:]
  float acc[8][4] = {};
  const bf16* pb = reinterpret_cast<const bf16*>(sS);
  for (int k0 = 0; k0 < s; k0 += KC) {
    __syncthreads();                           // p written, sKV free
    load_tile_bf16(sKV, v + base, k0, s, ld);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[4];
      const bf16* pa = pb + 2 * (r0 + g) * lds + k0 + kk + 2 * t;
      a[0] = ld32(pa);
      a[1] = ld32(pa + 16 * lds);
      a[2] = ld32(pa + 8);
      a[3] = ld32(pa + 16 * lds + 8);
      const bf16* vk = sKV + (kk + 2 * t) * TP;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = 64 * half + 8 * nt + g;
        uint32_t bb[2] = {pack2(vk[n], vk[TP + n]),
                          pack2(vk[8 * TP + n], vk[9 * TP + n])};
        mma_bf16(acc[nt], a, bb);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = 64 * half + 8 * nt + 2 * t;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = q0 + r0 + g + 8 * hi;
      if (row < s)
        *reinterpret_cast<__nv_bfloat162*>(out + base + (int64_t)row * ld + col) =
            __floats2bfloat162_rn(acc[nt][2 * hi], acc[nt][2 * hi + 1]);
    }
  }
}

size_t smem_bytes_bf16(int s) {
  return sizeof(bf16) * (size_t)(QT + KC) * TP + sizeof(float) * (size_t)QT * score_pitch(s);
}

// ------------------------------------------------------------------ launch

template <typename T, typename K>
cudaError_t launch(K kernel, size_t smem, const void* q, const void* k,
                   const void* v, void* out, int b, int s, int heads,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + QT - 1) / QT, heads, b);
  const float scale = (float)(1.0 / sqrt((double)DH));  // as f32(1/sqrt(Dh))
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: contiguous (b, s, heads * head_dim), 16-byte aligned;
// dtype 0 = float32, 1 = bfloat16. head_dim must be 128 and s at most
// MAX_SEQ, so that the score tile fits in shared memory (the Python
// wrapper checks all of this).
extern "C" int egotap_attention_packed(const void* q, const void* k,
                                       const void* v, void* out, int b, int s,
                                       int heads, int head_dim, int dtype,
                                       void* stream) {
  if (head_dim != DH || s < 1 || s > MAX_SEQ) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && smem_bytes_f32(s) <= SMEM_LIMIT)
    return (int)launch<float>(attention_f32_kernel, smem_bytes_f32(s), q, k, v,
                              out, b, s, heads, st);
  if (dtype == 1 && smem_bytes_bf16(s) <= SMEM_LIMIT)
    return (int)launch<bf16>(attention_bf16_kernel, smem_bytes_bf16(s), q, k, v,
                             out, b, s, heads, st);
  return (int)cudaErrorInvalidValue;
}

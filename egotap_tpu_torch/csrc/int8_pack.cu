// The passes around one int8 product, `torch._int_mm`: kernel F, two entry
// points.
//
// Replaces: the plain sequence of `ops/quant.py` around the library's
// integer GEMM: quantise (x.float(), / a_scale, round, clamp, the cast to
// int8: five passes), im2col (k*k strided copies and a `torch.cat`), the
// zero padding of K to a multiple of 8 and of M to 32 rows, the per-call
// copy of the weight's rows, then the dequantise (acc.float(), the scale
// product, * scale, + bias, the cast back: four passes over the output).
// The JAX package has no kernel for it: XLA fuses the same passes into its
// convolution and `dot_general`.
//
// Pack (`pack_kernel`): NHWC x (f32 or bf16) and the 0-d f32 static or
// dynamic scale s on the device -> the (Mp, Kp) int8 rows that
// `torch._int_mm` takes as A. Row m is output pixel (b, i, j) of a k x k,
// stride st, padding p convolution; its entry (di * k + dj) * C + c is
//   clip(rint(x[b, i*st - p + di, j*st - p + dj, c] / s), -127, 127)
// with 0 outside the image, in the K tail up to Kp (a multiple of 8) and in
// the rows from M up to Mp (32 when M <= 16). A dense product is k = 1 on
// (M, 1, 1, K). The quotient is `__fdiv_rn` (the IEEE quotient PyTorch
// computes for a division by a tensor; never a reciprocal), rint rounds
// half to even as torch.round, and NaN goes to code 0 as the plain cast.
//
// Epilogue (`epilogue_kernel`): the (Mp, Np) int32 product -> the (M, N)
// output in x's dtype, each element in the plain sequence's order and
// rounding: f = __int2float_rn(acc); y = __fmul_rn(f, __fmul_rn(s,
// w_scale[c])); y = __fadd_rn(y, bias[c]); one rounding to the dtype.
// Every operation is an `_rn` intrinsic, so nothing is contracted into an
// FMA: both entry points equal the plain sequence bit for bit.
//
// Bound on the H100: memory. The pack writes each row once and reads x
// (its k*k reads of one pixel mostly hit L2); the epilogue reads the int32
// product once and writes the output once.
//
// Design: a block owns `rows` consecutive rows (a contiguous tile of the
// output) and its threads walk the tile's chunks of V entries in order, so
// a warp's loads and stores are consecutive. V is the widest of 16, 8, 4, 1
// codes (pack; 8, 4, 2, 1 outputs in the epilogue) that divides C (N), so
// a chunk never crosses a tap or a row and each store is one aligned 16-,
// 8-, 4- or 1-byte access. A thread keeps the decomposition of its current
// row and recomputes it only when its chunk moves to another row; every
// division is by a value fixed for the launch (`FastDiv`). A block walks
// at most about `TILE` chunks (`ops/int8_pack.py`), and a small call
// takes fewer rows a block, so that it still spreads over the SMs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;

// V elements of T at p (aligned to V * sizeof(T), or 16 bytes when more),
// to f32
template <typename T, int V> struct Load;

template <int V> struct Load<float, V> {
  __device__ static void run(const float* p, float* v) {
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int i = 0; i < V / 4; ++i) {
        const float4 q = reinterpret_cast<const float4*>(p)[i];
        v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z; v[4 * i + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = p[i];
    }
  }
};

template <int V> struct Load<__nv_bfloat16, V> {
  __device__ static void run(const __nv_bfloat16* p, float* v) {
    if constexpr (V % 8 == 0) {
#pragma unroll
      for (int i = 0; i < V / 8; ++i) {
        const uint4 q = reinterpret_cast<const uint4*>(p)[i];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          v[8 * i + 2 * e] = f.x; v[8 * i + 2 * e + 1] = f.y;
        }
      }
    } else if constexpr (V == 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        v[2 * e] = f.x; v[2 * e + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
    }
  }
};

// V int8 codes (as the low bytes of c) to p, aligned to V bytes
template <int V> __device__ void store_codes(int8_t* p, const int* c) {
  if constexpr (V == 1) {
    *p = (int8_t)c[0];
  } else {
    uint32_t w[(V + 3) / 4];
#pragma unroll
    for (int i = 0; i < (V + 3) / 4; ++i)     // the low bytes of 4 ints
      w[i] = __byte_perm(__byte_perm(c[4 * i], c[4 * i + 1], 0x0040),
                         __byte_perm(c[4 * i + 2], c[4 * i + 3], 0x0040), 0x5410);
    if constexpr (V == 16) *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    if constexpr (V == 8) *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    if constexpr (V == 4) *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

// clip(rint(v / s), -127, 127) as an int: the quotient rounded half to
// even and converted at once (saturating past 2^31; NaN goes to 0, as the
// plain sequence's cast), then clipped as an int. A zero dividend (half
// of a ReLU's output) would send `__fdiv_rn` down its slow path, a call;
// its code is 0, so it divides s by s instead and drops the quotient
__device__ __forceinline__ int code_of(float v, float s) {
  const int q = max(-127, min(127, __float2int_rn(__fdiv_rn(v == 0.f ? s : v, s))));
  return v == 0.f ? 0 : q;
}

// n / d for 0 <= n < 2^31 and a divisor fixed for the launch, by a
// multiply-high and a shift (CUTLASS's FastDivmod): an integer division
// by a value known only at run time costs some twenty instructions
struct FastDiv {
  int d;
  unsigned magic, shift;
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((unsigned)n, magic) + (unsigned)n) >> shift);
  }
};

FastDiv fast_div(unsigned d) {
  unsigned shift = 0;
  while ((1ull << shift) < d) ++shift;
  return FastDiv{(int)d, (unsigned)(((1ull << 32) * ((1ull << shift) - d)) / d + 1), shift};
}

struct PackShape {
  int h, w, c, k, stride, pad;
  FastDiv fc, fk, fho, fwo, fcpr;  // by C, k, Ho, Wo, chunks a row
  int m, kk, kp;                   // rows, entries k*k*c, entries padded to 8
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
pack_kernel(const T* __restrict__ x, const float* __restrict__ a_scale,
            int8_t* __restrict__ rows, PackShape sh, int mp, int rows_per_block) {
  const float s = *a_scale;
  const int cpr = sh.kp / V;                          // chunks a row
  const int row0 = blockIdx.x * rows_per_block;
  const int tile = min(rows_per_block, mp - row0) * cpr;
  int cur = -1;                                       // the row decomposed
  const T* base = nullptr;                            // x at (b, i*st - p, j*st - p)
  int hi0 = 0, wi0 = 0;
  for (int t = threadIdx.x; t < tile; t += THREADS) {
    const int r = sh.fcpr.div(t);
    const int col = (t - r * cpr) * V;
    const int m = row0 + r;
    if (r != cur) {
      cur = r;
      if (m < sh.m) {
        const int rest = sh.fwo.div(m);
        const int b = sh.fho.div(rest);
        hi0 = (rest - b * sh.fho.d) * sh.stride - sh.pad;
        wi0 = (m - rest * sh.fwo.d) * sh.stride - sh.pad;
        base = x + (int64_t)b * sh.h * sh.w * sh.c;
      }
    }
    int c8[V];
#pragma unroll
    for (int e = 0; e < V; ++e) c8[e] = 0;
    if (m < sh.m && col < sh.kk) {
      const int tap = sh.fc.div(col);
      const int ch = col - tap * sh.c;
      const int di = sh.fk.div(tap);
      const int hi = hi0 + di, wi = wi0 + (tap - di * sh.k);
      if (hi >= 0 && hi < sh.h && wi >= 0 && wi < sh.w) {
        float v[V];
        Load<T, V>::run(base + ((int64_t)hi * sh.w + wi) * sh.c + ch, v);
#pragma unroll
        for (int e = 0; e < V; ++e) c8[e] = code_of(v[e], s);
      }
    }
    store_codes<V>(rows + (int64_t)m * sh.kp + col, c8);
  }
}

// V outputs from f32 to p in its dtype, one rounding each
template <int V> __device__ void store_out(float* p, const float* y) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(y[0], y[1]);
  } else {
    *p = y[0];
  }
}

template <int V> __device__ void store_out(__nv_bfloat16* p, const float* y) {
  if constexpr (V == 1) {
    *p = __float2bfloat16_rn(y[0]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y[0], y[1]);
  } else {
    using W = typename std::conditional<V == 8, uint4, uint2>::type;
    W q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) h[i] = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    *reinterpret_cast<W*>(p) = q;
  }
}

template <int V> __device__ void load_acc(const int32_t* p, int* a) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const int4 q = reinterpret_cast<const int4*>(p)[i];
      a[4 * i] = q.x; a[4 * i + 1] = q.y; a[4 * i + 2] = q.z; a[4 * i + 3] = q.w;
    }
  } else if constexpr (V == 2) {
    const int2 q = *reinterpret_cast<const int2*>(p);
    a[0] = q.x; a[1] = q.y;
  } else {
    a[0] = *p;
  }
}

template <typename T, int V, bool BIAS>
__global__ void __launch_bounds__(THREADS)
epilogue_kernel(const int32_t* __restrict__ acc, const float* __restrict__ a_scale,
                const float* __restrict__ w_scale, const float* __restrict__ bias,
                T* __restrict__ out, int m, int n, int np, FastDiv fcpr,
                int rows_per_block) {
  const float s = *a_scale;
  const int cpr = n / V;
  const int row0 = blockIdx.x * rows_per_block;
  const int tile = min(rows_per_block, m - row0) * cpr;
  for (int t = threadIdx.x; t < tile; t += THREADS) {
    const int r = fcpr.div(t);
    const int col = (t - r * cpr) * V;
    const int64_t row = row0 + r;
    int a[V];
    load_acc<V>(acc + row * np + col, a);
    float y[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      y[e] = __fmul_rn(__int2float_rn(a[e]), __fmul_rn(s, w_scale[col + e]));
      if (BIAS) y[e] = __fadd_rn(y[e], bias[col + e]);
    }
    store_out<V>(out + row * n + col, y);
  }
}

template <typename T>
const void* pick_pack_t(int vec) {
  switch (vec) {
    case 16: return (const void*)pack_kernel<T, 16>;
    case 8: return (const void*)pack_kernel<T, 8>;
    case 4: return (const void*)pack_kernel<T, 4>;
    case 1: return (const void*)pack_kernel<T, 1>;
  }
  return nullptr;
}

const void* pick_pack(int dtype, int vec) {
  if (dtype == 0) return pick_pack_t<float>(vec);
  if (dtype == 1) return pick_pack_t<__nv_bfloat16>(vec);
  return nullptr;
}

template <typename T, bool BIAS>
const void* pick_epilogue_tb(int vec) {
  switch (vec) {
    case 8: return (const void*)epilogue_kernel<T, 8, BIAS>;
    case 4: return (const void*)epilogue_kernel<T, 4, BIAS>;
    case 2: return (const void*)epilogue_kernel<T, 2, BIAS>;
    case 1: return (const void*)epilogue_kernel<T, 1, BIAS>;
  }
  return nullptr;
}

const void* pick_epilogue(int dtype, int vec, bool bias) {
  if (dtype == 0) return bias ? pick_epilogue_tb<float, true>(vec) : pick_epilogue_tb<float, false>(vec);
  if (dtype == 1)
    return bias ? pick_epilogue_tb<__nv_bfloat16, true>(vec) : pick_epilogue_tb<__nv_bfloat16, false>(vec);
  return nullptr;
}

// blocks of rows_per_block rows covering `rows`, or 0 when out of range
int blocks_of(int rows, int rows_per_block) {
  if (rows <= 0 || rows_per_block <= 0) return 0;
  return (rows + rows_per_block - 1) / rows_per_block;
}

}  // namespace

// x: contiguous NHWC (n, h, w, c), 16-byte aligned; a_scale: one f32;
// rows: (mp, kp) int8, contiguous. dtype 0 = float32, 1 = bfloat16; vec
// (16, 8, 4 or 1) divides c, and kp; rows_per_block * kp / vec chunks a
// block fit an int. The Python wrapper (`ops/int8_pack.py:pack`) computes
// the geometry and checks all of it.
extern "C" int egotap_int8_pack(const void* x, const void* a_scale, void* rows,
                                int n, int h, int w, int c, int k, int stride,
                                int pad, int ho, int wo, int mp, int kp,
                                int dtype, int vec, int rows_per_block,
                                void* stream) {
  const void* kernel = pick_pack(dtype, vec);
  const long long m = (long long)n * ho * wo;
  const long long kk = (long long)k * k * c;
  if (kernel == nullptr || n <= 0 || h <= 0 || w <= 0 || c <= 0 || k <= 0 ||
      stride <= 0 || pad < 0 || ho <= 0 || wo <= 0 || c % vec || kp % vec ||
      m > mp || mp > 0x7fffffff || kk > kp || kp - kk >= 8 ||
      (long long)rows_per_block * (kp / vec) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int grid = blocks_of(mp, rows_per_block);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  PackShape sh{h, w, c, k, stride, pad,
               fast_div(c), fast_div(k), fast_div(ho), fast_div(wo), fast_div(kp / vec),
               (int)m, (int)kk, kp};
  void* args[] = {(void*)&x, (void*)&a_scale, &rows, &sh, &mp, &rows_per_block};
  cudaError_t err = cudaLaunchKernel(kernel, dim3(grid), dim3(THREADS), args, 0,
                                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// acc: (>= m, np) int32, contiguous; a_scale: one f32; w_scale, bias
// (nullptr for none): n f32; out: (m, n) contiguous in dtype (0 = float32,
// 1 = bfloat16); vec (8, 4, 2 or 1) divides n and np. Checked by
// `ops/int8_pack.py:epilogue`.
extern "C" int egotap_int8_epilogue(const void* acc, const void* a_scale,
                                    const void* w_scale, const void* bias,
                                    void* out, int m, int n, int np, int dtype,
                                    int vec, int rows_per_block, void* stream) {
  const void* kernel = pick_epilogue(dtype, vec, bias != nullptr);
  if (kernel == nullptr || m <= 0 || n <= 0 || np < n || n % vec || np % vec ||
      (long long)rows_per_block * (n / vec) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int grid = blocks_of(m, rows_per_block);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  FastDiv fcpr = fast_div(n / vec);
  void* args[] = {(void*)&acc, (void*)&a_scale, (void*)&w_scale, (void*)&bias,
                  &out, &m, &n, &np, &fcpr, &rows_per_block};
  cudaError_t err = cudaLaunchKernel(kernel, dim3(grid), dim3(THREADS), args, 0,
                                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

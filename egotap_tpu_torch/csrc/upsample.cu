// 2x bilinear upsample with align_corners=True, NHWC, f32 or bf16.
//
// Replaces: egotap_tpu/ops/upsample.py `_upsample_kernel` /
// `_upsample_pallas` (the one-pass Pallas kernel; two-pass einsum
// `_upsample_two_pass` is the same linear map).
//
// Bound on the H100: memory. Each output element is a 2x2 lerp of four
// input elements (4 FMA-class operations), so the work is ~1 operation per
// byte moved; the least traffic is one read of the input and one write of
// the output (5 bytes out per byte in), ~545 MB per bf16 serving forward
// over its six calls. Four fifths of the bytes are the output write.
//
// Design: a block owns a band of output rows of one image and a slice of
// `cv` 16-byte channel vectors (8 bf16 or 4 f32 channels each); grid
// (channel slice, band, image). The block copies the input rows its band
// reads (one-row halo included) into shared memory once, by 16-byte
// `cp.async`, then writes the band from there: a thread owns one channel
// vector of one output column, loads its column taps once and walks down
// the band's rows, keeping the two input rows' vectors of its columns in
// registers (consecutive output rows mostly share their input rows). A
// warp's stores cover whole 128-byte lines of one output row, with the
// streaming hint (2% faster on an H100 than plain stores). The taps
// (lo, hi, frac) of both axes come from the host (`ops/upsample.py`,
// float64 as `_lerp_taps`), so the kernel does no division and no
// double-precision arithmetic; indices within an image are 32-bit. Both
// lerps (rows first, then columns, each a*(1-f) + b*f, as
// upsample.py:84-95) run in f32 registers, each operation rounded as in
// the plain version (no FMA contraction), and the output is rounded once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BAND = 64;      // output rows a block (its taps in shared memory)

// 16 bytes of channels, unpacked to f32
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(uint4 x, float* v) {
    v[0] = __uint_as_float(x.x); v[1] = __uint_as_float(x.y);
    v[2] = __uint_as_float(x.z); v[3] = __uint_as_float(x.w);
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(uint4 x, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x; v[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float* v) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return x;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem));
}

// one output vector, with the streaming hint (`st.global.cs`: the line is
// not read again soon)
__device__ __forceinline__ void store16(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// a * (1 - f) + b * f, each operation rounded as the plain version's
__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(a, 1.f - f), __fmul_rn(b, f));
}

// Taps of one axis: int32 lo[n], hi[n], then frac[n] as f32 bits (n = 2 * size).
struct Tap {
  int lo, hi;
  float fr;
};
__device__ __forceinline__ Tap tap(const int* t, int n, int o) {
  return Tap{t[o], t[n + o], __int_as_float(t[2 * n + o])};
}

// x: (n, h, w, c); out: (n, 2h, 2w, c); grid (c / V / cv, bands, min(n, 65535)).
template <typename T>
__global__ void __launch_bounds__(THREADS)
upsample2x_kernel(const T* __restrict__ x, T* __restrict__ out,
                  const int* __restrict__ row_taps, const int* __restrict__ col_taps,
                  int n, int h, int w, int c, int band, int cv) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(16) uint4 tile[];     // [staged row][w][cv]
  __shared__ int s_lo[MAX_BAND], s_hi[MAX_BAND];
  __shared__ float s_fr[MAX_BAND];

  const int oh = 2 * h, ow = 2 * w;
  const int o0 = blockIdx.y * band;
  const int rows = min(band, oh - o0);
  const int r0 = row_taps[o0];
  const int staged = row_taps[oh + o0 + rows - 1] - r0 + 1;
  const int ch0 = blockIdx.x * cv * V;              // first channel of the slice
  const int v = threadIdx.x % cv;                   // this thread's vector
  const int cols = THREADS / cv;                    // output columns a pass

  for (int img = blockIdx.z; img < n; img += gridDim.z) {
    const T* src = x + (int64_t)img * h * w * c + ch0;
    T* dst = out + (int64_t)img * oh * ow * c + ch0 + v * V;
    if (img != (int)blockIdx.z) __syncthreads();    // the last image's reads are done
    for (int i = threadIdx.x; i < staged * w * cv; i += THREADS) {
      const int px = i / cv;                        // staged row * w + column
      cp_async16(tile + i, src + (r0 * w + px) * c + (i - px * cv) * V);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (img == (int)blockIdx.z && threadIdx.x < rows) {
      const Tap r = tap(row_taps, oh, o0 + threadIdx.x);
      s_lo[threadIdx.x] = r.lo - r0;
      s_hi[threadIdx.x] = r.hi - r0;
      s_fr[threadIdx.x] = r.fr;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    for (int p = threadIdx.x / cv; p < ow; p += cols) {
      const Tap q = tap(col_taps, ow, p);
      const float fq = q.fr;
      const uint4* col_lo = tile + q.lo * cv + v;
      const uint4* col_hi = tile + q.hi * cv + v;
      int cur_l = -1, cur_h = -1;
      uint4 a = {}, cc = {}, b = {}, d = {};        // (row lo | hi) x (col lo | hi)
      for (int k = 0; k < rows; ++k) {
        const int rl = s_lo[k], rh = s_hi[k];
        const float fr = s_fr[k];
        if (rl != cur_l) {
          if (rl == cur_h) { a = b; cc = d; }
          else { a = col_lo[rl * w * cv]; cc = col_hi[rl * w * cv]; }
          cur_l = rl;
        }
        if (rh != cur_h) {
          if (rh == cur_l) { b = a; d = cc; }
          else { b = col_lo[rh * w * cv]; d = col_hi[rh * w * cv]; }
          cur_h = rh;
        }
        float fa[V], fb[V], fc[V], fd[V], res[V];
        Vec<T>::unpack(a, fa); Vec<T>::unpack(b, fb);
        Vec<T>::unpack(cc, fc); Vec<T>::unpack(d, fd);
#pragma unroll
        for (int e = 0; e < V; ++e)            // rows first, then columns
          res[e] = lerp(lerp(fa[e], fb[e], fr), lerp(fc[e], fd[e], fr), fq);
        store16(dst + ((o0 + k) * ow + p) * c, Vec<T>::pack(res));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, const int* row_taps,
                   const int* col_taps, int n, int h, int w, int c, int band,
                   int cv, int staged, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const size_t smem = (size_t)staged * w * cv * 16;
  cudaError_t err = cudaFuncSetAttribute(
      upsample2x_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(c / V / cv, (2 * h + band - 1) / band, n < 65535 ? n : 65535);
  upsample2x_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), row_taps, col_taps, n, h,
      w, c, band, cv);
  return cudaGetLastError();
}

}  // namespace

// x, out: contiguous, 16-byte aligned; dtype 0 = float32, 1 = bfloat16;
// row_taps / col_taps: the taps of h and w (3 * 2h and 3 * 2w int32);
// band output rows a block (<= 64), cv vectors a block (dividing c / V,
// at most THREADS), staged = the most input rows a band reads. The Python
// wrapper (`ops/upsample.py:launch_geometry`) computes and checks all of it.
extern "C" int egotap_upsample2x(const void* x, void* out, const void* row_taps,
                                 const void* col_taps, int n, int h, int w,
                                 int c, int dtype, int band, int cv, int staged,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band < 1 || band > MAX_BAND || cv < 1 || THREADS % cv) return (int)cudaErrorInvalidValue;
  const int* rt = static_cast<const int*>(row_taps);
  const int* ct = static_cast<const int*>(col_taps);
  if (dtype == 0) return (int)launch<float>(x, out, rt, ct, n, h, w, c, band, cv, staged, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, out, rt, ct, n, h, w, c, band, cv, staged, s);
  return (int)cudaErrorInvalidValue;
}

// What the kernel of `dtype` takes of an SM with `smem` bytes of dynamic
// shared memory: info[0] = blocks an SM, info[1] = registers a thread,
// info[2] = local (spill) bytes a thread, info[3] = shared memory a block,
// info[4] = threads a block.
extern "C" int egotap_upsample2x_occupancy(int dtype, int smem, int* info) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const void* kernel = dtype == 0 ? (const void*)upsample2x_kernel<float>
                                  : (const void*)upsample2x_kernel<__nv_bfloat16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, THREADS, smem);
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = smem + (int)attr.sharedSizeBytes;
  info[4] = THREADS;
  return (int)err;
}

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
// over its six calls.
//
// Design: one thread per 16-byte vector of channels of one output pixel
// (8 bf16 or 4 f32 channels), so a warp covers 512 contiguous bytes of one
// output row and both loads and stores are full 16-byte transactions. The
// taps are computed in the kernel from (in-1)/(out-1) in double precision,
// exactly as `_lerp_taps` / `_interp_matrix` compute them with numpy. The
// four input vectors a thread reads are shared with its neighbours, so they
// come from L1/L2 and device memory sees each input byte about once. The
// doubled-H intermediate of the two-pass form never exists: both lerps
// (rows first, then columns, each a*(1-f) + b*f, as upsample.py:84-95)
// are done in f32 registers and the output is rounded once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct Tap {
  int lo, hi;
  float frac;
};

__device__ __forceinline__ Tap tap(int o, int in_size) {
  Tap t;
  if (in_size == 1) {
    t.lo = 0; t.hi = 0; t.frac = 0.f;
    return t;
  }
  double src = (double)o * (double)(in_size - 1) / (double)(2 * in_size - 1);
  int lo = (int)floor(src);
  t.lo = lo;
  t.hi = min(lo + 1, in_size - 1);
  t.frac = (float)(src - (double)lo);
  return t;
}

// VEC channels held as f32
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* v) {
    float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x; v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = x;
  }
};

template <typename T>
__global__ void upsample2x_kernel(const T* __restrict__ x, T* __restrict__ out,
                                  int n, int h, int w, int c) {
  constexpr int V = Vec<T>::N;
  const int cv = c / V;
  const int oh = 2 * h, ow = 2 * w;
  const int64_t total = (int64_t)n * oh * ow * cv;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int ci = (int)(idx % cv);
    int64_t rest = idx / cv;
    const int p = (int)(rest % ow);
    rest /= ow;
    const int o = (int)(rest % oh);
    const int img = (int)(rest / oh);
    const Tap r = tap(o, h), q = tap(p, w);
    const T* base = x + (int64_t)img * h * w * c + (int64_t)ci * V;
    float a[V], b[V], cc[V], d[V], res[V];
    Vec<T>::load(base + ((int64_t)r.lo * w + q.lo) * c, a);
    Vec<T>::load(base + ((int64_t)r.hi * w + q.lo) * c, b);
    Vec<T>::load(base + ((int64_t)r.lo * w + q.hi) * c, cc);
    Vec<T>::load(base + ((int64_t)r.hi * w + q.hi) * c, d);
    const float fr = r.frac, fq = q.frac;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float col_lo = a[i] * (1.f - fr) + b[i] * fr;     // rows first
      float col_hi = cc[i] * (1.f - fr) + d[i] * fr;
      res[i] = col_lo * (1.f - fq) + col_hi * fq;       // then columns
    }
    Vec<T>::store(out + idx * V, res);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, int n, int h, int w, int c,
                   cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int64_t total = (int64_t)n * 4 * h * w * (c / V);
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond 64 waves
  upsample2x_kernel<T><<<(int)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, h, w, c);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. c must be a multiple of the vector
// width (4 for f32, 8 for bf16) and both pointers 16-byte aligned; the
// Python wrapper checks both.
extern "C" int egotap_upsample2x(const void* x, void* out, int n, int h,
                                 int w, int c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, out, n, h, w, c, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, out, n, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}

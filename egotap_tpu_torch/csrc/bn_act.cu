// Eval-mode BatchNorm, optional residual add, then ReLU, in one pass over
// an NHWC (channels-last) tensor, f32 or bf16: kernel E.
//
// Replaces: the plain sequence of the ResNet trunk's eval path
// (`ops/bn_act.py:bn_act_plain`): `batch_norm_eval` (three launches on the
// channel vectors, then x.float(), - mean, * inv, + bias and the cast back,
// five passes over the tensor in f32), the residual add and the ReLU, each
// its own launch. The JAX package has no kernel here: XLA fuses the same
// BatchNorm, add and ReLU into one loop.
//
// What it computes, for x (rows, C) and channel c of each element:
//   inv = rsqrt(var[c] + eps) * weight[c]
//   y   = round((f32(x) - mean[c]) * inv + bias[c])
//   residual 1 (identity):  y = round(f32(y) + f32(r))
//   residual 2 (BatchNorm): y = round(f32(y) + f32(round(bn_r(f32(r)))))
//   then ReLU:              y = max(y, 0), NaN kept
// with round() to the tensor's dtype. Every add, subtract and multiply is
// an `_rn` intrinsic, so nothing is contracted into an FMA, and the root
// is `rsqrtf`, as PyTorch's rsqrt: the result equals the plain sequence's
// bit for bit. The statistics are read from the BatchNorm's buffers at
// every call.
//
// Bound on the H100: memory. One read of x (and of r) and one write of the
// output, against the plain sequence's ~36 bytes of f32 traffic an
// element (bf16).
//
// Design: a grid-stride loop over 16-byte vectors (8 bf16 or 4 f32
// channels; C a multiple of that), two vectors in flight a thread. The
// grid's stride is a multiple of a row's vectors, so the channels of a
// thread never change: it computes its channels' (mean, inv, bias), and
// the residual's, once into registers. The grid is at most what the SMs
// hold at once, rounded down to whole rows of vectors a stride.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

// the running statistics and affine parameters of one BatchNorm, f32 (C)
struct Stats {
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
};

// (mean, inv, bias) of channels c0 .. c0 + V - 1, inv in the plain order:
// (var + eps), its rsqrt, times weight
template <int V>
struct Channels {
  float m[V], s[V], b[V];
  __device__ void load(const Stats& st, int c0, float eps) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      m[e] = st.mean[c0 + e];
      s[e] = __fmul_rn(rsqrtf(__fadd_rn(st.var[c0 + e], eps)), st.weight[c0 + e]);
      b[e] = st.bias[c0 + e];
    }
  }
  // v[e] = round((v[e] - m) * s + b) to T, in f32
  template <typename T>
  __device__ void apply(float* v) const {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = __fadd_rn(__fmul_rn(__fsub_rn(v[e], m[e]), s[e]), b[e]);
    Vec<T>::unpack(Vec<T>::pack(v), v);
  }
};

template <typename T, int RES>
__device__ __forceinline__ uint4 one(uint4 xv, uint4 rv, const Channels<Vec<T>::N>& cx,
                                     const Channels<Vec<T>::N>& cr) {
  constexpr int V = Vec<T>::N;
  float y[V];
  Vec<T>::unpack(xv, y);
  cx.template apply<T>(y);
  if (RES) {
    float r[V];
    Vec<T>::unpack(rv, r);
    if (RES == 2) cr.template apply<T>(r);
#pragma unroll
    for (int e = 0; e < V; ++e) y[e] = __fadd_rn(y[e], r[e]);
  }
  // torch.relu is clamp_min(0): max(v, 0) with NaN kept; rounding to T
  // commutes with it, so it may come before the final rounding
#pragma unroll
  for (int e = 0; e < V; ++e) y[e] = isnan(y[e]) ? y[e] : fmaxf(y[e], 0.f);
  return Vec<T>::pack(y);
}

// x, r, out: (nvec, 16 bytes); cv vectors a row; gridDim.x * THREADS a
// multiple of cv
template <typename T, int RES>
__global__ void __launch_bounds__(THREADS)
bn_act_kernel(const uint4* __restrict__ x, const uint4* __restrict__ r,
              uint4* __restrict__ out, Stats sx, Stats sr, int64_t nvec, int cv,
              float eps) {
  constexpr int V = Vec<T>::N;
  const int64_t step = (int64_t)gridDim.x * THREADS;
  int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= nvec) return;
  const int c0 = (int)(i % cv) * V;
  Channels<V> cx, cr;
  cx.load(sx, c0, eps);
  if (RES == 2) cr.load(sr, c0, eps);
  for (; i + step < nvec; i += 2 * step) {        // two vectors in flight
    const uint4 x0 = x[i], x1 = x[i + step];
    uint4 r0 = {}, r1 = {};
    if (RES) { r0 = r[i]; r1 = r[i + step]; }
    out[i] = one<T, RES>(x0, r0, cx, cr);
    out[i + step] = one<T, RES>(x1, r1, cx, cr);
  }
  if (i < nvec) out[i] = one<T, RES>(x[i], RES ? r[i] : uint4{}, cx, cr);
}

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

// the kernel of (dtype, residual); nullptr when out of range
template <typename T>
const void* pick_t(int residual) {
  switch (residual) {
    case 0: return (const void*)bn_act_kernel<T, 0>;
    case 1: return (const void*)bn_act_kernel<T, 1>;
    case 2: return (const void*)bn_act_kernel<T, 2>;
  }
  return nullptr;
}

// ... and its index among the 6 (dtype, residual)
const void* pick(int dtype, int residual, int* which) {
  if (residual < 0 || residual > 2) return nullptr;
  *which = dtype * 3 + residual;
  if (dtype == 0) return pick_t<float>(residual);
  if (dtype == 1) return pick_t<__nv_bfloat16>(residual);
  return nullptr;
}

// blocks a launch: what the SMs hold at once (or fewer, for a small
// tensor), rounded down to a multiple of the blocks whose threads cover
// whole rows of cv vectors (at least that many). What the SMs hold is
// asked once a kernel and device (the same value if two threads race).
constexpr int MAX_DEVICES = 64;
int held_blocks[MAX_DEVICES][6];

cudaError_t grid_of(const void* kernel, int which, int64_t nvec, int cv, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int held = held_blocks[dev][which];
  if (held == 0) {
    int blocks_per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel, THREADS, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    held = blocks_per_sm * sms;
    if (held <= 0) return cudaErrorInvalidConfiguration;
    held_blocks[dev][which] = held;
  }
  const int64_t unit = cv / gcd(cv, THREADS);
  int64_t blocks = (nvec + THREADS - 1) / THREADS;
  if (blocks > held) blocks = held;
  blocks = blocks / unit * unit;
  if (blocks < unit) blocks = unit;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  *grid = (int)blocks;
  return cudaSuccess;
}

}  // namespace

// x, r, out: contiguous, 16-byte aligned, n elements of c channels each
// row (n a multiple of c, c of 4 f32 or 8 bf16); dtype 0 = float32,
// 1 = bfloat16; residual 0 = none (r unused), 1 = identity, 2 = r through
// its own BatchNorm (r_*); mean, var, weight, bias (and r_*): f32, c
// each. The Python wrapper (`ops/bn_act.py:_launch`) checks all of it.
extern "C" int egotap_bn_act(const void* x, const void* r, void* out,
                             const void* mean, const void* var,
                             const void* weight, const void* bias,
                             const void* r_mean, const void* r_var,
                             const void* r_weight, const void* r_bias,
                             long long n, int c, int dtype, int residual,
                             float eps, void* stream) {
  int which = 0;
  const void* kernel = pick(dtype, residual, &which);
  const int v = dtype == 0 ? 4 : 8;
  if (kernel == nullptr || c <= 0 || c % v || n <= 0 || n % c)
    return (int)cudaErrorInvalidValue;
  const int64_t nvec = n / v;
  const int cv = c / v;
  int grid = 0;
  cudaError_t err = grid_of(kernel, which, nvec, cv, &grid);
  if (err != cudaSuccess) return (int)err;
  Stats sx{static_cast<const float*>(mean), static_cast<const float*>(var),
           static_cast<const float*>(weight), static_cast<const float*>(bias)};
  Stats sr{static_cast<const float*>(r_mean), static_cast<const float*>(r_var),
           static_cast<const float*>(r_weight), static_cast<const float*>(r_bias)};
  const uint4* xv = static_cast<const uint4*>(x);
  const uint4* rv = static_cast<const uint4*>(r);
  uint4* ov = static_cast<uint4*>(out);
  float e = eps;
  int64_t nv = nvec;
  int cvv = cv;
  void* args[] = {&xv, &rv, &ov, &sx, &sr, &nv, &cvv, &e};
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(THREADS), args, 0,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What the kernel of (dtype, residual) takes of an SM and the grid
// it launches for n elements of c channels: info[0] = blocks an SM,
// info[1] = registers a thread, info[2] = local (spill) bytes a thread,
// info[3] = threads a block, info[4] = blocks of the launch.
extern "C" int egotap_bn_act_occupancy(int dtype, int residual, long long n,
                                       int c, int* info) {
  int which = 0;
  const void* kernel = pick(dtype, residual, &which);
  const int v = dtype == 0 ? 4 : 8;
  if (kernel == nullptr || c <= 0 || c % v || n <= 0 || n % c)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = THREADS;
  return (int)grid_of(kernel, which, n / v, c / v, &info[4]);
}

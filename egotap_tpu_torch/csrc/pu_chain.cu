// The 2-layer Propagation-Unit chain over J joints in one launch.
//
// Replaces: egotap_tpu/ops/pu_kernel.py `_pu_kernel` / `pu_chain_fused`.
// Per joint j (gate order f,i,g,o; h/c state f32, zero at j = 0):
//   layer 0: gates  = gates_pre[j] + (fh[j] * h0) @ Wh2h
//   layer 1: fh1    = sigmoid(h0 @ Wx2f1 + b)
//            gates1 = h0 @ Wx2h1 + b + (fh1 * h1) @ Wh2h1 + b
//   LSTM update c' = c*sig(f) + sig(i)*tanh(g), h' = sig(o)*tanh(c')
// Output: layer 1's h per joint, f32. Matrix operands are rounded to the
// weights' dtype (f32 or bf16) before each product, which accumulates in
// f32, as the TPU kernel's preferred_element_type dots do.
//
// Bound on the H100: the chain is 15 dependent steps of [B,H]x[H,4H]
// products (3.3 GFLOP and ~13 MB at B=32, H=512 in bf16, a few us of
// bound), so what limits it is latency: the steps cannot overlap, and
// each step needs the whole of h0 before layer 1 can start. Launched as
// ~100 small PyTorch ops it would be dominated by launch gaps.
//
// Design: one cooperative launch for the whole walk. Weights are in
// PyTorch's (out, in) layout, so each gate column is a contiguous row.
// Block p owns hidden units [p*U, (p+1)*U) and computes all four gates of
// them (columns u, H+u, 2H+u, 3H+u), so it applies the cell update
// itself. h0 is double-buffered in global memory; c0, c1, h1 of a unit are
// touched only by the block that owns it. Two grid-wide barriers per joint
// separate the phases: (1) layer-0 gates and update; (2) fh1 and the x2h
// part of layer 1's gates, and fh1*h1 published; (3) layer-1 gates and
// update. Weights are read each step from global memory: at 6.8 MB (bf16)
// they stay in the 50 MB L2 across steps. Keeping them resident in
// shared memory is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int KC = 64;          // reduction chunk staged in shared memory
constexpr int PA = KC + 1;      // padded pitch

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename W> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// G[b][gcol0 + c] += sum_k a_of(b, k) * wrow(c)[k]  for b < B, c < NC
template <typename W, typename AFn, typename RowFn>
__device__ void gemm_acc(float* sA, float* sW, float* G, int ldg, int gcol0,
                         int B, int H, int NC, AFn a_of, RowFn wrow) {
  const int tid = threadIdx.x;
  for (int k0 = 0; k0 < H; k0 += KC) {
    __syncthreads();
    for (int i = tid; i < B * KC; i += THREADS) {
      const int b = i / KC, kk = i % KC, k = k0 + kk;
      sA[b * PA + kk] = k < H ? a_of(b, k) : 0.f;
    }
    for (int i = tid; i < NC * KC; i += THREADS) {
      const int c = i / KC, kk = i % KC, k = k0 + kk;
      sW[c * PA + kk] = k < H ? to_f(wrow(c)[k]) : 0.f;
    }
    __syncthreads();
    for (int o = tid; o < B * NC; o += THREADS) {
      const int b = o / NC, c = o % NC;
      const float* a = sA + b * PA;
      const float* w = sW + c * PA;
      float s = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) s = fmaf(a[kk], w[kk], s);
      G[b * ldg + gcol0 + c] += s;
    }
  }
  __syncthreads();
}

template <typename W>
__global__ void __launch_bounds__(THREADS)
pu_chain_kernel(const float* __restrict__ fh, const float* __restrict__ gp,
                const W* __restrict__ wh2h, const W* __restrict__ wx2f1,
                const float* __restrict__ bx2f1, const W* __restrict__ wx2h1,
                const float* __restrict__ bx2h1, const W* __restrict__ wh2h1,
                const float* __restrict__ bh2h1, float* __restrict__ out,
                float* scratch, int B, int J, int H, int U) {
  extern __shared__ float smem[];
  float* sA = smem;                    // B x PA
  float* sW = sA + B * PA;             // 5U x PA
  float* G = sW + 5 * U * PA;          // B x 5U accumulators
  const int ldg = 5 * U;
  const int u0 = blockIdx.x * U;
  const int tid = threadIdx.x;
  cg::grid_group grid = cg::this_grid();

  const int64_t BH = (int64_t)B * H;
  float* h0buf = scratch;              // 2 x B x H (double buffer)
  float* c0 = scratch + 2 * BH;
  float* c1 = scratch + 3 * BH;
  float* h1 = scratch + 4 * BH;
  float* a1 = scratch + 5 * BH;        // round(fh1 * h1), published per step
  // h0 and a1 are written by other blocks: they are read with __ldcg (from
  // L2, not the SM's L1) after each grid barrier
  // gate column c (< 4U) of this block -> row of a (4H, H) weight
  auto gate_row = [=](int c) { return (c / U) * H + u0 + c % U; };

  for (int j = 0; j < J; ++j) {
    const float* h0 = h0buf + (j & 1) * BH;
    float* h0n = h0buf + ((j + 1) & 1) * BH;

    // ---- phase 1: layer-0 gates and cell update
    __syncthreads();
    for (int i = tid; i < B * 4 * U; i += THREADS) {
      const int b = i / (4 * U), c = i % (4 * U);
      G[b * ldg + c] = gp[((int64_t)b * J + j) * 4 * H + gate_row(c)];
    }
    gemm_acc<W>(sA, sW, G, ldg, 0, B, H, 4 * U,
        [=](int b, int k) {
          return round_to<W>(fh[((int64_t)b * J + j) * H + k] * __ldcg(h0 + (int64_t)b * H + k));
        },
        [=](int c) { return wh2h + (int64_t)gate_row(c) * H; });
    for (int i = tid; i < B * U; i += THREADS) {
      const int b = i / U, uu = i % U;
      const float* g = G + b * ldg;
      const int64_t at = (int64_t)b * H + u0 + uu;
      const float c = c0[at] * sigmoid(g[uu]) + sigmoid(g[U + uu]) * tanhf(g[2 * U + uu]);
      c0[at] = c;
      h0n[at] = sigmoid(g[3 * U + uu]) * tanhf(c);
    }
    grid.sync();

    // ---- phase 2: fh1 (columns [0, U)) and h0 @ Wx2h1 + b (columns [U, 5U))
    __syncthreads();
    for (int i = tid; i < B * 5 * U; i += THREADS) {
      const int b = i / (5 * U), c = i % (5 * U);
      G[b * ldg + c] = c < U ? bx2f1[u0 + c] : bx2h1[gate_row(c - U)];
    }
    gemm_acc<W>(sA, sW, G, ldg, 0, B, H, 5 * U,
        [=](int b, int k) { return round_to<W>(__ldcg(h0n + (int64_t)b * H + k)); },
        [=](int c) {
          return c < U ? wx2f1 + (int64_t)(u0 + c) * H
                       : wx2h1 + (int64_t)gate_row(c - U) * H;
        });
    for (int i = tid; i < B * U; i += THREADS) {
      const int b = i / U, uu = i % U;
      const int64_t at = (int64_t)b * H + u0 + uu;
      a1[at] = round_to<W>(sigmoid(G[b * ldg + uu]) * h1[at]);
    }
    grid.sync();

    // ---- phase 3: + (fh1 * h1) @ Wh2h1 + b, layer-1 cell update
    gemm_acc<W>(sA, sW, G, ldg, U, B, H, 4 * U,
        [=](int b, int k) { return __ldcg(a1 + (int64_t)b * H + k); },
        [=](int c) { return wh2h1 + (int64_t)gate_row(c) * H; });
    for (int i = tid; i < B * U; i += THREADS) {
      const int b = i / U, uu = i % U;
      const float* g = G + b * ldg + U;
      const int u = u0 + uu;
      const int64_t at = (int64_t)b * H + u;
      const float f = g[uu] + bh2h1[u];
      const float in = g[U + uu] + bh2h1[H + u];
      const float gg = g[2 * U + uu] + bh2h1[2 * H + u];
      const float o = g[3 * U + uu] + bh2h1[3 * H + u];
      const float c = c1[at] * sigmoid(f) + sigmoid(in) * tanhf(gg);
      c1[at] = c;
      const float h = sigmoid(o) * tanhf(c);
      h1[at] = h;
      out[((int64_t)b * J + j) * H + u] = h;
    }
  }
}

size_t smem_bytes(int B, int U) {
  return sizeof(float) * ((size_t)B * PA + (size_t)5 * U * PA + (size_t)B * 5 * U);
}

template <typename W>
cudaError_t launch(void** p, int B, int J, int H, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // smallest unit slice that gives at most one block per SM: a cooperative
  // launch needs the whole grid resident, and every block re-reads the
  // whole [B, H] operand each phase, so more blocks than SMs buys nothing
  for (int U = 1; U <= H; U *= 2) {
    if (H % U) continue;
    const size_t smem = smem_bytes(B, U);
    err = cudaFuncSetAttribute(pu_chain_kernel<W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pu_chain_kernel<W>,
                                                        THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1 || H / U > sms) continue;
    const W* wh2h = static_cast<const W*>(p[2]);
    const W* wx2f1 = static_cast<const W*>(p[3]);
    const W* wx2h1 = static_cast<const W*>(p[5]);
    const W* wh2h1 = static_cast<const W*>(p[7]);
    const float* fh = static_cast<const float*>(p[0]);
    const float* gp = static_cast<const float*>(p[1]);
    const float* bx2f1 = static_cast<const float*>(p[4]);
    const float* bx2h1 = static_cast<const float*>(p[6]);
    const float* bh2h1 = static_cast<const float*>(p[8]);
    float* out = static_cast<float*>(p[9]);
    float* scratch = static_cast<float*>(p[10]);
    void* args[] = {&fh, &gp, &wh2h, &wx2f1, &bx2f1, &wx2h1, &bx2h1, &wh2h1,
                    &bh2h1, &out, &scratch, &B, &J, &H, &U};
    err = cudaLaunchCooperativeKernel((const void*)pu_chain_kernel<W>, dim3(H / U),
                                      dim3(THREADS), args, smem, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

// Pointers, in order: fh (B,J,H) f32, gates_pre (B,J,4H) f32 incl. the
// layer-0 h2h bias, Wh2h (4H,H), Wx2f1 (H,H), bx2f1 (H) f32, Wx2h1 (4H,H),
// bx2h1 (4H) f32, Wh2h1 (4H,H), bh2h1 (4H) f32, out (B,J,H) f32, scratch
// (6,B,H) f32 zeroed by the caller. Weights are (out, in) row-major in the
// dtype given by `dtype` (0 = float32, 1 = bfloat16).
extern "C" int egotap_pu_chain(void* fh, void* gp, void* wh2h, void* wx2f1,
                               void* bx2f1, void* wx2h1, void* bx2h1,
                               void* wh2h1, void* bh2h1, void* out,
                               void* scratch, int b, int j, int hidden,
                               int dtype, void* stream) {
  void* p[] = {fh, gp, wh2h, wx2f1, bx2f1, wx2h1, bx2h1, wh2h1, bh2h1, out, scratch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, b, j, hidden, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, b, j, hidden, s);
  return (int)cudaErrorInvalidValue;
}

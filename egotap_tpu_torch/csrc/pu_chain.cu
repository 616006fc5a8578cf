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
// What bounds it on the H100: latency. The chain is J dependent steps of
// [B,H]x[H,13H/4]-sized products (3.3 GFLOP and 7 MB of bf16 weights at
// B=32, H=512: a few us of bytes or operations); every step needs the
// whole h0 of the step before, so the grid must meet at a barrier between
// steps, and the walk cannot be shorter than its barriers.
//
// Design. One cooperative launch (so that every block is resident) of
// H/U blocks; block p owns hidden units [p*U, (p+1)*U) and all four
// gates of them, so it applies their cell updates itself, and their c0,
// c1, h1 and pending layer-1 gates live in its shared memory.
// - Weights stay in shared memory for the whole walk: the block loads its
//   13U rows once by cp.async (its gate columns of Wh2h, Wx2f1, Wx2h1,
//   Wh2h1, each a row of H in the (out, in) layout of a PyTorch Linear;
//   53 KB bf16, 107 KB f32 at H=512, U=4).
// - One grid barrier per interval instead of two per joint. Layer 0 of
//   joint u needs only h0(u-1), so it runs beside layer 1 of the joints
//   before it: in interval u (u = 0 .. J+1) every block runs three
//   products on operands that were published before the barrier,
//     P0: layer 0 of joint u       on a0 = round(fh(u) * h0(u-1))
//     P1: Wx2f1|Wx2h1 of joint u-1 on x  = round(h0(u-1))
//     P2: Wh2h1 of joint u-2       on a1 = round(fh1(u-2) * h1(u-3))
//   and then the cell updates, which publish the next a0, x and a1.
//   J + 2 intervals, J + 1 barriers (from 2J), with a fill (no P1, P2 in
//   interval 0) and a drain (only P2 in interval J+1).
// - The published operands are rounded to the weight dtype by their
//   owner (half the bytes in bf16, and no fh*h0 multiply while staging),
//   and double-buffered: interval u writes slot u%2 and reads slot
//   (u+1)%2, which nobody writes until every block passed the next
//   barrier, i.e. finished reading it. Other blocks' operands are read
//   by cp.async.cg, from L2, never through the SM's L1.
// - Each product's A operand goes through a ring of k-chunks (all three
//   operands of a chunk in one stage) by cp.async, under the compute of
//   the chunk before. bf16 products run on the tensor cores
//   (mma.sync.m16n8k16, a warp's tile of 16 batch rows x 8 columns of one
//   product in two accumulator chains, fragments by ldmatrix); f32 ones
//   on the CUDA cores in 4 x 4 register tiles (a thread's 4 batch rows x
//   4 columns), TF32-free. The tiles are split over k; each split's sums
//   start afresh per chunk and are added into shared memory (the tensor
//   cores' f32 sums drift over long chains), and the splits are summed
//   in a fixed order.
// - The barrier is a counter in global memory: one arrive (release) and
//   one acquiring spin by one thread a block, between two __syncthreads.
// With `barrier_only` the walk runs its barriers and nothing else: that
// time is the kernel's latency floor. The training forward's instance
// (SAVE) also writes each joint's states for the backward: layer 0's
// sigmoid(f), sigmoid(i), tanh(g), sigmoid(o), c, h and layer 1's
// sigmoid(f), sigmoid(i), tanh(g), sigmoid(o), c, fh1, each (B, J, H)
// f32; the serving instance writes nothing more than before.
//
// The backward, `pu_chain_reverse`. No TPU kernel is replaced: the JAX
// package differentiates its lax.scan of the chain (egotap_tpu/models/
// cells.py) and its pu_chain_fused has no backward kernel. It computes
// the vector-Jacobian product of the chain in one cooperative launch, the
// reverse of the forward's walk; the weight and bias gradients are plain
// large products over all (batch, joint) rows afterwards, outside it.
// Per joint j (from J-1 down; dh1 = dout(j) + r(da1(j+1)) * fh1(j+1)):
//   layer 1: dG1 = cell backward(dh1, carry of dc1); da1 = dG1 Wh2h1^T;
//            dzf = r(da1) * h1(j-1) * fh1 (1 - fh1);
//            dx  = dG1 Wx2h1^T + dzf Wx2f1^T
//   layer 0: dh0 = r(dx) + r(da0(j+1)) * fh(j+1); dG0 = cell backward(dh0,
//            carry of dc0); da0 = dG0 Wh2h^T; dfh(j+1) = r(da0(j+1)) h0(j)
// r() rounds to the weight dtype where the forward rounds the operand
// whose gradient it is (a0, x, a1), as autograd rounds a gradient through
// a cast; the rest is f32, as in ops/pu_kernel.py:pu_chain_plain_vjp.
// What bounds it: latency again. Each joint's transposed products need
// every block's gate gradients of the joint before, so the grid meets at
// a barrier per interval; the work is the forward's (3.3 GFLOP at B=32,
// H=512, J=15), plus 3.2 GFLOP of f32 weight products after the walk.
// Design: the forward's, transposed.
// - H/U blocks; block p owns hidden units [p*U, (p+1)*U): their cell
//   backward, and the columns of the transposed products (d operand =
//   d gates . W^T) that are those units. It holds their rows of the
//   (in, out) weights in shared memory for the whole walk, 13U rows of H
//   (the forward's footprint), gathered once from the (out, in) rows the
//   forward reads, zero-padded to HP per gate.
// - Intervals u = 0 .. J+1, one grid barrier between two, J + 1 in all.
//   Interval u runs, on gradients published before the barrier,
//     P1: Wh2h1^T and Wx2h1^T on dG1 of joint J-u         (1 <= u <= J)
//     PZ: Wx2f1^T on dzf of joint J-u+1                   (u >= 2)
//     P0: Wh2h^T on dG0 of joint J-u+2                    (u >= 3)
//   then, per (batch row, unit): dzf of joint J-u, layer 1 of joint J-u-1
//   (u <= J-1) and layer 0 of joint J-u+1 (u >= 2), publishing their
//   gradients. Layer 1 of joint j runs beside layer 0 of joint j+2,
//   walked two intervals before; x2h1's part of dx waits an interval in
//   shared memory for x2f1's.
// - Published gradients stay f32 (the plain version multiplies them
//   unrounded; a bf16 operand would round them by as much as the
//   roundings the limits have to tell apart), in a double-buffered slot
//   row of 9 HP (dG1 | dzf | dG0) a batch row, read from L2 (ld.cg). So
//   the products run on the CUDA cores in f32 for both weight dtypes, the
//   weights widened as they are read: a warp's tile of 4 batch rows x 4
//   units, its 32 lanes on interleaved 4-wide k-steps, summed across the
//   lanes by a butterfly (fixed order: every lane ends with the same
//   bits).
// - The cell backward reads the forward's saved states, so sigmoid and
//   tanh are not recomputed (tanh(c) is, from the saved c, bit for bit).
// On an H100 at B=32, J=15, H=512 the walk takes 0.38 ms in either dtype
// against 0.028 ms of barriers and 0.049 ms of f32 operations at the
// CUDA cores' peak; the rest is each block's reads of every block's
// gradients (590 KB an interval, from L2) and its products, in shares
// not measured apart.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename W> __device__ __forceinline__ W from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// four consecutive values as f32, by one 16-byte (f32) or 8-byte (bf16) load
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16); v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16); v[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// every block of the grid has arrived `target / gridDim.x` times
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" :: "l"(counter) : "memory");
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

constexpr int NST = 2;          // stages of the operand ring

// Launch geometry: U from the wrapper (egotap_tpu_torch/ops/pu_kernel.py),
// KC and KS from `prepare`
struct Geo {
  int B, J, H, HP, U;           // HP: H padded to a multiple of 16
  int WL;                       // row pitch of the weights (H or HP)
  int KC, KS;                   // k-chunk of the ring; k-splits of a tile
};

template <typename W> struct Layout {
  int wp, ap;                   // row pitches (elements) of weights, operands
  size_t w_off, a_off, p_off, s_off, bytes;
  __host__ __device__ Layout(const Geo& g) {
    wp = g.HP + 16 / (int)sizeof(W);         // +16 bytes: rows on other banks
    ap = g.KC + 16 / (int)sizeof(W);
    w_off = 0;
    a_off = w_off + (size_t)13 * g.U * wp * sizeof(W);
    p_off = a_off + (size_t)NST * 3 * g.B * ap * sizeof(W);
    s_off = p_off + (size_t)g.KS * g.B * 13 * g.U * sizeof(float);
    // c0, c1, h1 (B x U), pending layer-1 gates (B x 4U), biases (9U)
    bytes = s_off + ((size_t)g.B * 7 * g.U + 9 * g.U) * sizeof(float);
  }
};

// ---- one k-chunk of the three products, added into P[ks][b][column].
// Product p (0: Wh2h on a0, 1: Wx2f1|Wx2h1 on x, 2: Wh2h1 on a1) has
// width 4U, 5U, 4U and its weights at rows 0, 4U, 9U of the block's 13U.
// Its k-range [c*KC, (c+1)*KC) is cut into KS splits, each summed on its
// own and added into its own plane of P (fresh sums per chunk and split).
__device__ __forceinline__ void product_of(int grp, int n0, int n1, int U, int n,
                                           int& p, int& cb, int& width, int& row0) {
  if (grp < n0) { p = 0; cb = n * grp; width = 4 * U; row0 = 0; }
  else if (grp < n0 + n1) { p = 1; cb = n * (grp - n0); width = 5 * U; row0 = 4 * U; }
  else { p = 2; cb = n * (grp - n0 - n1); width = 4 * U; row0 = 9 * U; }
}

// f32: on the CUDA cores, a thread's 4 x 4 register tile of batch rows
// rg + RG*i and columns cb + j of one product, over its k-split
__device__ void chunk_products(const float* As, const float* Wsm, float* P, int ap,
                               int wp, int B, int U, int c, int KC, int KS) {
  const int n0 = U, n1 = (5 * U + 3) / 4;
  const int RG = (B + 3) / 4;
  const int tiles = RG * (n0 + n1 + U), ksl = KC / KS, NCOL = 13 * U;
  for (int it = threadIdx.x; it < tiles * KS; it += THREADS) {
    const int ks = it / tiles, tile = it % tiles, rg = tile % RG;
    int p, cb, width, row0;
    product_of(tile / RG, n0, n1, U, 4, p, cb, width, row0);
    const float* a[4];
    const float* w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = As + (size_t)(p * B + min(rg + RG * i, B - 1)) * ap + ks * ksl;
      w[i] = Wsm + (size_t)(row0 + min(cb + i, width - 1)) * wp + c * KC + ks * ksl;
    }
    float acc[4][4] = {};
    for (int kk = 0; kk < ksl; kk += 4) {
      float av[4][4], wv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) { load4(a[i] + kk, av[i]); load4(w[i] + kk, wv[i]); }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i][q], wv[j][q], acc[i][j]);
    }
    float* Pk = P + (size_t)ks * B * NCOL;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + RG * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (r >= B || cb + j >= width) continue;
        float* dst = Pk + (size_t)r * NCOL + row0 + cb + j;
        *dst = c == 0 ? acc[i][j] : *dst + acc[i][j];
      }
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16: on the tensor cores, a warp's m16n8k16 tile of 16 batch rows x 8
// columns of one product over its k-split, fragments by ldmatrix (rows
// past B or past the product's width read a clamped row, never stored)
__device__ void chunk_products(const __nv_bfloat16* As, const __nv_bfloat16* Wsm,
                               float* P, int ap, int wp, int B, int U, int c,
                               int KC, int KS) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = (4 * U + 7) / 8, n1 = (5 * U + 7) / 8;
  const int MT = (B + 15) / 16;
  const int tiles = MT * (2 * n0 + n1), ksl = KC / KS, NCOL = 13 * U;
  for (int it = warp; it < tiles * KS; it += THREADS / 32) {
    const int ks = it / tiles, tile = it % tiles, mt = tile % MT;
    int p, cb, width, row0;
    product_of(tile / MT, n0, n1, U, 8, p, cb, width, row0);
    const __nv_bfloat16* a =
        As + (size_t)(p * B + min(16 * mt + (lane & 15), B - 1)) * ap + ks * ksl + (lane >> 4) * 8;
    const __nv_bfloat16* w = Wsm + (size_t)(row0 + min(cb + (lane & 7), width - 1)) * wp +
                             c * KC + ks * ksl + ((lane >> 3) & 1) * 8;
    // two accumulator chains (even and odd 16-k steps), added at the end:
    // each half as long, so its f32 sums drift less
    float d[4] = {0.f, 0.f, 0.f, 0.f}, e[4] = {0.f, 0.f, 0.f, 0.f};
    int kk = 0;
    for (; kk + 32 <= ksl; kk += 32) {
      uint32_t af[4], bf[2], ag[4], bg[2];
      ldsm_x4(af, a + kk);
      ldsm_x2(bf, w + kk);
      ldsm_x4(ag, a + kk + 16);
      ldsm_x2(bg, w + kk + 16);
      mma_bf16(d, af, bf);
      mma_bf16(e, ag, bg);
    }
    if (kk < ksl) {
      uint32_t af[4], bf[2];
      ldsm_x4(af, a + kk);
      ldsm_x2(bf, w + kk);
      mma_bf16(d, af, bf);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q] += e[q];
    float* Pk = P + (size_t)ks * B * NCOL;
    const int col = cb + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + (lane >> 2) + 8 * h;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (r >= B || col + q >= width) continue;
        float* dst = Pk + (size_t)r * NCOL + row0 + col + q;
        *dst = c == 0 ? d[2 * h + q] : *dst + d[2 * h + q];
      }
    }
  }
}

// work items of a chunk (before the k-split) and how many the block takes
// at once: threads for the f32 tiles, four a warp for the bf16 ones
template <typename W> int work_tiles(int B, int U) {
  return sizeof(W) == 4 ? (B + 3) / 4 * (U + (5 * U + 3) / 4 + U)
                        : (B + 15) / 16 * (2 * ((4 * U + 7) / 8) + (5 * U + 7) / 8);
}
template <typename W> int work_slots() { return sizeof(W) == 4 ? THREADS : 4 * THREADS / 32; }

template <typename W, bool SAVE>
__global__ void __launch_bounds__(THREADS, 1)
pu_chain_kernel(const float* __restrict__ fh, const float* __restrict__ gp,
                const W* __restrict__ w0, const W* __restrict__ wx2f1,
                const W* __restrict__ wx2h1, const W* __restrict__ wh2h1,
                const float* __restrict__ bx2f1,
                const float* __restrict__ bx2h1, const float* __restrict__ bh2h1,
                float* __restrict__ out, W* ops, unsigned* counter, Geo g,
                int barrier_only, float* __restrict__ states) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<W> L(g);
  const int B = g.B, J = g.J, H = g.H, HP = g.HP, U = g.U, wld = g.WL;
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * U;
  const unsigned nblk = gridDim.x;

  if (barrier_only) {
    for (int u = 0; u <= J; ++u) grid_barrier(counter, (u + 1) * nblk);
    return;
  }

  W* Wsm = reinterpret_cast<W*>(smem + L.w_off);
  W* Asm = reinterpret_cast<W*>(smem + L.a_off);
  float* P = reinterpret_cast<float*>(smem + L.p_off);
  float* c0 = reinterpret_cast<float*>(smem + L.s_off);
  float* c1 = c0 + B * U;
  float* h1 = c1 + B * U;
  float* pend = h1 + B * U;                  // B x 4U
  float* bias = pend + B * 4 * U;            // bx2f1 (U), bx2h1 (4U), bh2h1 (4U)
  const int NCOL = 13 * U;

  // ---- weights, once: row r of the block's 13U is gate r/U (of its
  // matrix) of unit u0 + r%U, the first wld values by cp.async, then
  // zeros up to HP
  {
    const int vpr = wld * (int)sizeof(W) / 16;             // 16-byte vectors a row
    for (int i = tid; i < NCOL * vpr; i += THREADS) {
      const int r = i / vpr, v = i % vpr;
      const W* m = r < 4 * U ? w0 : r < 5 * U ? wx2f1 : r < 9 * U ? wx2h1 : wh2h1;
      const int rr = r < 4 * U ? r : r < 5 * U ? r - 4 * U : r < 9 * U ? r - 5 * U : r - 9 * U;
      const W* src = m + (size_t)(rr / U * H + u0 + rr % U) * wld;
      cp_async16(reinterpret_cast<unsigned char*>(Wsm + (size_t)r * L.wp) + 16 * v,
                 reinterpret_cast<const unsigned char*>(src) + 16 * v);
    }
    cp_async_commit();
    for (int i = tid; i < NCOL * (HP - wld); i += THREADS)
      Wsm[(size_t)(i / (HP - wld)) * L.wp + wld + i % (HP - wld)] = from_f<W>(0.f);
  }
  for (int i = tid; i < B * 7 * U; i += THREADS) c0[i] = 0.f;   // c0, c1, h1, pend
  for (int i = tid; i < 4 * U; i += THREADS) {
    const int at = i / U * H + u0 + i % U;                // gate i/U, unit i%U
    if (i < U) bias[i] = bx2f1[u0 + i];
    bias[U + i] = bx2h1[at];
    bias[5 * U + i] = bh2h1[at];
  }

  const int nch = HP / g.KC;
  const int64_t slot_elems = (int64_t)B * HP;   // ops: [3][2][B][HP]

  // stage chunk c (k from c*KC) of all three operands of slot `rd`
  auto stage = [&](int c, int rd) {
    W* dst = Asm + (size_t)(c % NST) * 3 * B * L.ap;
    const int vpr = g.KC * (int)sizeof(W) / 16;
    for (int i = tid; i < 3 * B * vpr; i += THREADS) {
      const int v = i % vpr, row = i / vpr, p = row / B, b = row % B;
      const W* src = ops + (2 * p + rd) * slot_elems + (int64_t)b * HP + c * g.KC;
      cp_async16(reinterpret_cast<unsigned char*>(dst + (size_t)row * L.ap) + 16 * v,
                 reinterpret_cast<const unsigned char*>(src) + 16 * v);
    }
  };

  for (int u = 0; u <= J + 1; ++u) {
    const int rd = (u + 1) & 1, wr = u & 1;
    // ---- the three products, k-chunk by k-chunk through the ring
    stage(0, rd);
    cp_async_commit();
    for (int c = 0; c < nch; ++c) {
      if (c + 1 < nch) stage(c + 1, rd);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const W* As = Asm + (size_t)(c % NST) * 3 * B * L.ap;
      chunk_products(As, Wsm, P, L.ap, L.wp, B, U, c, g.KC, g.KS);
      __syncthreads();                       // the slot is refilled next
    }
    // ---- the k-splits summed in order, into split 0
    for (int e = tid; e < B * NCOL; e += THREADS) {
      float s = P[e];
      for (int ks = 1; ks < g.KS; ++ks) s += P[(size_t)ks * B * NCOL + e];
      P[e] = s;
    }
    __syncthreads();

    // ---- cell updates of this block's units; publish a0, x, a1 into slot wr
    W* a0w = ops + (0 * 2 + wr) * slot_elems;
    W* xw = ops + (1 * 2 + wr) * slot_elems;
    W* a1w = ops + (2 * 2 + wr) * slot_elems;
    for (int e = tid; e < B * U; e += THREADS) {
      const int b = e / U, uu = e % U, hu = u0 + uu;
      const float* G = P + (size_t)b * NCOL;
      const int64_t at = (int64_t)b * HP + hu;
      if (u < J) {                                      // layer 0, joint u
        const float* gpr = gp + ((int64_t)b * J + u) * 4 * H + hu;
        const float f = __ldg(gpr) + G[uu];
        const float in = __ldg(gpr + H) + G[U + uu];
        const float gg = __ldg(gpr + 2 * H) + G[2 * U + uu];
        const float o = __ldg(gpr + 3 * H) + G[3 * U + uu];
        const float c = c0[e] * sigmoid(f) + sigmoid(in) * tanhf(gg);
        c0[e] = c;
        const float h = sigmoid(o) * tanhf(c);
        if constexpr (SAVE) {
          float* s = states + ((int64_t)b * J + u) * H + hu;
          const int64_t pl = (int64_t)B * J * H;
          s[0] = sigmoid(f); s[pl] = sigmoid(in); s[2 * pl] = tanhf(gg);
          s[3 * pl] = sigmoid(o); s[4 * pl] = c; s[5 * pl] = h;
        }
        xw[at] = from_f<W>(h);
        if (u + 1 < J) a0w[at] = from_f<W>(__ldg(fh + ((int64_t)b * J + u + 1) * H + hu) * h);
      }
      if (u >= 2) {                                     // layer 1, joint u-2
        const float* pe = pend + b * 4 * U;
        const float* bh = bias + 5 * U;
        const float f = pe[uu] + G[9 * U + uu] + bh[uu];
        const float in = pe[U + uu] + G[10 * U + uu] + bh[U + uu];
        const float gg = pe[2 * U + uu] + G[11 * U + uu] + bh[2 * U + uu];
        const float o = pe[3 * U + uu] + G[12 * U + uu] + bh[3 * U + uu];
        const float c = c1[e] * sigmoid(f) + sigmoid(in) * tanhf(gg);
        c1[e] = c;
        const float h = sigmoid(o) * tanhf(c);
        if constexpr (SAVE) {
          float* s = states + ((int64_t)b * J + u - 2) * H + hu;
          const int64_t pl = (int64_t)B * J * H;
          s[6 * pl] = sigmoid(f); s[7 * pl] = sigmoid(in); s[8 * pl] = tanhf(gg);
          s[9 * pl] = sigmoid(o); s[10 * pl] = c;
        }
        h1[e] = h;
        out[((int64_t)b * J + u - 2) * H + hu] = h;
      }
      if (u >= 1 && u <= J) {                           // x2f1, x2h1, joint u-1
        const float fh1 = sigmoid(G[4 * U + uu] + bias[uu]);
        if constexpr (SAVE)
          states[11 * (int64_t)B * J * H + ((int64_t)b * J + u - 1) * H + hu] = fh1;
        float* pe = pend + b * 4 * U;
#pragma unroll
        for (int gt = 0; gt < 4; ++gt)
          pe[gt * U + uu] = G[(5 + gt) * U + uu] + bias[U + gt * U + uu];
        a1w[at] = from_f<W>(fh1 * h1[e]);
      }
    }
    if (u <= J) grid_barrier(counter, (u + 1) * nblk);
  }
}

bool valid(const Geo& g) {
  return g.B >= 1 && g.J >= 1 && g.U >= 1 && g.H % g.U == 0 && g.HP % 16 == 0 &&
         g.HP >= g.H && (g.WL == g.H || g.WL == g.HP);
}

// The largest k-chunk (<= 256, dividing HP) whose layout fits the card's
// shared memory, and as many k-splits as keep every thread busy; sets
// g.KC, g.KS and the block's shared memory bytes.
template <typename W, bool SAVE>
cudaError_t prepare(Geo& g, size_t* smem) {
  if (!valid(g) || g.WL * sizeof(W) % 16) return cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int tiles = work_tiles<W>(g.B, g.U);
  for (g.KC = 256; g.KC >= 16; g.KC /= 2) {
    if (g.HP % g.KC) continue;
    for (g.KS = 1; 2 * g.KS * tiles <= work_slots<W>() && g.KC % (32 * g.KS) == 0;)
      g.KS *= 2;
    *smem = Layout<W>(g).bytes;
    if (*smem <= (size_t)limit)
      return cudaFuncSetAttribute(pu_chain_kernel<W, SAVE>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  }
  return cudaErrorInvalidValue;       // the weights alone do not fit
}

template <typename W, bool SAVE>
cudaError_t launch(void** p, Geo g, int barrier_only, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = prepare<W, SAVE>(g, &smem);
  if (err != cudaSuccess) return err;
  const float* fh = static_cast<const float*>(p[0]);
  const float* gp = static_cast<const float*>(p[1]);
  const W* w0 = static_cast<const W*>(p[2]);
  const W* wx2f1 = static_cast<const W*>(p[3]);
  const W* wx2h1 = static_cast<const W*>(p[4]);
  const W* wh2h1 = static_cast<const W*>(p[5]);
  const float* bx2f1 = static_cast<const float*>(p[6]);
  const float* bx2h1 = static_cast<const float*>(p[7]);
  const float* bh2h1 = static_cast<const float*>(p[8]);
  float* out = static_cast<float*>(p[9]);
  W* ops = static_cast<W*>(p[10]);
  unsigned* counter = static_cast<unsigned*>(p[11]);
  float* states = SAVE ? static_cast<float*>(p[12]) : nullptr;
  void* args[] = {&fh, &gp, &w0, &wx2f1, &wx2h1, &wh2h1, &bx2f1, &bx2h1, &bh2h1,
                  &out, &ops, &counter, &g, &barrier_only, &states};
  // cooperative: refused (cudaErrorCooperativeLaunchTooLarge) unless every
  // block of the grid can be resident at once, which the barrier needs
  err = cudaLaunchCooperativeKernel((const void*)pu_chain_kernel<W, SAVE>, dim3(g.H / g.U),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- the reverse walk (see the note at the top)

// x rounded to the weight dtype, as f32
template <typename W> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the backward of an LSTM cell update from its activations (sf, si, tg,
// so), its c and the c before; d = the preactivations' gradient (f, i, g,
// o); `carry` in: the gradient the next joint sent to c, out: this cell's
// to the c before. Sigmoid's backward is g (1 - s) s, tanh's g (1 - t^2).
__device__ __forceinline__ void cell_reverse(float dh, float& carry, float sf, float si,
                                             float tg, float so, float c, float cp,
                                             float d[4]) {
  const float tc = tanhf(c);
  const float dc = dh * so * (1.f - tc * tc) + carry;
  carry = dc * sf;
  d[0] = dc * cp * (1.f - sf) * sf;
  d[1] = dc * tg * (1.f - si) * si;
  d[2] = dc * si * (1.f - tg * tg);
  d[3] = dh * tc * (1.f - so) * so;
}

template <typename W> struct RevLayout {
  int up;                       // a unit's row of weights: 13 HP
  size_t p_off, s_off, bytes;
  __host__ __device__ RevLayout(const Geo& g) {
    up = 13 * g.HP;
    p_off = (size_t)g.U * up * sizeof(W);
    // products: B x 4U (da1 | dx from x2h1 | dx from x2f1 | da0)
    s_off = p_off + (size_t)g.B * 4 * g.U * sizeof(float);
    // carries of dc0, dc1 and the x2h1 part of dx (B x U each)
    bytes = s_off + (size_t)g.B * 3 * g.U * sizeof(float);
  }
};

// one 4-wide k-step of a warp's tile: 4 values of rows a[i] of a
// published slot row, read from L2 (other blocks wrote them)
__device__ __forceinline__ void load_rows(const float* const a[4], int k, float av[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(a[i] + k));
    av[i][0] = t.x; av[i][1] = t.y; av[i][2] = t.z; av[i][3] = t.w;
  }
}
// ... times the weights w[jj] of its units, into acc[i][jj]
template <typename W>
__device__ __forceinline__ void step4(const float av[4][4], const W* const w[4], int kw,
                                      float acc[4][4]) {
  float wv[4][4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) load4(w[jj] + kw, wv[jj]);
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i][q], wv[jj][q], acc[i][jj]);
}

__device__ __forceinline__ void lane_sum(float acc[4][4]) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        acc[i][jj] += __shfl_xor_sync(0xffffffffu, acc[i][jj], off);
}

template <typename W>
__global__ void __launch_bounds__(THREADS, 1)
pu_chain_reverse(const float* __restrict__ fh, const float* __restrict__ dout,
                 const float* __restrict__ out, const float* __restrict__ st,
                 const W* __restrict__ w0, const W* __restrict__ wx2f1,
                 const W* __restrict__ wx2h1, const W* __restrict__ wh2h1,
                 float* __restrict__ dgp, float* __restrict__ dg1,
                 float* __restrict__ dzf, float* __restrict__ dfh,
                 float* __restrict__ opnd, float* slots, unsigned* counter, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RevLayout<W> L(g);
  const int B = g.B, J = g.J, H = g.H, HP = g.HP, U = g.U, wld = g.WL;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int u0 = blockIdx.x * U;
  const unsigned nblk = gridDim.x;
  const int RW = 9 * HP;                        // a slot row: dG1 | dzf | dG0
  const int64_t pl = (int64_t)B * J * H;        // a (B, J, H) plane

  W* Wt = reinterpret_cast<W*>(smem);
  float* P = reinterpret_cast<float*>(smem + L.p_off);
  float* dc0 = reinterpret_cast<float*>(smem + L.s_off);
  float* dc1 = dc0 + B * U;
  float* pend = dc1 + B * U;

  // ---- weights, once: unit uu's row holds its (in, out) rows of Wh2h1
  // (k in [0, 4HP)), Wx2h1 ([4HP, 8HP)), Wx2f1 ([8HP, 9HP)) and Wh2h
  // ([9HP, 13HP)), gate by gate at a pitch of HP, zero from H on; value
  // (unit, output n) is the (out, in) row n's entry u0 + uu
  for (int i = tid; i < 13 * HP * U; i += THREADS) {
    const int uu = i % U, k = i / U;
    const int seg = k < 4 * HP ? 0 : k < 8 * HP ? 1 : k < 9 * HP ? 2 : 3;
    const W* m = seg == 0 ? wh2h1 : seg == 1 ? wx2h1 : seg == 2 ? wx2f1 : w0;
    const int kk = k - (seg == 0 ? 0 : seg == 1 ? 4 * HP : seg == 2 ? 8 * HP : 9 * HP);
    const int n = kk % HP;
    Wt[(size_t)uu * L.up + k] =
        n < H ? m[(size_t)(kk / HP * H + n) * wld + u0 + uu] : from_f<W>(0.f);
  }
  for (int i = tid; i < 3 * B * U; i += THREADS) dc0[i] = 0.f;   // dc0, dc1, pend
  __syncthreads();

  const int RG = (B + 3) / 4, UQ = (U + 3) / 4;
  for (int u = 0; u <= J + 1; ++u) {
    const int rd = (u + 1) & 1, wr = u & 1, j1 = J - u;
    const bool p1 = u >= 1 && u <= J, pz = u >= 2, p0 = u >= 3;
    // ---- the transposed products: a warp's tile of 4 batch rows x 4
    // units, its lanes on interleaved k-steps, then summed over the lanes
    const float* Gs = slots + (size_t)rd * B * RW;
    for (int t = warp; t < RG * UQ; t += THREADS / 32) {
      const int rg = t % RG, uq = t / RG;
      const float* a[4];
      const W* w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Gs + (size_t)min(rg + RG * i, B - 1) * RW;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) w[jj] = Wt + (size_t)min(4 * uq + jj, U - 1) * L.up;
      float s1[4][4] = {}, sx[4][4] = {}, sz[4][4] = {}, s0[4][4] = {};
      float av[4][4];
      if (p1)                      // dG1: Wh2h1 -> da1, Wx2h1 -> dx
        for (int k = 4 * lane; k < 4 * HP; k += 128) {
          load_rows(a, k, av);
          step4(av, w, k, s1);
          step4(av, w, 4 * HP + k, sx);
        }
      if (pz)                      // dzf: Wx2f1 -> dx
        for (int k = 4 * HP + 4 * lane; k < 5 * HP; k += 128) {
          load_rows(a, k, av);
          step4(av, w, 4 * HP + k, sz);
        }
      if (p0)                      // dG0: Wh2h -> da0
        for (int k = 5 * HP + 4 * lane; k < 9 * HP; k += 128) {
          load_rows(a, k, av);
          step4(av, w, 4 * HP + k, s0);
        }
      lane_sum(s1);
      lane_sum(sx);
      lane_sum(sz);
      lane_sum(s0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int r = rg + RG * i, c = 4 * uq + jj;
          if (lane != 4 * i + jj || r >= B || c >= U) continue;
          float* Pr = P + (size_t)r * 4 * U + c;
          Pr[0] = s1[i][jj]; Pr[U] = sx[i][jj]; Pr[2 * U] = sz[i][jj]; Pr[3 * U] = s0[i][jj];
        }
    }
    __syncthreads();

    // ---- the cell backward of this block's units; publish into slot wr
    for (int e = tid; e < B * U; e += THREADS) {
      const int b = e / U, uu = e % U, hu = u0 + uu;
      const float* R = P + (size_t)b * 4 * U;
      float* Gw = slots + (size_t)wr * B * RW + (size_t)b * RW;
      auto at = [&](int j) { return ((int64_t)b * J + j) * H + hu; };
      auto S = [&](int k, int j) { return st[k * pl + at(j)]; };
      const float ra1 = rnd<W>(R[uu]);
      if (u >= 2) {                                     // layer 0, joint J-u+1
        const int j = j1 + 1;
        float dh = rnd<W>(pend[e] + R[2 * U + uu]);
        if (p0) {
          const float ra0 = rnd<W>(R[3 * U + uu]);
          dh += ra0 * fh[at(j + 1)];
          dfh[at(j + 1)] = ra0 * S(5, j);
        }
        const float hp = j ? S(5, j - 1) : 0.f;
        if (j == 0) dfh[at(0)] = 0.f;
        opnd[at(j)] = rnd<W>(fh[at(j)] * hp);    // a0
        float d[4];
        cell_reverse(dh, dc0[e], S(0, j), S(1, j), S(2, j), S(3, j), S(4, j),
                     j ? S(4, j - 1) : 0.f, d);
        float* gp = dgp + ((int64_t)b * J + j) * 4 * H + hu;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          Gw[5 * HP + q * HP + hu] = d[q];
          gp[q * H] = d[q];
        }
      }
      if (p1) {                                         // x2f1 of joint J-u
        const int j = j1;
        const float h1p = j ? out[at(j - 1)] : 0.f, f1 = S(11, j);
        const float z = ra1 * h1p * (1.f - f1) * f1;
        Gw[4 * HP + hu] = z;
        dzf[at(j)] = z;
        pend[e] = R[U + uu];
        opnd[pl + at(j)] = rnd<W>(S(5, j));           // x
        opnd[2 * pl + at(j)] = rnd<W>(f1 * h1p);      // a1
      }
      if (u <= J - 1) {                                 // layer 1, joint J-u-1
        const int j = j1 - 1;
        float dh = dout[at(j)];
        if (p1) dh += ra1 * S(11, j + 1);
        float d[4];
        cell_reverse(dh, dc1[e], S(6, j), S(7, j), S(8, j), S(9, j), S(10, j),
                     j ? S(10, j - 1) : 0.f, d);
        float* g1 = dg1 + ((int64_t)b * J + j) * 4 * H + hu;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          Gw[q * HP + hu] = d[q];
          g1[q * H] = d[q];
        }
      }
    }
    if (u <= J) grid_barrier(counter, (u + 1) * nblk);
  }
}

template <typename W>
cudaError_t prepare_reverse(const Geo& g, size_t* smem) {
  if (!valid(g) || g.WL * sizeof(W) % 16) return cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *smem = RevLayout<W>(g).bytes;
  if (*smem > (size_t)limit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(pu_chain_reverse<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

template <typename W>
cudaError_t launch_reverse(void** p, Geo g, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = prepare_reverse<W>(g, &smem);
  if (err != cudaSuccess) return err;
  const float* in[4];
  const W* w[4];
  float* o[6];
  for (int i = 0; i < 4; ++i) in[i] = static_cast<const float*>(p[i]);
  for (int i = 0; i < 4; ++i) w[i] = static_cast<const W*>(p[4 + i]);
  for (int i = 0; i < 6; ++i) o[i] = static_cast<float*>(p[8 + i]);
  unsigned* counter = static_cast<unsigned*>(p[14]);
  void* args[] = {&in[0], &in[1], &in[2], &in[3], &w[0], &w[1], &w[2], &w[3],
                  &o[0], &o[1], &o[2], &o[3], &o[4], &o[5], &counter, &g};
  err = cudaLaunchCooperativeKernel((const void*)pu_chain_reverse<W>, dim3(g.H / g.U),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Pointers, in order: fh (B,J,H) f32, gates_pre (B,J,4H) f32 incl. the
// layer-0 h2h bias, the weights Wh2h (4H rows), Wx2f1 (H), Wx2h1 (4H),
// Wh2h1 (4H) in the weight dtype, each in the (out, in) layout (row n:
// the H weights of output column n, at a pitch of `wld` = H or HP values,
// 16-byte aligned, zero from H on), bx2f1 (H) f32, bx2h1 (4H) f32, bh2h1
// (4H) f32, out (B,J,H) f32, the published operands (3, 2, B, HP) in the
// weight dtype and a counter (uint32), both zeroed by the caller. dtype
// 0 = float32, 1 = bfloat16.
extern "C" int egotap_pu_chain(void* fh, void* gp, void* w0, void* wx2f1,
                               void* wx2h1, void* wh2h1, void* bx2f1,
                               void* bx2h1, void* bh2h1, void* out, void* ops,
                               void* counter, int b, int j, int hidden, int hp,
                               int wld, int units, int dtype, int barrier_only,
                               void* stream) {
  void* p[] = {fh, gp, w0, wx2f1, wx2h1, wh2h1, bx2f1, bx2h1, bh2h1, out, ops, counter};
  const Geo g{b, j, hidden, hp, units, wld, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float, false>(p, g, barrier_only, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16, false>(p, g, barrier_only, s);
  return (int)cudaErrorInvalidValue;
}

// The training forward: `egotap_pu_chain`'s walk (never barrier-only)
// that also writes the joints' states (12, B, J, H) f32, in the order of
// the note at the top, for `egotap_pu_chain_backward`.
extern "C" int egotap_pu_chain_save(void* fh, void* gp, void* w0, void* wx2f1,
                                    void* wx2h1, void* wh2h1, void* bx2f1,
                                    void* bx2h1, void* bh2h1, void* out, void* ops,
                                    void* counter, void* states, int b, int j,
                                    int hidden, int hp, int wld, int units, int dtype,
                                    void* stream) {
  void* p[] = {fh, gp, w0, wx2f1, wx2h1, wh2h1, bx2f1, bx2h1, bh2h1, out, ops, counter,
               states};
  const Geo g{b, j, hidden, hp, units, wld, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float, true>(p, g, 0, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16, true>(p, g, 0, s);
  return (int)cudaErrorInvalidValue;
}

// The backward. Pointers, in order: fh (B,J,H) f32, the output's gradient
// (B,J,H) f32, the forward's output (B,J,H) f32 and states (12,B,J,H) f32,
// the weights Wh2h, Wx2f1, Wx2h1, Wh2h1 as `egotap_pu_chain` takes them;
// out: the layer-0 gate gradients (B,J,4H) (= the gradient of gates_pre),
// the layer-1 gate gradients (B,J,4H), dzf (B,J,H), the gradient of fh
// (B,J,H), the walk's rounded operands a0, x, a1 (3,B,J,H), all f32; the
// published gradients (2, B, 9 HP) f32 and a counter (uint32), both zeroed
// by the caller.
extern "C" int egotap_pu_chain_backward(void* fh, void* dout, void* out, void* states,
                                        void* w0, void* wx2f1, void* wx2h1,
                                        void* wh2h1, void* dgp, void* dg1, void* dzf,
                                        void* dfh, void* operands, void* slots,
                                        void* counter, int b, int j, int hidden,
                                        int hp, int wld, int units, int dtype,
                                        void* stream) {
  void* p[] = {fh, dout, out, states, w0, wx2f1, wx2h1, wh2h1, dgp, dg1, dzf, dfh,
               operands, slots, counter};
  const Geo g{b, j, hidden, hp, units, wld, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_reverse<float>(p, g, s);
  if (dtype == 1) return (int)launch_reverse<__nv_bfloat16>(p, g, s);
  return (int)cudaErrorInvalidValue;
}

// What one block of the kernel for `dtype` takes at this geometry:
// info[0] = blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// info[1] = registers a thread, info[2] = local (spill) bytes a thread,
// info[3] = dynamic + static shared memory bytes a block, info[4] =
// threads a block, info[5] = SMs of the card, info[6] = the k-chunk,
// info[7] = the k-splits of a tile.
extern "C" int egotap_pu_chain_occupancy(int dtype, int b, int hidden, int hp,
                                         int units, int* info) {
  Geo g{b, 1, hidden, hp, units, hp, 0, 0};
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const void* kernel = dtype == 0 ? (const void*)pu_chain_kernel<float, false>
                                  : (const void*)pu_chain_kernel<__nv_bfloat16, false>;
  size_t smem = 0;
  cudaError_t err = dtype == 0 ? prepare<float, false>(g, &smem)
                               : prepare<__nv_bfloat16, false>(g, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, THREADS, smem);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&info[5], cudaDevAttrMultiProcessorCount, dev);
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = (int)smem + (int)attr.sharedSizeBytes;
  info[4] = THREADS;
  info[6] = g.KC;
  info[7] = g.KS;
  return (int)err;
}

// What one block of the backward for `dtype` takes at this geometry:
// info[0] = blocks an SM, info[1] = registers a thread, info[2] = local
// (spill) bytes a thread, info[3] = shared memory bytes a block, info[4]
// = threads a block, info[5] = SMs of the card.
extern "C" int egotap_pu_chain_backward_occupancy(int dtype, int b, int hidden, int hp,
                                                  int units, int* info) {
  Geo g{b, 1, hidden, hp, units, hp, 0, 0};
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const void* kernel = dtype == 0 ? (const void*)pu_chain_reverse<float>
                                  : (const void*)pu_chain_reverse<__nv_bfloat16>;
  size_t smem = 0;
  cudaError_t err = dtype == 0 ? prepare_reverse<float>(g, &smem)
                               : prepare_reverse<__nv_bfloat16>(g, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, THREADS, smem);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&info[5], cudaDevAttrMultiProcessorCount, dev);
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = (int)smem + (int)attr.sharedSizeBytes;
  info[4] = THREADS;
  return (int)err;
}

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
// time is the kernel's latency floor.

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

template <typename W>
__global__ void __launch_bounds__(THREADS, 1)
pu_chain_kernel(const float* __restrict__ fh, const float* __restrict__ gp,
                const W* __restrict__ w0, const W* __restrict__ wx2f1,
                const W* __restrict__ wx2h1, const W* __restrict__ wh2h1,
                const float* __restrict__ bx2f1,
                const float* __restrict__ bx2h1, const float* __restrict__ bh2h1,
                float* __restrict__ out, W* ops, unsigned* counter, Geo g,
                int barrier_only) {
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
        h1[e] = h;
        out[((int64_t)b * J + u - 2) * H + hu] = h;
      }
      if (u >= 1 && u <= J) {                           // x2f1, x2h1, joint u-1
        const float fh1 = sigmoid(G[4 * U + uu] + bias[uu]);
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
template <typename W>
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
      return cudaFuncSetAttribute(pu_chain_kernel<W>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  }
  return cudaErrorInvalidValue;       // the weights alone do not fit
}

template <typename W>
cudaError_t launch(void** p, Geo g, int barrier_only, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = prepare<W>(g, &smem);
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
  void* args[] = {&fh, &gp, &w0, &wx2f1, &wx2h1, &wh2h1, &bx2f1, &bx2h1, &bh2h1,
                  &out, &ops, &counter, &g, &barrier_only};
  // cooperative: refused (cudaErrorCooperativeLaunchTooLarge) unless every
  // block of the grid can be resident at once, which the barrier needs
  err = cudaLaunchCooperativeKernel((const void*)pu_chain_kernel<W>, dim3(g.H / g.U),
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
  if (dtype == 0) return (int)launch<float>(p, g, barrier_only, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, g, barrier_only, s);
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
  const void* kernel = dtype == 0 ? (const void*)pu_chain_kernel<float>
                                  : (const void*)pu_chain_kernel<__nv_bfloat16>;
  size_t smem = 0;
  cudaError_t err = dtype == 0 ? prepare<float>(g, &smem) : prepare<__nv_bfloat16>(g, &smem);
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

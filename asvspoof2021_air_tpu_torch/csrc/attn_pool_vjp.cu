// B4a / B4b: ECAPA's differentiable softmax-weighted statistics (training).
//
// Replaces the JAX package's Pallas kernels _fwd_kernel (B4a,
// ops/attn_pool_vjp.py:53) and _bwd_kernel (B4b, :72), the forward and
// backward of the custom VJP fused_softmax_stats. Per utterance b and
// channel d, over t < T:
//   logits = h2 @ W2 + b2;  w = softmax over T;
//   mu = sum w x,  e2 = sum w x^2                                   (B4a)
//   q = g_mu x + g_e2 x^2,  S = sum w q,  dlog = w (q - S)
//   dx = w (g_mu + 2 g_e2 x);  dh2 = dlog @ W2^T;  dW2 = sum_b h2^T dlog;
//   db2 = 0 (softmax over T cancels the bias)                       (B4b)
// The (B, T, D) logits and weights never reach device memory in either
// direction: the backward recomputes them from the (B, T, 128) hidden h2.
//
// B4a, per 128-channel tile and utterance, keeps W2's tile in shared memory
// while 64-row chunks of h2 and x stream through, with an online softmax
// over T (running max, normalizer, sum e x, sum e x^2). It also writes the
// max M and the normalizer L per (b, d), so the backward needs no pass to
// find them, and S = g_mu mu + g_e2 e2 comes from the forward's outputs.
// Its product runs on the tensor cores in 3xTF32, with B4b's tiles and
// B4b's k order (below), so its logits are the ones B4b recomputes. On an
// H100 SXM at 700 W (chip_smoke.py, 64 x 750 x 1536 f32) it takes 0.48 ms,
// against 1.03 as f32 FMAs from shared memory; splitting its W2 tile once
// per block, instead of as fragments are read, gained nothing.
//
// B4b is three kernels, each summing in a fixed order (no atomics, so two
// runs agree bit for bit):
//   1. dx, dh2: one block per (128-row chunk, utterance) keeps its h2 rows
//      and walks the 64-channel tiles of W2 in order, so dh2's sum over
//      channels stays in registers;
//   2. dW2 partials: one block per (128-channel tile, utterance) keeps its
//      W2 tile and walks T in 64-row chunks, recomputing dlog, and writes
//      h2^T dlog for its utterance;
//   3. dW2 = sum over utterances of the partials, in order.
// Every product (the logits in passes 1 and 2, dh2, dW2) runs on the tensor
// cores in 3xTF32: each f32 operand a is split into big = a rounded to TF32
// (cvt.rna.tf32.f32's rounding) and small = a - big, and mma.sync m16n8k8
// accumulates small*big + big*small + big*big in f32. big + small holds a to
// about 2^-21 of |a|, so the products keep f32's accuracy (one TF32 product
// keeps about 2^-11, which breaks the gradient bars). The split happens as a
// fragment is read from shared memory, so it costs no device memory, and
// costs three integer and float operations an element (cvt.rna.tf32.f32
// itself compiles to a longer sequence that guards NaN and infinity).
// So that each split feeds many products, every warp owns a 32 x 32 logits
// tile and a 64 x 32 tile of dh2 or dW2 (16 accumulators of m16n8k8), which
// takes 165-196 registers a thread: one 256-thread block per SM, with about
// 210 KB of shared memory in f32, the next W2 tile (pass 1) or h2 chunk
// (pass 2) and the next x tile arriving by cp.async while the block works
// on this one. The shared-memory tiles are laid out (tensor_core.cuh: Xor, Pad) so
// that every fragment read, the transposed h2 read of dW2 included, and the
// epilogue's writes are free of bank conflicts. The epilogue forms
// w = exp(logit + (b2 - M)) * (1 / L) from per-channel constants, with
// __expf: expf and a division take about 13% longer at the training shape
// and leave the errors phase 2b of chip_smoke.py measures where they are.
// B4a forms M and L from the same 3xTF32 logits, with __expf as well.
//
// Bound: at B = 64, T = 750, D = 1536 in f32 the forward's product is 18.9
// GFLOP, 3 x 18.9 of TF32 in 3xTF32: 0.115 ms at 495 TFLOP/s (0.28 ms at
// the f32 rate), against 320 MB (0.096 ms). The backward's three products
// are 56.6 GFLOP, 3 x 56.6 = 170 GFLOP of TF32 in 3xTF32: 0.343 ms at 495
// TFLOP/s (0.845 ms at the f32 rate), against about 640 MB (0.191 ms).
// Passes 1 and 2 both recompute the logits, a fourth product. One pass that
// recomputed them once would save 3 x 18.9 GFLOP / 495 TFLOP/s = 0.115 ms
// at peak, but it has to keep a (B, D/128, T, 128) f32
// partial of dh2 (its sum over channel tiles cannot stay in one block),
// written and read back: 2 x 295 MB, at least 0.18 ms at 3.35 TB/s, and
// about 281 MiB more peak memory. It gains nothing at the bound, so B4b
// keeps its two passes. B4b takes 1.50 ms at the same shape (5.27 as f32
// FMAs).

#include "tensor_core.cuh"

namespace {

using namespace asv::tc;

constexpr int BT1 = 64;       // B4b pass 1: channels per W2 tile
constexpr int R1 = 128;       // B4b pass 1: T rows per block
constexpr int BT2 = 128;      // B4a and B4b pass 2: channels per block
constexpr int R2 = 64;        // B4a and B4b pass 2: T rows per chunk
constexpr int NK = 5;         // per-channel constants: b2 - M, 1 / L, g_mu, g_e2, S
static_assert(BT2 == POOL_BT && R2 == POOL_R, "B4b pass 2 recomputes B4a's tiles");

// B4a writes mu, e2 and the softmax's max and normalizer per (b, d).
struct StatsOut {
  float *mu, *e2, *mx, *nrm;   // at (b, c0)
  __device__ __forceinline__ void operator()(int c, float m, float e, float M, float L) const {
    mu[c] = m;
    e2[c] = e;
    mx[c] = M;
    nrm[c] = L;
  }
};

// B4a. Grid (D / BT2, B), one 256-thread block per SM: softmax_pool
// (tensor_core.cuh) over all T rows with the tiles of B4b's pass 2.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
softmax_stats_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h2,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2, int Tlen, int D,
                         float* __restrict__ mu, float* __restrict__ e2,
                         float* __restrict__ mx, float* __restrict__ nrm) {
  const int b = blockIdx.y, c0 = blockIdx.x * BT2;
  const size_t o = static_cast<size_t>(b) * D + c0;
  softmax_pool<T>(x + static_cast<size_t>(b) * Tlen * D + c0, b2, Tlen, D, c0,
                  Tf32Logits<T, HLay<T>>{w2, h2 + static_cast<size_t>(b) * Tlen * HID, D},
                  StatsOut{mu + o, e2 + o, mx + o, nrm + o});
}

// kc[k * BT + c] for channel c0 + c < c0 + BT: b2 - M, 1 / L, g_mu, g_e2
// and S = sum_t w q = g_mu mu + g_e2 e2.
template <int BT>
__device__ __forceinline__ void load_consts(
    const float* b2, const float* mx, const float* nrm, const float* mu,
    const float* e2, const float* gmu, const float* ge2, int b, int D, int c0,
    float* kc) {
  const int c = threadIdx.x;
  if (c >= BT) return;
  const size_t o = static_cast<size_t>(b) * D + c0 + c;
  const float gm = gmu[o], g2 = ge2[o];
  kc[c] = b2[c0 + c] - mx[o];
  kc[BT + c] = 1.f / nrm[o];
  kc[2 * BT + c] = gm;
  kc[3 * BT + c] = g2;
  kc[4 * BT + c] = fmaf(gm, mu[o], g2 * e2[o]);
}

// One channel's constants, and what it gives for a logit (without b2) and x:
// w = exp(logit + b2 - M) / L, dlog = w (g_mu x + g_e2 x^2 - S) and
// dx = w (g_mu + 2 g_e2 x).
struct Chan {
  float kb, il, gm, g2, s;
  template <int BT>
  static __device__ __forceinline__ Chan at(const float* kc, int c) {
    return {kc[c], kc[BT + c], kc[2 * BT + c], kc[3 * BT + c], kc[4 * BT + c]};
  }
  __device__ __forceinline__ float w(float logit) const { return __expf(logit + kb) * il; }
  __device__ __forceinline__ float dlog(float w, float v) const {
    return w * (fmaf(gm, v, g2 * v * v) - s);
  }
  __device__ __forceinline__ float dx(float w, float v) const {
    return w * fmaf(2.f * g2, v, gm);
  }
};

// The logits tile's epilogue: for this warp's 32 x 32 logits acc (rows r0,
// channels n0 of the tile; rows from `valid` on are padding), dlog into the
// tile ds and, if dx is given, dx to dx(r, c) = dx[r * D + c]. x comes
// from the tile xs.
template <int BT, class DLay, class XLay, typename T>
__device__ __forceinline__ void epilogue(float acc[2][4][4], const float* kc,
                                         const T* xs, int r0, int n0, int valid,
                                         int g, int t, float* ds, T* dx, int D) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int c8 = n0 + 8 * n, c = c8 + 2 * t;
    const Chan k0 = Chan::at<BT>(kc, c), k1 = Chan::at<BT>(kc, c + 1);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r8 = r0 + 16 * m + 8 * h, r = r8 + g;
        float2 dl = make_float2(0.f, 0.f);
        if (r < valid) {
          const float2 v = load2<T>(xs + XLay::idx(r8, g, c8, 2 * t));
          const float w0 = k0.w(acc[m][n][2 * h]), w1 = k1.w(acc[m][n][2 * h + 1]);
          dl = make_float2(k0.dlog(w0, v.x), k1.dlog(w1, v.y));
          if (dx) store2<T>(dx + static_cast<size_t>(r) * D + c, k0.dx(w0, v.x), k1.dx(w1, v.y));
        }
        *reinterpret_cast<float2*>(ds + DLay::idx(r8, g, c8, 2 * t)) = dl;
      }
  }
}

// B4b, pass 1: dx and dh2. Grid (ceil(T / R1), B), one 256-thread block per
// SM. The block keeps its R1 rows of h2 and walks the BT1-channel tiles of
// W2 in order, the next tile's W2 and x on their way (cp.async) while it
// works on this one: it recomputes the tile's logits (warp w: rows
// 32 (w % 4), channels 32 (w / 4)), writes dx and adds dlog @ W2_tile^T to
// its dh2 rows (warp w: rows 64 (w % 2), hidden units 32 (w / 2)), which
// stay in registers over all tiles.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
softmax_stats_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ h2,
                            const float* __restrict__ w2,
                            const float* __restrict__ b2,
                            const float* __restrict__ mx,
                            const float* __restrict__ nrm,
                            const float* __restrict__ mu,
                            const float* __restrict__ e2,
                            const float* __restrict__ gmu,
                            const float* __restrict__ ge2, int Tlen, int D,
                            T* __restrict__ dx, T* __restrict__ dh2) {
  using WL = Xor<BT1 + 8>;
  using DL = Xor<BT1 + 8>;
  using XL = Pad<BT1 + 8>;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // 2 x HID rows: W2 tiles
  float* ds = ws + 2 * HID * WL::S;              // R1 rows: dlog
  float* kc = ds + R1 * DL::S;                   // NK x BT1
  T* hs = reinterpret_cast<T*>(kc + NK * BT1);   // R1 rows of h2
  T* xs = hs + R1 * HLay<T>::S;                  // R1 rows: x tile
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int t0 = blockIdx.x * R1, b = blockIdx.y;
  const int valid = min(R1, Tlen - t0);
  const T* xb = x + (static_cast<size_t>(b) * Tlen + t0) * D;
  T* dxb = dx + (static_cast<size_t>(b) * Tlen + t0) * D;
  const T* hb = h2 + static_cast<size_t>(b) * Tlen * HID;

  copy_rows<T, R1, HID, HLay<T>>(hb, HID, Tlen, t0, hs);
  copy_rows<float, HID, BT1, WL>(w2, D, HID, 0, ws);
  copy_rows<T, R1, BT1, XL>(xb, D, valid, 0, xs);
  asv::cp_commit();
  load_consts<BT1>(b2, mx, nrm, mu, e2, gmu, ge2, b, D, 0, kc);
  float dh[4][4][4];
  zero<4, 4>(dh);

  const int tiles = D / BT1;
  for (int i = 0; i < tiles; ++i) {
    const int c0 = i * BT1;
    const float* wt = ws + (i % 2) * HID * WL::S;
    asv::cp_wait_all();
    __syncthreads();   // this tile's W2, x and constants are in
    if (i + 1 < tiles) {
      copy_rows<float, HID, BT1, WL>(w2 + c0 + BT1, D, HID, 0, ws + ((i + 1) % 2) * HID * WL::S);
      asv::cp_commit();
    }
    float acc[2][4][4];
    zero<2, 4>(acc);
    tile_mma<2, 4, HID, HLay<T>, false, WL, false>(hs, 32 * (warp % 4), wt, 32 * (warp / 4),
                                                   g, t, acc);
    epilogue<BT1, DL, XL, T>(acc, kc, xs, 32 * (warp % 4), 32 * (warp / 4), valid, g, t, ds,
                             dxb + c0, D);
    __syncthreads();   // dlog is in; x and the constants are free
    if (i + 1 < tiles) {
      copy_rows<T, R1, BT1, XL>(xb + c0 + BT1, D, valid, 0, xs);
      asv::cp_commit();
      load_consts<BT1>(b2, mx, nrm, mu, e2, gmu, ge2, b, D, c0 + BT1, kc);
    }
    // dh += dlog (rows, tile channels) @ W2_tile^T (tile channels, hidden)
    tile_mma<4, 4, BT1, DL, false, WL, true>(ds, 64 * (warp % 2), wt, 32 * (warp / 2), g, t,
                                             dh);
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * (warp % 2) + 16 * m + g + 8 * h;
        if (r < valid)
          store2<T>(dh2 + (static_cast<size_t>(b) * Tlen + t0 + r) * HID + 32 * (warp / 2) +
                        8 * n + 2 * t,
                    dh[m][n][2 * h], dh[m][n][2 * h + 1]);
      }
}

// B4b, pass 2: per-utterance dW2 partials. Grid (D / BT2, B), one
// 256-thread block per SM. The block keeps its W2 tile and walks T in
// chunks of R2 rows, in order, the next chunk's h2 and x on their way
// (cp.async) while it works on this one: it recomputes the chunk's logits
// (warp w: rows 32 (w % 2), channels 32 (w / 2)) and dlog, and adds
// h2_chunk^T @ dlog to its partial (warp w: hidden units 64 (w % 2),
// channels 32 (w / 2)), which stays in registers over all chunks.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
softmax_stats_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ h2,
                            const float* __restrict__ w2,
                            const float* __restrict__ b2,
                            const float* __restrict__ mx,
                            const float* __restrict__ nrm,
                            const float* __restrict__ mu,
                            const float* __restrict__ e2,
                            const float* __restrict__ gmu,
                            const float* __restrict__ ge2, int Tlen, int D,
                            float* __restrict__ part) {
  using WL = Xor<BT2 + 8>;
  using DL = Xor<BT2 + 8>;
  using XL = Pad<BT2 + 8>;
  constexpr int SH = HLay<T>::S;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // HID rows: W2 tile
  float* ds = ws + HID * WL::S;                  // R2 rows: dlog
  float* kc = ds + R2 * DL::S;                   // NK x BT2
  T* hs = reinterpret_cast<T*>(kc + NK * BT2);   // 2 x R2 x SH: h2 chunks
  T* xs = hs + 2 * R2 * SH;                      // R2 rows: x chunk
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int b = blockIdx.y, c0 = blockIdx.x * BT2;
  const T* xb = x + static_cast<size_t>(b) * Tlen * D + c0;
  const T* hb = h2 + static_cast<size_t>(b) * Tlen * HID;
  const int chunks = (Tlen + R2 - 1) / R2;

  copy_rows<float, HID, BT2, WL>(w2 + c0, D, HID, 0, ws);
  copy_rows<T, R2, HID, HLay<T>>(hb, HID, Tlen, 0, hs);
  copy_rows<T, R2, BT2, XL>(xb, D, Tlen, 0, xs);
  asv::cp_commit();
  load_consts<BT2>(b2, mx, nrm, mu, e2, gmu, ge2, b, D, c0, kc);
  float dw[4][4][4];
  zero<4, 4>(dw);

  for (int i = 0; i < chunks; ++i) {
    const T* hc = hs + (i % 2) * R2 * SH;
    asv::cp_wait_all();
    __syncthreads();   // this chunk's h2 and x are in
    if (i + 1 < chunks) {
      copy_rows<T, R2, HID, HLay<T>>(hb, HID, Tlen, (i + 1) * R2, hs + ((i + 1) % 2) * R2 * SH);
      asv::cp_commit();
    }
    float acc[2][4][4];
    zero<2, 4>(acc);
    tile_mma<2, 4, HID, HLay<T>, false, WL, false>(hc, 32 * (warp % 2), ws, 32 * (warp / 2),
                                                   g, t, acc);
    epilogue<BT2, DL, XL, T>(acc, kc, xs, 32 * (warp % 2), 32 * (warp / 2), Tlen - i * R2,
                             g, t, ds, static_cast<T*>(nullptr), D);
    __syncthreads();   // dlog is in; the x chunk is free
    if (i + 1 < chunks) {
      copy_rows<T, R2, BT2, XL>(xb, D, Tlen, (i + 1) * R2, xs);
      asv::cp_commit();
    }
    // dw += h2_chunk^T (hidden, rows) @ dlog (rows, channels)
    tile_mma<4, 4, R2, HLay<T>, true, DL, false>(hc, 64 * (warp % 2), ds, 32 * (warp / 2), g,
                                                 t, dw);
  }
  float* pb = part + static_cast<size_t>(b) * HID * D + c0;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2<float>(pb + static_cast<size_t>(64 * (warp % 2) + 16 * m + g + 8 * h) * D +
                          32 * (warp / 2) + 8 * n + 2 * t,
                      dw[m][n][2 * h], dw[m][n][2 * h + 1]);
}

// B4b, pass 3: dW2[j, d] = sum_b part[b, j, d], in order of b.
__global__ void __launch_bounds__(THREADS)
softmax_stats_bwd_reduce_kernel(const float* __restrict__ part, int B, int n,
                                float* __restrict__ dw2) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part[static_cast<size_t>(b) * n + i];
  dw2[i] = s;
}

template <typename T>
constexpr size_t fwd_smem() {
  return pool_smem<T, Tf32Logits<T, HLay<T>>>();
}
template <typename T>
constexpr size_t dx_smem() {
  return (2 * HID * (BT1 + 8) + R1 * (BT1 + 8) + NK * BT1) * sizeof(float) +
         R1 * (HLay<T>::S + BT1 + 8) * sizeof(T);
}
template <typename T>
constexpr size_t dw_smem() {
  return (HID * (BT2 + 8) + R2 * (BT2 + 8) + NK * BT2) * sizeof(float) +
         R2 * (2 * HLay<T>::S + BT2 + 8) * sizeof(T);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* h2, const float* w2,
                       const float* b2, int B, int Tlen, int D, float* mu,
                       float* e2, float* mx, float* nrm, cudaStream_t st) {
  cudaError_t err = asv::allow_smem(softmax_stats_fwd_kernel<T>, fwd_smem<T>());
  if (err != cudaSuccess) return err;
  softmax_stats_fwd_kernel<T><<<dim3(D / BT2, B), THREADS, fwd_smem<T>(), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(h2), w2, b2, Tlen, D,
      mu, e2, mx, nrm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* xv, const void* h2v, const float* w2,
                       const float* b2, const float* mx, const float* nrm,
                       const float* mu, const float* e2, const float* gmu,
                       const float* ge2, int B, int Tlen, int D, void* dxv,
                       void* dh2v, float* part, float* dw2, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const T* h2 = static_cast<const T*>(h2v);
  cudaError_t err = asv::allow_smem(softmax_stats_bwd_dx_kernel<T>, dx_smem<T>());
  if (err != cudaSuccess) return err;
  softmax_stats_bwd_dx_kernel<T><<<dim3((Tlen + R1 - 1) / R1, B), THREADS,
                                   dx_smem<T>(), st>>>(
      x, h2, w2, b2, mx, nrm, mu, e2, gmu, ge2, Tlen, D, static_cast<T*>(dxv),
      static_cast<T*>(dh2v));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = asv::allow_smem(softmax_stats_bwd_dw_kernel<T>, dw_smem<T>())) != cudaSuccess)
    return err;
  softmax_stats_bwd_dw_kernel<T><<<dim3(D / BT2, B), THREADS, dw_smem<T>(), st>>>(
      x, h2, w2, b2, mx, nrm, mu, e2, gmu, ge2, Tlen, D, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n = HID * D;
  softmax_stats_bwd_reduce_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      part, B, n, dw2);
  return cudaGetLastError();
}

}  // namespace

// x (B, T, D) and h2 (B, T, 128) f32 or bf16 (code 0 / 1), D a multiple of
// 128, T >= 1; w2 (128, D), b2 (D) f32. Writes mu, e2 and the softmax's
// max and normalizer, (B, D) f32 each. Returns cudaGetLastError().
extern "C" int attn_pool_vjp_forward(const void* x, const void* h2,
                                     const float* w2, const float* b2, int B,
                                     int Tlen, int D, float* mu, float* e2,
                                     float* mx, float* nrm, int dtype,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % BT2 != 0 || Tlen < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == asv::kF32)
    return static_cast<int>(launch_fwd<float>(x, h2, w2, b2, B, Tlen, D, mu, e2,
                                              mx, nrm, st));
  if (dtype == asv::kBF16)
    return static_cast<int>(launch_fwd<__nv_bfloat16>(x, h2, w2, b2, B, Tlen, D,
                                                      mu, e2, mx, nrm, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The forward's inputs and outputs (mx, nrm, mu, e2) and the cotangents
// gmu, ge2 (B, D) f32. Writes dx (B, T, D) and dh2 (B, T, 128) in x's type,
// dw2 (128, D) f32, using part (B, 128, D) f32 as scratch. Returns
// cudaGetLastError() after the last launch.
extern "C" int attn_pool_vjp_backward(const void* x, const void* h2,
                                      const float* w2, const float* b2,
                                      const float* mx, const float* nrm,
                                      const float* mu, const float* e2,
                                      const float* gmu, const float* ge2,
                                      int B, int Tlen, int D, void* dx,
                                      void* dh2, float* part, float* dw2,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % BT2 != 0 || Tlen < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == asv::kF32)
    return static_cast<int>(launch_bwd<float>(x, h2, w2, b2, mx, nrm, mu, e2,
                                              gmu, ge2, B, Tlen, D, dx, dh2,
                                              part, dw2, st));
  if (dtype == asv::kBF16)
    return static_cast<int>(launch_bwd<__nv_bfloat16>(
        x, h2, w2, b2, mx, nrm, mu, e2, gmu, ge2, B, Tlen, D, dx, dh2, part,
        dw2, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

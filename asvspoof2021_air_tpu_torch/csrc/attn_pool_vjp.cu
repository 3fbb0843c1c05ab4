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
// Design. B4a is B3's pool pass (csrc/attn_pool.cu) without the folded BN:
// per 128-channel tile and utterance, W2's tile stays in shared memory
// while 64-row chunks of h2 stream through, with an online softmax over T
// (running max, normalizer, sum w x, sum w x^2). It also writes the max and
// the normalizer per (b, d), so the backward needs no pass to find them,
// and S = g_mu mu + g_e2 e2 comes from the forward's outputs.
// B4b is three kernels, each summing in a fixed order (no atomics, so two
// runs agree bit for bit):
//   1. dx, dh2: one block per (64-row chunk, utterance) walks all channel
//      tiles in order, so dh2's sum over channels stays in its registers;
//   2. dW2 partials: one block per (channel tile, utterance) walks all T
//      chunks, recomputing dlog, and writes h2^T dlog for its utterance;
//   3. dW2 = sum over utterances of the partials, in order.
// Kernels 1 and 2 both recompute the logits: four products where the
// function needs three.
//
// Bound: at B = 64, T = 750, D = 1536 in f32 the forward's product is 18.9
// GFLOP (0.28 ms at the f32 rate) against 320 MB (0.096 ms); the backward's
// three products are 56.6 GFLOP (0.85 ms) against about 640 MB. Both are
// bound by operations. This first version does its products as f32 FMAs
// from shared memory (TF32 would break the gradient bars).

#include "common.cuh"

namespace {

constexpr int HID = 128;      // attention hidden width
constexpr int TILE = 128;     // channels per tile
constexpr int ROWS = 64;      // T rows per chunk
constexpr int THREADS = 256;  // 8 warps: warp rg owns rows rg*8 .. rg*8+7
constexpr int WPAD = TILE + 1;  // padded W2 row: conflict-free column reads

// hs[r][j] = h2[b, t0 + r, j] in f32, zero past Tlen.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ hb, int Tlen,
                                          int t0, float* hs) {
  for (int idx = threadIdx.x; idx < ROWS * HID; idx += THREADS) {
    const int t = t0 + idx / HID;
    hs[idx] = t < Tlen ? asv::to_f32<T>(hb[static_cast<size_t>(t) * HID + idx % HID]) : 0.f;
  }
}

// ws[j * stride + c] = W2[j, c0 + c].
__device__ __forceinline__ void load_tile(const float* __restrict__ w2, int D,
                                          int c0, int stride, float* ws) {
  for (int idx = threadIdx.x; idx < HID * TILE; idx += THREADS) {
    const int j = idx / TILE, c = idx % TILE;
    ws[j * stride + c] = w2[static_cast<size_t>(j) * D + c0 + c];
  }
}

// acc[i][q] = sum_j hs[rg*8 + i][j] * ws[j][lane + 32 q]: the logits of this
// thread's 8 rows and 4 channels, summed over j in order.
__device__ __forceinline__ void logits8x4(const float* hs, const float* ws,
                                          int stride, int rg, int lane,
                                          float acc[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
#pragma unroll 4
  for (int j = 0; j < HID; ++j) {
    float a[8], w[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = hs[(rg * 8 + i) * HID + j];
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = ws[j * stride + lane + 32 * q];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], w[q], acc[i][q]);
  }
}

// B4a. Grid (D / TILE, B). Writes mu, e2 and the softmax's max and
// normalizer per (b, d).
template <typename T>
__global__ void __launch_bounds__(THREADS)
softmax_stats_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h2,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2, int Tlen, int D,
                         float* __restrict__ mu, float* __restrict__ e2,
                         float* __restrict__ mx, float* __restrict__ nrm) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // HID x TILE
  float* hs = ws + HID * TILE;                   // ROWS x HID
  const int lane = threadIdx.x % 32, rg = threadIdx.x / 32;
  const int b = blockIdx.y, c0 = blockIdx.x * TILE;
  const T* xb = x + static_cast<size_t>(b) * Tlen * D;
  const T* hb = h2 + static_cast<size_t>(b) * Tlen * HID;

  load_tile(w2, D, c0, TILE, ws);
  float bias[4], m[4], l[4], s1[4], s2[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bias[q] = b2[c0 + lane + 32 * q];
    m[q] = -INFINITY;
    l[q] = s1[q] = s2[q] = 0.f;
  }
  for (int t0 = 0; t0 < Tlen; t0 += ROWS) {
    __syncthreads();
    load_rows<T>(hb, Tlen, t0, hs);
    __syncthreads();
    float acc[8][4];
    logits8x4(hs, ws, TILE, rg, lane, acc);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + lane + 32 * q;
      float cmax = m[q];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][q] += bias[q];
        if (t0 + rg * 8 + i < Tlen) cmax = fmaxf(cmax, acc[i][q]);
      }
      if (cmax == -INFINITY) continue;   // no valid row in this group yet
      const float rescale = expf(m[q] - cmax);
      l[q] *= rescale;
      s1[q] *= rescale;
      s2[q] *= rescale;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = t0 + rg * 8 + i;
        if (t < Tlen) {
          const float e = expf(acc[i][q] - cmax);
          const float v = asv::to_f32<T>(xb[static_cast<size_t>(t) * D + c]);
          l[q] += e;
          s1[q] = fmaf(e, v, s1[q]);
          s2[q] = fmaf(e * v, v, s2[q]);
        }
      }
      m[q] = cmax;
    }
  }
  __syncthreads();

  // Merge the 8 row groups per channel (reusing hs: 4 x 8 x TILE floats).
  float* pm = hs;
  float* pl = pm + 8 * TILE;
  float* p1 = pl + 8 * TILE;
  float* p2 = p1 + 8 * TILE;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = rg * TILE + lane + 32 * q;
    pm[k] = m[q];
    pl[k] = l[q];
    p1[k] = s1[q];
    p2[k] = s2[q];
  }
  __syncthreads();
  if (threadIdx.x < TILE) {
    const int k = threadIdx.x;
    float M = -INFINITY;
    for (int g = 0; g < 8; ++g) M = fmaxf(M, pm[g * TILE + k]);
    float L = 0.f, S1 = 0.f, S2 = 0.f;
    for (int g = 0; g < 8; ++g) {
      const float mg = pm[g * TILE + k];
      if (mg == -INFINITY) continue;
      const float f = expf(mg - M);
      L = fmaf(pl[g * TILE + k], f, L);
      S1 = fmaf(p1[g * TILE + k], f, S1);
      S2 = fmaf(p2[g * TILE + k], f, S2);
    }
    const size_t o = static_cast<size_t>(b) * D + c0 + k;
    mu[o] = S1 / L;
    e2[o] = S2 / L;
    mx[o] = M;
    nrm[o] = L;
  }
}

// Per-channel constants of the backward for this thread's 4 channels.
struct ChannelConsts {
  float bias[4], M[4], L[4], gm[4], g2[4], S[4];
};

__device__ __forceinline__ void load_consts(
    const float* b2, const float* mx, const float* nrm, const float* mu,
    const float* e2, const float* gmu, const float* ge2, int b, int D, int c0,
    int lane, ChannelConsts& k) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c0 + lane + 32 * q;
    const size_t o = static_cast<size_t>(b) * D + c;
    k.bias[q] = b2[c];
    k.M[q] = mx[o];
    k.L[q] = nrm[o];
    k.gm[q] = gmu[o];
    k.g2[q] = ge2[o];
    // S = sum_t w q = g_mu sum w x + g_e2 sum w x^2 = g_mu mu + g_e2 e2.
    k.S[q] = fmaf(k.gm[q], mu[o], k.g2[q] * e2[o]);
  }
}

// ds[r][c] = dlog for this thread's 8 rows and 4 channels (0 past Tlen);
// with DX, also writes dx. The logits in acc come from logits8x4 and get
// the same bias as in B4a, so w = exp(logit - M) / L matches the forward.
template <typename T, bool DX>
__device__ __forceinline__ void dlog8x4(const float acc[8][4],
                                        const ChannelConsts& k,
                                        const T* __restrict__ xb,
                                        T* __restrict__ dxb, int Tlen, int D,
                                        int t0, int c0, int rg, int lane,
                                        float* ds) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c0 + lane + 32 * q;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rg * 8 + i;
      const int t = t0 + r;
      float dl = 0.f;
      if (t < Tlen) {
        const float w = expf(acc[i][q] + k.bias[q] - k.M[q]) / k.L[q];
        const size_t o = static_cast<size_t>(t) * D + c;
        const float v = asv::to_f32<T>(xb[o]);
        const float qv = fmaf(k.gm[q], v, k.g2[q] * v * v);
        dl = w * (qv - k.S[q]);
        if (DX) dxb[o] = asv::from_f32<T>(w * fmaf(2.f * k.g2[q], v, k.gm[q]));
      }
      ds[r * TILE + lane + 32 * q] = dl;
    }
  }
}

// B4b, pass 1: dx and dh2. Grid (ceil(T / ROWS), B). The block walks the
// channel tiles in order; per tile it recomputes the logits, writes dx and
// adds dlog @ W2_tile^T to its dh2 rows.
template <typename T>
__global__ void __launch_bounds__(THREADS)
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
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // HID x WPAD
  float* hs = ws + HID * WPAD;                   // ROWS x HID
  float* ds = hs + ROWS * HID;                   // ROWS x TILE
  const int lane = threadIdx.x % 32, rg = threadIdx.x / 32;
  const int t0 = blockIdx.x * ROWS, b = blockIdx.y;
  const T* xb = x + static_cast<size_t>(b) * Tlen * D;
  T* dxb = dx + static_cast<size_t>(b) * Tlen * D;
  const T* hb = h2 + static_cast<size_t>(b) * Tlen * HID;

  load_rows<T>(hb, Tlen, t0, hs);
  float dh[8][4];   // rows rg*8 + i, hidden units lane + 32 q
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) dh[i][q] = 0.f;

  for (int c0 = 0; c0 < D; c0 += TILE) {
    __syncthreads();   // the last tile's reads of ws and ds are done
    load_tile(w2, D, c0, WPAD, ws);
    ChannelConsts k;
    load_consts(b2, mx, nrm, mu, e2, gmu, ge2, b, D, c0, lane, k);
    __syncthreads();
    float acc[8][4];
    logits8x4(hs, ws, WPAD, rg, lane, acc);
    dlog8x4<T, true>(acc, k, xb, dxb, Tlen, D, t0, c0, rg, lane, ds);
    __syncthreads();
    // dh[i][q] += sum_c dlog[rg*8 + i][c] * W2[lane + 32 q][c0 + c]
#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float a[8], w[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = ds[(rg * 8 + i) * TILE + c];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = ws[(lane + 32 * q) * WPAD + c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) dh[i][q] = fmaf(a[i], w[q], dh[i][q]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + rg * 8 + i;
    if (t < Tlen)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dh2[(static_cast<size_t>(b) * Tlen + t) * HID + lane + 32 * q] =
            asv::from_f32<T>(dh[i][q]);
  }
}

// B4b, pass 2: per-utterance dW2 partials. Grid (D / TILE, B). The block
// walks the T chunks in order, recomputes dlog, and adds h2_chunk^T dlog to
// its 128 x 128 slice, held as 16 hidden units (rg*16 + jj) x 4 channels
// (lane + 32 q) a thread.
template <typename T>
__global__ void __launch_bounds__(THREADS)
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
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // HID x TILE
  float* hs = ws + HID * TILE;                   // ROWS x HID
  float* ds = hs + ROWS * HID;                   // ROWS x TILE
  const int lane = threadIdx.x % 32, rg = threadIdx.x / 32;
  const int b = blockIdx.y, c0 = blockIdx.x * TILE;
  const T* xb = x + static_cast<size_t>(b) * Tlen * D;
  const T* hb = h2 + static_cast<size_t>(b) * Tlen * HID;

  load_tile(w2, D, c0, TILE, ws);
  ChannelConsts k;
  load_consts(b2, mx, nrm, mu, e2, gmu, ge2, b, D, c0, lane, k);
  float dw[16][4];
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int q = 0; q < 4; ++q) dw[jj][q] = 0.f;

  for (int t0 = 0; t0 < Tlen; t0 += ROWS) {
    __syncthreads();   // the last chunk's reads of hs and ds are done
    load_rows<T>(hb, Tlen, t0, hs);
    __syncthreads();
    float acc[8][4];
    logits8x4(hs, ws, TILE, rg, lane, acc);
    dlog8x4<T, false>(acc, k, xb, nullptr, Tlen, D, t0, c0, rg, lane, ds);
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < ROWS; ++r) {
      float a[16], g[4];
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) a[jj] = hs[r * HID + rg * 16 + jj];
#pragma unroll
      for (int q = 0; q < 4; ++q) g[q] = ds[r * TILE + lane + 32 * q];
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int q = 0; q < 4; ++q) dw[jj][q] = fmaf(a[jj], g[q], dw[jj][q]);
    }
  }
  float* pb = part + static_cast<size_t>(b) * HID * D;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      pb[static_cast<size_t>(rg * 16 + jj) * D + c0 + lane + 32 * q] = dw[jj][q];
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

constexpr size_t FWD_SMEM = (HID * TILE + ROWS * HID) * sizeof(float);
constexpr size_t DX_SMEM = (HID * WPAD + ROWS * HID + ROWS * TILE) * sizeof(float);
constexpr size_t DW_SMEM = (HID * TILE + ROWS * HID + ROWS * TILE) * sizeof(float);

template <typename T>
cudaError_t launch_fwd(const void* x, const void* h2, const float* w2,
                       const float* b2, int B, int Tlen, int D, float* mu,
                       float* e2, float* mx, float* nrm, cudaStream_t st) {
  cudaError_t err = asv::allow_smem(softmax_stats_fwd_kernel<T>, FWD_SMEM);
  if (err != cudaSuccess) return err;
  softmax_stats_fwd_kernel<T><<<dim3(D / TILE, B), THREADS, FWD_SMEM, st>>>(
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
  cudaError_t err = asv::allow_smem(softmax_stats_bwd_dx_kernel<T>, DX_SMEM);
  if (err != cudaSuccess) return err;
  softmax_stats_bwd_dx_kernel<T><<<dim3((Tlen + ROWS - 1) / ROWS, B), THREADS,
                                   DX_SMEM, st>>>(
      x, h2, w2, b2, mx, nrm, mu, e2, gmu, ge2, Tlen, D, static_cast<T*>(dxv),
      static_cast<T*>(dh2v));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = asv::allow_smem(softmax_stats_bwd_dw_kernel<T>, DW_SMEM)) != cudaSuccess)
    return err;
  softmax_stats_bwd_dw_kernel<T><<<dim3(D / TILE, B), THREADS, DW_SMEM, st>>>(
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
  if (D % TILE != 0 || Tlen < 1) return static_cast<int>(cudaErrorInvalidValue);
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
  if (D % TILE != 0 || Tlen < 1) return static_cast<int>(cudaErrorInvalidValue);
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

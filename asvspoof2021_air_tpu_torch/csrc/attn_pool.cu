// B3: ECAPA's inference context attentive-statistics pooling.
//
// Replaces the JAX package's Pallas kernel _kernel
// (ops/attn_pool_pallas.py:31). Per utterance, over valid rows t < n:
//   mean, std over T (var = (E[x^2] - mean^2) * n / (n - 1), clip 1e-4);
//   const = mean @ Wm + std @ Ws;
//   h = relu(x @ Wx + const + ba) * s + bias          (T x 128)
//   logits = h @ Wb + bb                               (T x D)
//   w = softmax over T per channel;  mu = sum w x;
//   sigma = sqrt(clip(sum w x^2 - mu^2, 1e-4))  ->  (2 D) f32.
//
// The TPU kernel keeps one utterance's (T, 1536) activation in VMEM
// (2.3 MB in bf16); a Hopper block has 227 KB of shared memory, so this
// port makes four passes instead:
//   1. stats:  masked sum x and sum x^2 per channel -> mean, std;
//   2. const:  mean @ Wm + std @ Ws per utterance;
//   3. hidden: h = BN(relu(x @ Wx + const + ba)), a (B, T, 128) f32 scratch;
//   4. pool:   per 128-channel tile, logits = h @ Wb + bb computed a
//              64-row chunk at a time with an online softmax over T
//              (running max, sum, sum w x, sum w x^2), as flash attention
//              does, so the (B, T, D) logits never reach device memory.
//
// Bound: near the knee. x is read once (147 MB in bf16 at B=64, T=750,
// D=1536; 0.044 ms at 3.35 TB/s) against 37.7 GFLOP for the two products
// (0.038 ms at the bf16 tensor-core rate). This first version reads x three
// times and does the products as f32 FMAs from shared memory, so it is
// bound by the FMA rate.

#include "common.cuh"

namespace {

constexpr int HID = 128;        // attention hidden width
constexpr int THREADS = 256;

// 1. Masked per-channel mean and std. Grid (D / 64, B).
template <typename T>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const T* __restrict__ x, int Tlen, int D, int n,
             float* __restrict__ mean, float* __restrict__ stdv) {
  __shared__ float r1[4][64], r2[4][64];
  const int c = blockIdx.x * 64 + threadIdx.x % 64;
  const int g = threadIdx.x / 64;
  const int b = blockIdx.y;
  const T* xb = x + static_cast<size_t>(b) * Tlen * D + c;
  float s1 = 0.f, s2 = 0.f;
  for (int t = g; t < n; t += 4) {
    const float v = asv::to_f32<T>(xb[static_cast<size_t>(t) * D]);
    s1 += v;
    s2 = fmaf(v, v, s2);
  }
  r1[g][threadIdx.x % 64] = s1;
  r2[g][threadIdx.x % 64] = s2;
  __syncthreads();
  if (g == 0) {
    const int k = threadIdx.x;
    const float t1 = (r1[0][k] + r1[1][k]) + (r1[2][k] + r1[3][k]);
    const float t2 = (r2[0][k] + r2[1][k]) + (r2[2][k] + r2[3][k]);
    const float nf = static_cast<float>(n);
    const float m = t1 / nf;
    const float ex2 = t2 / nf;
    const float var = (ex2 - m * m) * (nf / (nf - 1.f));
    mean[b * D + c] = m;
    stdv[b * D + c] = sqrtf(fmaxf(var, 1e-4f));
  }
}

// 2. const = mean @ Wm + std @ Ws. Grid (B), CG x HID threads: group g
//    sums channels [g D / CG, (g + 1) D / CG), then the groups are added in
//    a fixed order.
constexpr int CG = 8;

__global__ void __launch_bounds__(CG * HID)
const_kernel(const float* __restrict__ mean, const float* __restrict__ stdv,
             const float* __restrict__ wm, const float* __restrict__ wsd,
             int D, float* __restrict__ cst) {
  __shared__ float part[CG][HID];
  const int b = blockIdx.x, j = threadIdx.x % HID, g = threadIdx.x / HID;
  const int per = D / CG;
  float dm = 0.f, ds = 0.f;
  for (int c = g * per; c < (g + 1) * per; ++c) {
    dm = fmaf(mean[b * D + c], wm[c * HID + j], dm);
    ds = fmaf(stdv[b * D + c], wsd[c * HID + j], ds);
  }
  part[g][j] = dm + ds;
  __syncthreads();
  if (g == 0) {
    float s = 0.f;
    for (int k = 0; k < CG; ++k) s += part[k][j];
    cst[b * HID + j] = s;
  }
}

// 3. h = relu(x @ Wx + const + ba) * s + bias. Grid (ceil(T / 64), B); a
//    64 x 128 output tile per block, K in chunks of 32, 8 rows x 4 columns
//    a thread.
constexpr int HR = 64, HK = 32;

template <typename T>
__global__ void __launch_bounds__(THREADS)
hidden_kernel(const T* __restrict__ x, int Tlen, int D,
              const float* __restrict__ wx, const float* __restrict__ cst,
              const float* __restrict__ ba, const float* __restrict__ sc,
              const float* __restrict__ bi, float* __restrict__ h) {
  __shared__ float xs[HK][HR + 1];
  __shared__ float wsm[HK][HID];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * HR;
  const int tx = tid % 32;   // columns tx + 32 q
  const int ty = tid / 32;   // rows ty * 8 + i
  const T* xb = x + static_cast<size_t>(b) * Tlen * D;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  for (int k0 = 0; k0 < D; k0 += HK) {
    for (int idx = tid; idx < HR * HK; idx += THREADS) {
      const int r = idx / HK, k = idx % HK;
      const int t = t0 + r;
      xs[k][r] = t < Tlen ? asv::to_f32<T>(xb[static_cast<size_t>(t) * D + k0 + k]) : 0.f;
    }
    for (int idx = tid; idx < HK * HID; idx += THREADS)
      wsm[idx / HID][idx % HID] = wx[static_cast<size_t>(k0 + idx / HID) * HID + idx % HID];
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < HK; ++k) {
      float a[8], w[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = xs[k][ty * 8 + i];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = wsm[k][tx + 32 * q];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], w[q], acc[i][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = tx + 32 * q;
    const float cj = cst[b * HID + j], bj = ba[j], sj = sc[j], oj = bi[j];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = t0 + ty * 8 + i;
      if (t < Tlen)
        h[(static_cast<size_t>(b) * Tlen + t) * HID + j] =
            fmaxf((acc[i][q] + cj) + bj, 0.f) * sj + oj;
    }
  }
}

// 4. logits = h @ Wb + bb with an online softmax over T, accumulating
//    sum w x and sum w x^2. Grid (D / 128, B); Wb's 128 x 128 tile stays in
//    shared memory while 64-row chunks of h stream through. Each thread
//    owns 4 channels (lane + 32 q) of 8 rows of a chunk, keeps a running
//    (max, sum, sum e x, sum e x^2) per channel, and the 8 row groups are
//    merged at the end.
constexpr int PC = 128, PR = 64;

template <typename T>
__global__ void __launch_bounds__(THREADS)
pool_kernel(const T* __restrict__ x, int Tlen, int D, int n,
            const float* __restrict__ h, const float* __restrict__ wb,
            const float* __restrict__ bb, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* wbs = smem;                 // HID x PC
  float* hs = wbs + HID * PC;        // PR x HID
  const int tid = threadIdx.x;
  const int lane = tid % 32, rg = tid / 32;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * PC;
  const T* xb = x + static_cast<size_t>(b) * Tlen * D;
  const float* hb = h + static_cast<size_t>(b) * Tlen * HID;

  for (int idx = tid; idx < HID * PC; idx += THREADS) {
    const int j = idx / PC, c = idx % PC;
    wbs[idx] = wb[static_cast<size_t>(j) * D + c0 + c];
  }
  float bias[4], m[4], l[4], s1[4], s2[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bias[q] = bb[c0 + lane + 32 * q];
    m[q] = -INFINITY;
    l[q] = s1[q] = s2[q] = 0.f;
  }

  for (int t0 = 0; t0 < n; t0 += PR) {
    __syncthreads();
    for (int idx = tid; idx < PR * HID / 4; idx += THREADS) {
      const int r = idx / (HID / 4), j4 = idx % (HID / 4);
      const int t = t0 + r;
      reinterpret_cast<float4*>(hs)[idx] =
          t < n ? reinterpret_cast<const float4*>(hb + static_cast<size_t>(t) * HID)[j4]
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    float acc[8][4];
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
      for (int q = 0; q < 4; ++q) w[q] = wbs[j * PC + lane + 32 * q];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], w[q], acc[i][q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + lane + 32 * q;
      float cmax = m[q];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][q] += bias[q];
        if (t0 + rg * 8 + i < n) cmax = fmaxf(cmax, acc[i][q]);
      }
      if (cmax == -INFINITY) continue;   // no valid row in this group yet
      const float rescale = expf(m[q] - cmax);
      l[q] *= rescale;
      s1[q] *= rescale;
      s2[q] *= rescale;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = t0 + rg * 8 + i;
        if (t < n) {
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

  // Merge the 8 row groups per channel (reusing hs: 4 x 8 x PC floats).
  float* pm = hs;
  float* pl = pm + 8 * PC;
  float* p1 = pl + 8 * PC;
  float* p2 = p1 + 8 * PC;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = rg * PC + lane + 32 * q;
    pm[k] = m[q];
    pl[k] = l[q];
    p1[k] = s1[q];
    p2[k] = s2[q];
  }
  __syncthreads();
  if (tid < PC) {
    float M = -INFINITY;
    for (int g = 0; g < 8; ++g) M = fmaxf(M, pm[g * PC + tid]);
    float L = 0.f, S1 = 0.f, S2 = 0.f;
    for (int g = 0; g < 8; ++g) {
      const float mg = pm[g * PC + tid];
      if (mg == -INFINITY) continue;
      const float f = expf(mg - M);
      L = fmaf(pl[g * PC + tid], f, L);
      S1 = fmaf(p1[g * PC + tid], f, S1);
      S2 = fmaf(p2[g * PC + tid], f, S2);
    }
    const float mu = S1 / L;
    const float e2 = S2 / L;
    out[static_cast<size_t>(b) * 2 * D + c0 + tid] = mu;
    out[static_cast<size_t>(b) * 2 * D + D + c0 + tid] = sqrtf(fmaxf(e2 - mu * mu, 1e-4f));
  }
}

template <typename T>
cudaError_t launch(const void* xv, int B, int Tlen, int D, int n,
                   const float* wx, const float* wm, const float* wsd,
                   const float* ba, const float* sc, const float* bi,
                   const float* wb, const float* bb, float* mean, float* stdv,
                   float* cst, float* h, float* out, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  stats_kernel<T><<<dim3(D / 64, B), THREADS, 0, st>>>(x, Tlen, D, n, mean, stdv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const_kernel<<<B, CG * HID, 0, st>>>(mean, stdv, wm, wsd, D, cst);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  hidden_kernel<T><<<dim3((Tlen + HR - 1) / HR, B), THREADS, 0, st>>>(
      x, Tlen, D, wx, cst, ba, sc, bi, h);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem = (HID * PC + PR * HID) * sizeof(float);
  if ((err = asv::allow_smem(pool_kernel<T>, smem)) != cudaSuccess) return err;
  pool_kernel<T><<<dim3(D / PC, B), THREADS, smem, st>>>(x, Tlen, D, n, h, wb, bb, out);
  return cudaGetLastError();
}

}  // namespace

// x (B, T, D) f32 or bf16 (code 0 / 1), D a multiple of 128; n valid rows
// (2 <= n <= T); wx, wm, wsd (D, 128), wb (128, D), ba, sc, bi (128), bb (D)
// f32; scratch mean, stdv (B, D), cst (B, 128), h (B, T, 128) f32;
// out (B, 2 D) f32. Returns cudaGetLastError() after the last launch.
extern "C" int attn_pool_forward(const void* x, int B, int Tlen, int D, int n,
                                 const float* wx, const float* wm,
                                 const float* wsd, const float* ba,
                                 const float* sc, const float* bi,
                                 const float* wb, const float* bb, float* mean,
                                 float* stdv, float* cst, float* h, float* out,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % PC != 0 || n < 2 || n > Tlen) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == asv::kF32)
    return static_cast<int>(launch<float>(x, B, Tlen, D, n, wx, wm, wsd, ba, sc,
                                          bi, wb, bb, mean, stdv, cst, h, out, st));
  if (dtype == asv::kBF16)
    return static_cast<int>(launch<__nv_bfloat16>(x, B, Tlen, D, n, wx, wm, wsd,
                                                  ba, sc, bi, wb, bb, mean, stdv,
                                                  cst, h, out, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

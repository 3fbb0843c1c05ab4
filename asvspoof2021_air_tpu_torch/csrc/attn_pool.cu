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
// port makes three passes in one call, each summing in a fixed order (no
// atomics: two launches agree bit for bit), and reads x twice:
//   A. proj_stats: grid (ceil(n / RA), B). Each block computes its tile
//      P = x_tile @ Wx (RA x 128, f32) on the tensor cores, streaming
//      K = D in chunks by double-buffered cp.async, and while each x chunk
//      sits in shared memory adds its column sums of x and x^2 (rows < n;
//      rows past n arrive as zeros) into per-(utterance, tile) partials.
//      bf16 x (the serving path) is exact in bf16, so only Wx is split, once
//      when the weights are packed, into NPL bf16 planes hi = bf16(W),
//      mid = bf16(W - hi): mma.sync m16n8k16 with ldmatrix accumulates
//      x mid + x hi in f32, and hi + mid holds W to 2^-17 |W| (one plane
//      keeps 2^-8: about 0.3 of the 1e-4 bar on [mu || sigma], without a
//      10x margin; tests/test_torch_attn_pool_schedule.py). f32 x runs 3xTF32 on
//      m16n8k8 (tensor_core.cuh), both operands split as they are read.
//   B. context_bias: the partials summed in tile order to mean and std, and
//      c = mean @ Wm + std @ Ws + ba, (B, 128), as f32 FMAs (50 MFLOP).
//   C. attentive_pool: B4a's pool (tensor_core.cuh softmax_pool): per
//      128-channel tile, Wb's tile in shared memory while 64-row chunks of
//      P and x arrive by double-buffered cp.async; each P chunk becomes
//      h = relu(P + c) * s + bias as it lands, the logits h @ Wb run in
//      3xbf16 (HiddenBf16x3 below), and an online softmax over the rows
//      < n per warp tile gives sum w x and sum w x^2, so the (B, T, D)
//      logits never reach device memory.
//
// Bound: bytes. The function reads x once (147 MB in bf16 at B = 64,
// T = 750, D = 1536: 0.044 ms at 3.35 TB/s) against 37.7 GFLOP for the two
// products (0.038 ms at the bf16 tensor-core rate). This design reads x
// twice and writes and reads P (348 MB in all, at least 0.104 ms): reading
// x once would need an utterance's 2.3 MB resident across a 16-block
// cluster's distributed shared memory. On an H100 SXM at 700 W
// (chip_smoke.py, bf16) it takes 0.56 ms, against 1.96 for the first
// design (four passes, x read three times, f32 FMAs): pass C 0.37, pass A
// 0.17, pass B 0.03. Pass C's logits in B4a's 3xTF32 took 0.14 ms more,
// and 64-row tiles in pass A 0.02 ms more (they read Wx's planes from L2
// twice as often).

#include "tensor_core.cuh"

namespace {

using namespace asv::tc;
using bf16 = __nv_bfloat16;

constexpr int RA = 128;        // pass A: rows per block
constexpr int KA = 64;         // pass A, bf16: columns of x per chunk (128 bytes)
constexpr int KF = 32;         // pass A, f32: columns of x per chunk (128 bytes)
constexpr int NPL = 2;         // pass A, bf16: planes of Wx
constexpr int MA = RA / 32;    // pass A: 16-row m tiles per warp (warp tile RA / 2 x 32)
constexpr int R2 = POOL_R;     // pass C: rows per chunk
constexpr int BT2 = POOL_BT;   // pass C: channels per block

// Element (r, c) of a tile of bf16 rows W elements wide: 16-byte chunk c / 8
// of row r sits at chunk (c / 8) ^ (r % 8) within its group of 8 chunks, so
// the 8 rows of an ldmatrix, and the column sums' 8 rows x 16 bytes, hit
// distinct banks.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  return r * W + ((((c >> 3) ^ r) & 7) | ((c >> 3) & ~7)) * 8 + (c & 7);
}

// Sum of v over the 8 lanes of a warp that share lane % 4, in a fixed order.
__device__ __forceinline__ float sum8(float v) {
  v += __shfl_xor_sync(0xFFFFFFFFu, v, 4);
  v += __shfl_xor_sync(0xFFFFFFFFu, v, 8);
  return v + __shfl_xor_sync(0xFFFFFFFFu, v, 16);
}

// Pass A's epilogue: rows < nv of this warp's P tile (rows m0, columns n0).
__device__ __forceinline__ void store_p(float acc[MA][4][4], float* pb, int m0, int n0,
                                        int nv, int g, int t) {
#pragma unroll
  for (int m = 0; m < MA; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + 16 * m + g + 8 * h;
      if (r >= nv) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        store2<float>(pb + static_cast<size_t>(r) * HID + n0 + 8 * nt + 2 * t,
                      acc[m][nt][2 * h], acc[m][nt][2 * h + 1]);
    }
}

// A. bf16 x. Grid (ceil(n / RA), B), two 256-thread blocks per SM. Warp w
// computes P at rows (RA / 2) (w % 2), columns 32 (w / 2); for the column
// sums lane (g, t) of warp w owns the chunk's columns 2 (4 w + t) + q, q < 2,
// at rows g + 8 i. x chunk and Wx planes double-buffered: 96 KB. (One
// block per SM, without the spill of 36 bytes that 128 registers leave,
// and with two to four chunks in flight, measured 0.02-0.03 ms slower.)
__global__ void __launch_bounds__(THREADS, 2)
proj_stats_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ planes, int Tlen,
                       int D, int n, float* __restrict__ p, float* __restrict__ s1p,
                       float* __restrict__ s2p) {
  constexpr int XS = RA * KA, WS = KA * HID;   // one x chunk, one plane's chunk
  extern __shared__ float4 smem4[];
  bf16* xs = reinterpret_cast<bf16*>(smem4);   // 2 x XS
  bf16* ws = xs + 2 * XS;                      // 2 x NPL x WS
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lchunk = 8 * (lane >> 4);
  const int m0 = (RA / 2) * (warp % 2), n0 = 32 * (warp / 2);
  const int tile = blockIdx.x, b = blockIdx.y, t0 = tile * RA;
  const int nv = min(RA, n - t0);              // rows of this tile before n
  const bf16* xb = x + (static_cast<size_t>(b) * Tlen + t0) * D;
  const int chunks = D / KA;

  auto load = [&](int kc, int buf) {
    for (int i = threadIdx.x; i < RA * KA / 8; i += THREADS) {
      const int r = i / (KA / 8), c = (i % (KA / 8)) * 8;
      const bool ok = r < nv;
      asv::cp16(xs + buf * XS + swz<KA>(r, c),
                xb + (ok ? static_cast<size_t>(r) * D + kc * KA + c : 0), ok);
    }
#pragma unroll
    for (int q = 0; q < NPL; ++q)
      for (int i = threadIdx.x; i < KA * HID / 8; i += THREADS) {
        const int r = i / (HID / 8), c = (i % (HID / 8)) * 8;
        asv::cp16(ws + (buf * NPL + q) * WS + swz<HID>(r, c),
                  planes + (static_cast<size_t>(q) * D + kc * KA + r) * HID + c, true);
      }
  };

  load(0, 0);
  asv::cp_commit();
  float acc[MA][4][4];
  zero<MA, 4>(acc);
  const int cp = 2 * (4 * warp + t);   // this lane's column pair in a chunk
  float* s1b = s1p + (static_cast<size_t>(b) * gridDim.x + tile) * D;
  float* s2b = s2p + (static_cast<size_t>(b) * gridDim.x + tile) * D;

  for (int kc = 0; kc < chunks; ++kc) {
    const int cur = kc % 2;
    asv::cp_wait_all();
    __syncthreads();   // this chunk is in; the other buffers are free
    if (kc + 1 < chunks) {
      load(kc + 1, 1 - cur);
      asv::cp_commit();
    }
    const bf16* xc = xs + cur * XS;
    const bf16* wc = ws + cur * NPL * WS;
#pragma unroll
    for (int k0 = 0; k0 < KA; k0 += 16) {
      uint32_t a[MA][4];
#pragma unroll
      for (int m = 0; m < MA; ++m)
        ldsm4<false>(a[m], xc + swz<KA>(m0 + 16 * m + lrow, k0 + lchunk));
#pragma unroll
      for (int q = NPL - 1; q >= 0; --q) {   // the small plane first
        uint32_t bq[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ldsm4<true>(bq[h], wc + q * WS + swz<HID>(k0 + lrow, n0 + 16 * h + lchunk));
#pragma unroll
        for (int m = 0; m < MA; ++m)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[m][nt], a[m], bq[nt / 2][2 * (nt % 2)], bq[nt / 2][2 * (nt % 2) + 1]);
      }
    }
    // Column sums of this chunk (rows past n are zeros).
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll 4
    for (int i = 0; i < RA / 8; ++i) {
      const float2 v = load2<bf16>(xc + swz<KA>(g + 8 * i, cp));
      s1[0] += v.x;
      s1[1] += v.y;
      s2[0] = fmaf(v.x, v.x, s2[0]);
      s2[1] = fmaf(v.y, v.y, s2[1]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      s1[q] = sum8(s1[q]);
      s2[q] = sum8(s2[q]);
    }
    if (g == 0) {
      store2<float>(s1b + kc * KA + cp, s1[0], s1[1]);
      store2<float>(s2b + kc * KA + cp, s2[0], s2[1]);
    }
  }
  store_p(acc, p + (static_cast<size_t>(b) * Tlen + t0) * HID, m0, n0, nv, g, t);
}

// A. f32 x: the same tiles in 3xTF32, x and Wx split as they are read (B4b's
// tile_mma, whose 64 x 32 warp tile takes more registers than two blocks
// per SM leave: one block per SM). The column sums: lane (g, t) of warp w
// owns the chunk's column 4 w + t at rows g + 8 i. x chunk and Wx chunk
// double-buffered: 74 KB.
__global__ void __launch_bounds__(THREADS, 1)
proj_stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ wx, int Tlen,
                      int D, int n, float* __restrict__ p, float* __restrict__ s1p,
                      float* __restrict__ s2p) {
  using XL = Xor<KF + 8>;
  using WL = Xor<HID + 8>;
  constexpr int XS = RA * XL::S, WS = KF * WL::S;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // 2 x XS
  float* ws = xs + 2 * XS;                       // 2 x WS
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int m0 = (RA / 2) * (warp % 2), n0 = 32 * (warp / 2);
  const int tile = blockIdx.x, b = blockIdx.y, t0 = tile * RA;
  const int nv = min(RA, n - t0);
  const float* xb = x + (static_cast<size_t>(b) * Tlen + t0) * D;
  const int chunks = D / KF;

  copy_rows<float, RA, KF, XL>(xb, D, nv, 0, xs);
  copy_rows<float, KF, HID, WL>(wx, HID, KF, 0, ws);
  asv::cp_commit();
  float acc[MA][4][4];
  zero<MA, 4>(acc);
  const int col = 4 * warp + t;
  float* s1b = s1p + (static_cast<size_t>(b) * gridDim.x + tile) * D;
  float* s2b = s2p + (static_cast<size_t>(b) * gridDim.x + tile) * D;

  for (int kc = 0; kc < chunks; ++kc) {
    const int cur = kc % 2;
    asv::cp_wait_all();
    __syncthreads();
    if (kc + 1 < chunks) {
      copy_rows<float, RA, KF, XL>(xb + (kc + 1) * KF, D, nv, 0, xs + (1 - cur) * XS);
      copy_rows<float, KF, HID, WL>(wx + static_cast<size_t>(kc + 1) * KF * HID, HID, KF, 0,
                                    ws + (1 - cur) * WS);
      asv::cp_commit();
    }
    const float* xc = xs + cur * XS;
    tile_mma<MA, 4, KF, XL, false, WL, false>(xc, m0, ws + cur * WS, n0, g, t, acc);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int i = 0; i < RA / 8; ++i) {
      const float v = xc[XL::idx(8 * i, g, col & ~7, col & 7)];
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
    s1 = sum8(s1);
    s2 = sum8(s2);
    if (g == 0) {
      s1b[kc * KF + col] = s1;
      s2b[kc * KF + col] = s2;
    }
  }
  store_p(acc, p + (static_cast<size_t>(b) * Tlen + t0) * HID, m0, n0, nv, g, t);
}

// B. Grid (HID / 32, B): the block sums the tiles' partials in order to
// mean and std for every channel, then its 32 hidden units of
// c = mean @ Wm + std @ Ws + ba, thread (g, j) over channels
// [g D / 8, (g + 1) D / 8), the 8 groups added in order.
constexpr int CJ = 32;

__global__ void __launch_bounds__(THREADS)
context_bias_kernel(const float* __restrict__ s1p, const float* __restrict__ s2p, int tiles,
                    int D, int n, const float* __restrict__ wm, const float* __restrict__ wsd,
                    const float* __restrict__ ba, float* __restrict__ cst) {
  extern __shared__ float4 smem4[];
  float* mean = reinterpret_cast<float*>(smem4);   // D
  float* stdv = mean + D;                          // D
  float* part = stdv + D;                          // 8 x CJ
  const int b = blockIdx.y, j0 = blockIdx.x * CJ;
  const float nf = static_cast<float>(n);
  for (int c = threadIdx.x; c < D; c += THREADS) {
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < tiles; ++k) {
      const size_t o = (static_cast<size_t>(b) * tiles + k) * D + c;
      t1 += s1p[o];
      t2 += s2p[o];
    }
    const float m = t1 / nf;
    const float var = (t2 / nf - m * m) * (nf / (nf - 1.f));
    mean[c] = m;
    stdv[c] = sqrtf(fmaxf(var, 1e-4f));
  }
  __syncthreads();
  const int j = threadIdx.x % CJ, g = threadIdx.x / CJ;
  const int per = D / (THREADS / CJ);
  float dm = 0.f, ds = 0.f;
  for (int c = g * per; c < (g + 1) * per; ++c) {
    dm = fmaf(mean[c], wm[c * HID + j0 + j], dm);
    ds = fmaf(stdv[c], wsd[c * HID + j0 + j], ds);
  }
  part[g * CJ + j] = dm + ds;
  __syncthreads();
  if (g == 0) {
    float s = 0.f;
    for (int k = 0; k < THREADS / CJ; ++k) s += part[k * CJ + j];
    cst[b * HID + j0 + j] = s + ba[j0 + j];
  }
}

// h = relu(P + c) * s + bias for the 4 hidden units k4 .. k4 + 3.
struct Hidden {
  float4 c, s, bias;
  __device__ __forceinline__ Hidden(const float* cp, const float* sp, const float* bp, int k4)
      : c(*reinterpret_cast<const float4*>(cp + k4)),
        s(*reinterpret_cast<const float4*>(sp + k4)),
        bias(*reinterpret_cast<const float4*>(bp + k4)) {}
  __device__ __forceinline__ float4 operator()(float4 v) const {
    return make_float4(fmaxf(v.x + c.x, 0.f) * s.x + bias.x, fmaxf(v.y + c.y, 0.f) * s.y + bias.y,
                       fmaxf(v.z + c.z, 0.f) * s.z + bias.z, fmaxf(v.w + c.w, 0.f) * s.w + bias.w);
  }
};

// Four floats as bf16 (round to nearest even), and what they leave.
__device__ __forceinline__ uint2 to_bf16x4(float4 v, float4& rest) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  rest = make_float4(v.x - fa.x, v.y - fa.y, v.z - fb.x, v.w - fb.y);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
}

// C's logits in 3xbf16: h and Wb's tile each as two bf16 planes hi + lo
// (round to nearest even, lo = bf16(v - hi)), and mma.sync m16n8k16 with
// ldmatrix accumulating lo hi + hi lo + hi hi in f32: the same logits to
// about 2^-16, half the tensor-core work of 3xTF32 and no split as
// fragments are read. The front of shared memory: Wb's tile as two planes
// (HID rows of BT2, 256-byte swizzled rows), split once per block; then two
// chunk buffers, each R2 rows of P in f32 that become h's two planes
// (R2 rows of HID, swizzled) in place.
struct HiddenBf16x3 {
  static constexpr size_t W_BYTES = 2 * HID * BT2 * sizeof(bf16);
  static constexpr size_t C_BYTES = R2 * HID * sizeof(float);
  static constexpr size_t BYTES = W_BYTES + 2 * C_BYTES;
  static_assert(2 * R2 * HID * sizeof(bf16) == C_BYTES, "h's planes fill its P chunk");
  const float *wb, *pb, *c, *s, *bias;
  int D;
  bf16* wp;
  char* chunks;
  __device__ __forceinline__ void bind(char* smem) {
    wp = reinterpret_cast<bf16*>(smem);
    chunks = smem + W_BYTES;
  }
  __device__ __forceinline__ void load_w(int c0) const {
    for (int i = threadIdx.x; i < HID * BT2 / 4; i += THREADS) {
      const int k = i / (BT2 / 4), col = (i % (BT2 / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(wb + static_cast<size_t>(k) * D + c0 + col);
      float4 lo, none;
      *reinterpret_cast<uint2*>(wp + swz<BT2>(k, col)) = to_bf16x4(v, lo);
      *reinterpret_cast<uint2*>(wp + HID * BT2 + swz<BT2>(k, col)) = to_bf16x4(lo, none);
    }
  }
  __device__ __forceinline__ void load_h(int n, int t0, int buf) const {
    copy_rows<float, R2, HID, Pad<HID>>(pb, HID, n, t0,
                                        reinterpret_cast<float*>(chunks + buf * C_BYTES));
  }
  __device__ __forceinline__ void logits(int buf, int r0, int n0, int g, int t,
                                         float acc[2][4][4]) const {
    const int k4 = 4 * (threadIdx.x % 32);
    const Hidden hid(c, s, bias, k4);
    const float* pc = reinterpret_cast<const float*>(chunks + buf * C_BYTES);
    bf16* hp = reinterpret_cast<bf16*>(chunks + buf * C_BYTES);
    float4 hv[R2 / 8];
#pragma unroll
    for (int j = 0; j < R2 / 8; ++j)
      hv[j] = hid(*reinterpret_cast<const float4*>(pc + (threadIdx.x / 32 + 8 * j) * HID + k4));
    __syncthreads();   // the whole P chunk is read: its planes take its place
#pragma unroll
    for (int j = 0; j < R2 / 8; ++j) {
      const int r = threadIdx.x / 32 + 8 * j;
      float4 lo, none;
      *reinterpret_cast<uint2*>(hp + swz<HID>(r, k4)) = to_bf16x4(hv[j], lo);
      *reinterpret_cast<uint2*>(hp + R2 * HID + swz<HID>(r, k4)) = to_bf16x4(lo, none);
    }
    __syncthreads();
    const int lane = threadIdx.x % 32;
    const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lchunk = 8 * (lane >> 4);
    zero<2, 4>(acc);
#pragma unroll 2
    for (int k0 = 0; k0 < HID; k0 += 16) {
      uint32_t ah[2][4], al[2][4], bh[2][4], bl[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        ldsm4<false>(ah[m], hp + swz<HID>(r0 + 16 * m + lrow, k0 + lchunk));
        ldsm4<false>(al[m], hp + R2 * HID + swz<HID>(r0 + 16 * m + lrow, k0 + lchunk));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ldsm4<true>(bh[h], wp + swz<BT2>(k0 + lrow, n0 + 16 * h + lchunk));
        ldsm4<true>(bl[h], wp + HID * BT2 + swz<BT2>(k0 + lrow, n0 + 16 * h + lchunk));
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int h = nt / 2, e = 2 * (nt % 2);
          mma_bf16(acc[m][nt], al[m], bh[h][e], bh[h][e + 1]);
          mma_bf16(acc[m][nt], ah[m], bl[h][e], bl[h][e + 1]);
          mma_bf16(acc[m][nt], ah[m], bh[h][e], bh[h][e + 1]);
        }
    }
  }
};

// C's output: [mu || sigma] of utterance b.
struct MuSigma {
  float* out;   // at (b, c0); sigma D further
  int D;
  __device__ __forceinline__ void operator()(int c, float mu, float e2, float, float) const {
    out[c] = mu;
    out[D + c] = sqrtf(fmaxf(e2 - mu * mu, 1e-4f));
  }
};

// C. Grid (D / BT2, B), one 256-thread block per SM.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
attentive_pool_kernel(const T* __restrict__ x, const float* __restrict__ p,
                      const float* __restrict__ cst, const float* __restrict__ sc,
                      const float* __restrict__ bi, const float* __restrict__ wb,
                      const float* __restrict__ bb, int Tlen, int D, int n,
                      float* __restrict__ out) {
  const int b = blockIdx.y, c0 = blockIdx.x * BT2;
  HiddenBf16x3 lg{};
  lg.wb = wb;
  lg.pb = p + static_cast<size_t>(b) * Tlen * HID;
  lg.c = cst + b * HID;
  lg.s = sc;
  lg.bias = bi;
  lg.D = D;
  softmax_pool<T>(x + static_cast<size_t>(b) * Tlen * D + c0, bb, n, D, c0, lg,
                  MuSigma{out + static_cast<size_t>(b) * 2 * D + c0, D});
}

constexpr size_t PROJ_SMEM_BF16 = 2 * (RA * KA + NPL * KA * HID) * sizeof(bf16);
constexpr size_t PROJ_SMEM_F32 = 2 * (RA * (KF + 8) + KF * (HID + 8)) * sizeof(float);

// Scratch floats: P (B, T, 128), the column-sum partials 2 x (B, tiles, D),
// c (B, 128).
size_t work_floats(int B, int Tlen, int D, int n) {
  const size_t tiles = (n + RA - 1) / RA;
  return static_cast<size_t>(B) * Tlen * HID + 2 * B * tiles * D + static_cast<size_t>(B) * HID;
}

template <typename T>
cudaError_t launch(const void* xv, const void* planes, int B, int Tlen, int D, int n,
                   const float* wx, const float* wm, const float* wsd, const float* ba,
                   const float* sc, const float* bi, const float* wb, const float* bb,
                   float* work, float* out, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const int tiles = (n + RA - 1) / RA;
  float* p = work;
  float* s1p = p + static_cast<size_t>(B) * Tlen * HID;
  float* s2p = s1p + static_cast<size_t>(B) * tiles * D;
  float* cst = s2p + static_cast<size_t>(B) * tiles * D;
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    if ((err = asv::allow_smem(proj_stats_bf16_kernel, PROJ_SMEM_BF16)) != cudaSuccess) return err;
    proj_stats_bf16_kernel<<<dim3(tiles, B), THREADS, PROJ_SMEM_BF16, st>>>(
        x, static_cast<const bf16*>(planes), Tlen, D, n, p, s1p, s2p);
  } else {
    if ((err = asv::allow_smem(proj_stats_f32_kernel, PROJ_SMEM_F32)) != cudaSuccess) return err;
    proj_stats_f32_kernel<<<dim3(tiles, B), THREADS, PROJ_SMEM_F32, st>>>(x, wx, Tlen, D, n, p,
                                                                          s1p, s2p);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t csmem = (2 * D + (THREADS / CJ) * CJ) * sizeof(float);
  if ((err = asv::allow_smem(context_bias_kernel, csmem)) != cudaSuccess) return err;
  context_bias_kernel<<<dim3(HID / CJ, B), THREADS, csmem, st>>>(s1p, s2p, tiles, D, n, wm, wsd,
                                                                 ba, cst);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t psmem = pool_smem<T, HiddenBf16x3>();
  if ((err = asv::allow_smem(attentive_pool_kernel<T>, psmem)) != cudaSuccess) return err;
  attentive_pool_kernel<T><<<dim3(D / BT2, B), THREADS, psmem, st>>>(x, p, cst, sc, bi, wb, bb,
                                                                     Tlen, D, n, out);
  return cudaGetLastError();
}

}  // namespace

// The scratch attn_pool_forward needs, in floats, for these sizes.
extern "C" long long attn_pool_workspace(int B, int Tlen, int D, int n) {
  return static_cast<long long>(work_floats(B, Tlen, D, n));
}

// x (B, T, D) f32 or bf16 (code 0 / 1), D a multiple of 128; n valid rows
// (2 <= n <= T); wx, wm, wsd (D, 128), wb (128, D), ba, sc, bi (128), bb (D)
// f32; for bf16 x, planes (NPL, D, 128) bf16, the planes of wx (n_planes
// must be NPL; unread for f32 x); work: attn_pool_workspace(B, T, D, n)
// floats of scratch; out (B, 2 D) f32. x, wx, planes and wb start on a
// 16-byte boundary. Returns cudaGetLastError() after the last launch.
extern "C" int attn_pool_forward(const void* x, int B, int Tlen, int D, int n,
                                 const float* wx, const void* planes, int n_planes,
                                 const float* wm, const float* wsd, const float* ba,
                                 const float* sc, const float* bi, const float* wb,
                                 const float* bb, float* work, float* out, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % BT2 != 0 || n < 2 || n > Tlen) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == asv::kF32)
    return static_cast<int>(launch<float>(x, planes, B, Tlen, D, n, wx, wm, wsd, ba, sc, bi,
                                          wb, bb, work, out, st));
  if (dtype == asv::kBF16 && n_planes == NPL)
    return static_cast<int>(launch<bf16>(x, planes, B, Tlen, D, n, wx, wm, wsd, ba, sc, bi, wb,
                                         bb, work, out, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// B4a is B3's pool pass (csrc/attn_pool.cu) without the folded BN: per
// 128-channel tile and utterance, W2's tile stays in shared memory while
// 64-row chunks of h2 stream through, with an online softmax over T
// (running max, normalizer, sum w x, sum w x^2). It also writes the max and
// the normalizer per (b, d), so the backward needs no pass to find them,
// and S = g_mu mu + g_e2 e2 comes from the forward's outputs. Its product
// runs as f32 FMAs from shared memory.
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
// on this one. The shared-memory tiles are laid out (Xor and Pad below) so
// that every fragment read, the transposed h2 read of dW2 included, and the
// epilogue's writes are free of bank conflicts. The epilogue forms
// w = exp(logit + (b2 - M)) * (1 / L) from per-channel constants, with
// __expf: expf and a division take about 13% longer at the training shape
// and leave the errors phase 2b of chip_smoke.py measures where they are.
// B4a forms exp(logit + b2 - M) / L from FMA logits, so w here does not sum
// to exactly 1 over T; that and the 3xTF32 logits make B4b's errors.
//
// Bound: at B = 64, T = 750, D = 1536 in f32 the forward's product is 18.9
// GFLOP (0.28 ms at the f32 rate) against 320 MB (0.096 ms). The backward's
// three products are 56.6 GFLOP, 3 x 56.6 = 170 GFLOP of TF32 in 3xTF32:
// 0.343 ms at 495 TFLOP/s (0.845 ms at the f32 rate), against about 640 MB
// (0.191 ms). Passes 1 and 2 both recompute the logits, a fourth product.
// One pass that recomputed them once would save 3 x 18.9 GFLOP / 495
// TFLOP/s = 0.115 ms at peak, but it has to keep a (B, D/128, T, 128) f32
// partial of dh2 (its sum over channel tiles cannot stay in one block),
// written and read back: 2 x 295 MB, at least 0.18 ms at 3.35 TB/s, and
// about 281 MiB more peak memory. It gains nothing at the bound, so B4b
// keeps its two passes.

#include "common.cuh"

namespace {

constexpr int HID = 128;      // attention hidden width
constexpr int TILE = 128;     // channels per tile
constexpr int ROWS = 64;      // T rows per chunk
constexpr int THREADS = 256;  // 8 warps (B4a: warp rg owns rows rg*8 .. rg*8+7)

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

// ---- B4b: products on the tensor cores in 3xTF32 ----

constexpr int BT1 = 64;         // pass 1: channels per W2 tile
constexpr int R1 = 128;         // pass 1: T rows per block
constexpr int BT2 = 128;        // pass 2: channels per block
constexpr int R2 = 64;          // pass 2: T rows per chunk
constexpr int NK = 5;           // per-channel constants: b2 - M, 1 / L, g_mu, g_e2, S

// Shared-memory tiles: element (r8 + y, c8 + x), r8 and c8 multiples of 8,
// y and x < 8, sits at
//   Pad<S>: (r8 + y) S + c8 + x;
//   Xor<S>: (r8 + y) S + c8 + (x ^ (y & 4)), S = 8 mod 32 (32-bit words).
// Xor's rows cover 32 banks 4 rows at a time, and the flip of bit 2 in the
// lower half of each 8 rows separates rows y and y + 4, so both fragment
// reads of mma.sync, 8 rows x 4 columns and 4 rows x 8 columns, and the
// epilogue's pair writes are free of bank conflicts. The flip stays inside
// groups of 8 columns, so a lane's address is a constant of the lane plus
// the tile's k offset, and it keeps 16-byte chunks whole for cp.async. bf16
// rows of h2 use Pad<136> (68 words, 4 mod 32), which serves both reads
// (two lanes share each word); the x tiles, read only as pairs by 8 rows x 4
// column pairs, use Pad with 8 elements of padding.
template <int SS> struct Pad {
  static constexpr int S = SS;
  static __device__ __forceinline__ int idx(int r8, int y, int c8, int x) {
    return (r8 + y) * SS + c8 + x;
  }
};
template <int SS> struct Xor {
  static_assert(SS % 32 == 8, "Xor needs a row stride of 8 mod 32 words");
  static constexpr int S = SS;
  static __device__ __forceinline__ int idx(int r8, int y, int c8, int x) {
    return (r8 + y) * SS + c8 + (x ^ (y & 4));
  }
};
template <typename T> struct HLay;                                  // h2 rows
template <> struct HLay<float> : Xor<HID + 8> {};
template <> struct HLay<__nv_bfloat16> : Pad<HID + 8> {};

// v = big + small for 3xTF32. big is v rounded to TF32 to nearest, ties
// away from zero: cvt.rna.tf32.f32, written as two integer operations (the
// instruction itself compiles to a longer sequence that guards NaN and
// infinity, which the operands here never are). small = v - big is exact in
// f32; the tensor core reads it as TF32 (its top 19 bits), so big + small
// holds v to 2^-21 |v| (one TF32 product keeps about 2^-11).
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

struct FragA { uint32_t big[4], small[4]; };   // m16 x k8, row major
struct FragB { uint32_t big[2], small[2]; };   // k8 x n8, column major

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the two small terms first, then big * big.
__device__ __forceinline__ void mma3(float d[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// The A fragment of rows m0 .. m0 + 15, columns k0 .. k0 + 7 of tile p
// (TR: of p's transpose, element (m, k) = p(k0 + k, m0 + m)), m0 and k0
// multiples of 8: lane (g, t) holds (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4).
template <class Lay, bool TR, typename T>
__device__ __forceinline__ void load_a(const T* p, int m0, int k0, int g, int t,
                                       FragA& a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mo = 8 * (i & 1), ko = 4 * (i >> 1);
    const int j = TR ? Lay::idx(k0, ko + t, m0 + mo, g) : Lay::idx(m0 + mo, g, k0, ko + t);
    split(asv::to_f32<T>(p[j]), a.big[i], a.small[i]);
  }
}

// The B fragment of rows k0 .. k0 + 7, columns n0 .. n0 + 7 of tile p (TR:
// of p's transpose): lane (g, t) holds (t, g) and (t + 4, g).
template <class Lay, bool TR>
__device__ __forceinline__ void load_b(const float* p, int k0, int n0, int g, int t,
                                       FragB& b) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = TR ? Lay::idx(n0, g, k0, 4 * i + t) : Lay::idx(k0, 4 * i + t, n0, g);
    split(p[j], b.big[i], b.small[i]);
  }
}

// acc[m][n] += A @ B over k < K in 3xTF32, for this warp's (16 MT) x (8 NT)
// tile at rows m0, columns n0: A rows of tile a (AT: a's transpose), B of
// tile b (BTR: b's transpose). acc[m][n] element 2 h + q sits at row
// m0 + 16 m + g + 8 h, column n0 + 8 n + 2 t + q.
template <int MT, int NT, int K, class LA, bool AT, class LB, bool BTR, typename TA>
__device__ __forceinline__ void tile_mma(const TA* a, int m0, const float* b, int n0,
                                         int g, int t, float acc[MT][NT][4]) {
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    FragA fa[MT];
    FragB fb[NT];
#pragma unroll
    for (int m = 0; m < MT; ++m) load_a<LA, AT>(a, m0 + 16 * m, k0, g, t, fa[m]);
#pragma unroll
    for (int n = 0; n < NT; ++n) load_b<LB, BTR>(b, k0, n0 + 8 * n, g, t, fb[n]);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) mma3(acc[m][n], fa[m], fb[n]);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float acc[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
}

// Two neighbouring elements of type T as f32, and back.
template <typename T> __device__ __forceinline__ float2 load2(const T* p);
template <> __device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <> __device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                  float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 16-byte copy global -> shared that fills zeros where !valid.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Tile element (r, v) = src[(t0 + r) * ld + v] for r < R, v < W, zero where
// t0 + r >= n; issued as cp.async, not committed.
template <typename T, int R, int W, class Lay>
__device__ __forceinline__ void copy_rows(const T* __restrict__ src, int ld,
                                          int n, int t0, T* dst) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = W / V;
#pragma unroll 4
  for (int i = threadIdx.x; i < R * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, v = (i % PER_ROW) * V;
    const bool ok = t0 + r < n;
    cp16(dst + Lay::idx(r & ~7, r & 7, v & ~7, v & 7),
         src + (ok ? static_cast<size_t>(t0 + r) * ld + v : 0), ok);
  }
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
  cp_commit();
  load_consts<BT1>(b2, mx, nrm, mu, e2, gmu, ge2, b, D, 0, kc);
  float dh[4][4][4];
  zero<4, 4>(dh);

  const int tiles = D / BT1;
  for (int i = 0; i < tiles; ++i) {
    const int c0 = i * BT1;
    const float* wt = ws + (i % 2) * HID * WL::S;
    cp_wait_all();
    __syncthreads();   // this tile's W2, x and constants are in
    if (i + 1 < tiles) {
      copy_rows<float, HID, BT1, WL>(w2 + c0 + BT1, D, HID, 0, ws + ((i + 1) % 2) * HID * WL::S);
      cp_commit();
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
      cp_commit();
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
  cp_commit();
  load_consts<BT2>(b2, mx, nrm, mu, e2, gmu, ge2, b, D, c0, kc);
  float dw[4][4][4];
  zero<4, 4>(dw);

  for (int i = 0; i < chunks; ++i) {
    const T* hc = hs + (i % 2) * R2 * SH;
    cp_wait_all();
    __syncthreads();   // this chunk's h2 and x are in
    if (i + 1 < chunks) {
      copy_rows<T, R2, HID, HLay<T>>(hb, HID, Tlen, (i + 1) * R2, hs + ((i + 1) % 2) * R2 * SH);
      cp_commit();
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
      cp_commit();
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

constexpr size_t FWD_SMEM = (HID * TILE + ROWS * HID) * sizeof(float);
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

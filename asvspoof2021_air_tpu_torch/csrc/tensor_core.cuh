// Tensor-core building blocks shared by B2 (res2_chain.cu), B3
// (attn_pool.cu) and B4a/B4b (attn_pool_vjp.cu): bf16 and 3xTF32 products
// on mma.sync, their shared-memory layouts, cp.async row copies, and the
// online-softmax pool over T that B4a and B3's last pass share.
#pragma once

#include "common.cuh"

namespace asv {
namespace tc {

constexpr int HID = 128;      // attention hidden width
constexpr int THREADS = 256;  // 8 warps: the block size of every kernel here

// ---- bf16 on mma.sync m16n8k16 ----

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 (TR: each matrix transposed).
template <bool TR>
__device__ __forceinline__ void ldsm4(uint32_t (&v)[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (TR)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3]) : "r"(s) : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3]) : "r"(s) : "memory");
}

// d += a b: a m16 x k16 (row major), b k16 x n8 (column major), bf16 in, f32
// accumulators; d element 2 h + q sits at row g + 8 h, column 2 t + q.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- 3xTF32 on mma.sync m16n8k8 ----

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
    asv::cp16(dst + Lay::idx(r & ~7, r & 7, v & ~7, v & 7),
         src + (ok ? static_cast<size_t>(t0 + r) * ld + v : 0), ok);
  }
}

// ---- the online-softmax pool over T (B4a, and B3's last pass) ----

// The pool's tiles: a BT-channel tile of W2 in shared memory while chunks of
// R rows of the hidden h and of x stream through, two buffers each.
constexpr int POOL_R = 64;     // rows per chunk
constexpr int POOL_BT = 128;   // channels per block

// The pool's logits as B4a forms them: h chunks of type TH in rows of HL,
// the f32 W2 tile in Xor rows, B4b's 3xTF32 tile product (so B4b recomputes
// the same logits). A Logits policy owns the front of the pool's shared
// memory (BYTES: the W2 tile, then the two h buffers) and gives:
//   load_w(c0), load_h(n, t0, buf): cp.async, not committed;
//   logits(buf, r0, n0, g, t, acc): acc = the 32 x 32 logits (without b2)
//     of chunk buffer buf at rows r0, channels n0, in mma.sync's layout.
template <typename TH, class HL>
struct Tf32Logits {
  using WL = Xor<POOL_BT + 8>;
  static constexpr size_t W_BYTES = HID * WL::S * sizeof(float);
  static constexpr size_t BYTES = W_BYTES + 2 * POOL_R * HL::S * sizeof(TH);
  const float* w2;   // (HID, D)
  const TH* hb;      // h rows of the utterance, stride HID
  int D;
  float* ws;
  TH* hs;
  __device__ __forceinline__ void bind(char* smem) {
    ws = reinterpret_cast<float*>(smem);
    hs = reinterpret_cast<TH*>(smem + W_BYTES);
  }
  __device__ __forceinline__ TH* chunk(int buf) const { return hs + buf * POOL_R * HL::S; }
  __device__ __forceinline__ void load_w(int c0) const {
    copy_rows<float, HID, POOL_BT, WL>(w2 + c0, D, HID, 0, ws);
  }
  __device__ __forceinline__ void load_h(int n, int t0, int buf) const {
    copy_rows<TH, POOL_R, HID, HL>(hb, HID, n, t0, chunk(buf));
  }
  __device__ __forceinline__ void logits(int buf, int r0, int n0, int g, int t,
                                         float acc[2][4][4]) const {
    zero<2, 4>(acc);
    tile_mma<2, 4, HID, HL, false, WL, false>(chunk(buf), r0, ws, n0, g, t, acc);
  }
};

template <typename TX, class Logits>
constexpr size_t pool_smem() {
  return Logits::BYTES + 2 * POOL_R * (POOL_BT + 8) * sizeof(TX);
}

// One (BT-channel tile, utterance) of the pool, one 256-thread block, over
// the first n rows: logits = h @ W2 + b2 (the policy lg) and a softmax over
// those rows per channel; calls out(c, sum w x, sum w x^2, max, normalizer)
// for each channel c < BT of the tile. xb points at x's row 0, channel c0
// (row stride D).
//
// The block keeps its W2 tile and walks the rows in chunks of R, in order,
// the next chunk's h and x on their way (cp.async, two buffers each) while
// it works on this one. Warp w computes the chunk's logits at rows
// 32 (w % 2), channels 32 (w / 2), and folds them into a running max,
// normalizer, sum e x and sum e x^2 per channel of its row group: lane
// (g, t) owns rows 32 (w % 2) + g + 8 k, k < 4, of every chunk and channels
// 32 (w / 2) + 8 n + 2 t + q, n < 4, q < 2. The 16 row groups of a channel
// are merged in order at the end.
template <typename TX, class Logits, class Out>
__device__ __forceinline__ void softmax_pool(const TX* __restrict__ xb,
                                             const float* __restrict__ b2, int n, int D,
                                             int c0, Logits lg, const Out& out) {
  constexpr int R = POOL_R, BT = POOL_BT;
  using XL = Pad<BT + 8>;
  constexpr int GROUPS = 16;                         // row groups per channel
  static_assert(Logits::BYTES >= 4 * GROUPS * BT * sizeof(float), "room for the merge");
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  lg.bind(base);
  TX* xs = reinterpret_cast<TX*>(base + Logits::BYTES);   // 2 x R x XL::S: x chunks
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int r0 = 32 * (warp % 2), n0 = 32 * (warp / 2);
  const int chunks = (n + R - 1) / R;

  lg.load_w(c0);
  lg.load_h(n, 0, 0);
  copy_rows<TX, R, BT, XL>(xb, D, n, 0, xs);
  asv::cp_commit();
  // Channel j = 2 n + q of this lane: b2, and its row group's running max,
  // normalizer, sum e x and sum e x^2.
  float bias[8], m[8], l[8], s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bias[j] = b2[c0 + n0 + 8 * (j / 2) + 2 * t + j % 2];
    m[j] = -INFINITY;
    l[j] = s1[j] = s2[j] = 0.f;
  }

  for (int i = 0; i < chunks; ++i) {
    const int cur = i % 2;
    asv::cp_wait_all();
    __syncthreads();   // this chunk's h and x are in; the other buffers are free
    if (i + 1 < chunks) {
      lg.load_h(n, (i + 1) * R, 1 - cur);
      copy_rows<TX, R, BT, XL>(xb, D, n, (i + 1) * R, xs + (1 - cur) * R * XL::S);
      asv::cp_commit();
    }
    float acc[2][4][4];
    lg.logits(cur, r0, n0, g, t, acc);
    const TX* xc = xs + cur * R * XL::S;
    const int valid = n - i * R;   // rows of this chunk before n
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      float cmax[2] = {m[2 * nn], m[2 * nn + 1]};
#pragma unroll
      for (int mh = 0; mh < 4; ++mh)   // acc[mh / 2][nn][2 (mh % 2) + q]: row r0 + 8 mh + g
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float& v = acc[mh / 2][nn][2 * (mh % 2) + q];
          v += bias[2 * nn + q];
          if (r0 + 8 * mh + g < valid) cmax[q] = fmaxf(cmax[q], v);
        }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = 2 * nn + q;
        if (cmax[q] == -INFINITY) continue;   // no valid row in this group yet
        const float f = __expf(m[j] - cmax[q]);
        l[j] *= f;
        s1[j] *= f;
        s2[j] *= f;
        m[j] = cmax[q];
      }
#pragma unroll
      for (int mh = 0; mh < 4; ++mh) {
        const int r8 = r0 + 8 * mh;
        if (r8 + g >= valid) continue;
        const float2 v = load2<TX>(xc + XL::idx(r8, g, n0 + 8 * nn, 2 * t));
        const float vq[2] = {v.x, v.y};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j = 2 * nn + q;
          const float e = __expf(acc[mh / 2][nn][2 * (mh % 2) + q] - m[j]);
          l[j] += e;
          s1[j] = fmaf(e, vq[q], s1[j]);
          s2[j] = fmaf(e * vq[q], vq[q], s2[j]);
        }
      }
    }
  }
  __syncthreads();   // every warp is done with the tiles: the front takes the partials

  float* pm = reinterpret_cast<float*>(base);   // GROUPS x BT each
  float* pl = pm + GROUPS * BT;
  float* p1 = pl + GROUPS * BT;
  float* p2 = p1 + GROUPS * BT;
  const int rg = 8 * (warp % 2) + g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = rg * BT + n0 + 8 * (j / 2) + 2 * t + j % 2;
    pm[k] = m[j];
    pl[k] = l[j];
    p1[k] = s1[j];
    p2[k] = s2[j];
  }
  __syncthreads();
  if (threadIdx.x < BT) {
    const int c = threadIdx.x;
    float M = -INFINITY;
    for (int q = 0; q < GROUPS; ++q) M = fmaxf(M, pm[q * BT + c]);
    float L = 0.f, S1 = 0.f, S2 = 0.f;
    for (int q = 0; q < GROUPS; ++q) {
      const float mq = pm[q * BT + c];
      if (mq == -INFINITY) continue;   // no valid row in this group
      const float f = expf(mq - M);
      L = fmaf(pl[q * BT + c], f, L);
      S1 = fmaf(p1[q * BT + c], f, S1);
      S2 = fmaf(p2[q * BT + c], f, S2);
    }
    out(c, S1 / L, S2 / L, M, L);
  }
}

}  // namespace tc
}  // namespace asv

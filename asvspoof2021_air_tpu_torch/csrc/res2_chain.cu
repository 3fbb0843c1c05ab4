// B2: the inference Res2 chain of one ECAPA Bottle2neck.
//
// Replaces the JAX package's Pallas kernel _chain_kernel
// (ops/res2_chain_pallas.py:54). For i = 0 .. scale-2:
//   sp = g_i (+ sp);  y = dilated k=3 conv of sp (64 -> 64) + bias;
//   sp = a * relu(y) + b   (folded inference BatchNorm);
// with rows >= valid_len reading as zeros before every conv and written as
// zeros; group scale-1 passes through (masked the same way).
//
// The seven convs are sequential and each tap reads sp at t +- d, so a tile
// of TT output rows needs H = (scale-1) d halo rows each side of the input.
// One block owns one utterance's tile of R = TT + 2 H rows and recomputes
// the halo: conv i computes local rows [(i+1) d, R - (i+1) d), 1.25x the
// conv work of the tile's own rows at d = 4. So no intermediate leaves the
// block: x is read once and the output written once, as on the TPU. Values
// are rounded to the I/O type wherever the Pallas kernel stores them in that
// type (sp + g, and the BN output), with f32 accumulation and an f32 BN
// affine.
//
// bf16, the serving path (res2_chain_mma_kernel): each conv is a
// (rows, 3 x 64) @ (3 x 64, 64) product on mma.sync m16n8k16 in bf16 with
// f32 accumulation. The operands are bf16 already, rounded where the Pallas
// kernel rounds them, so this adds no rounding; only the order of the sums
// differs. The chain's input u lives in shared memory in bf16, and the
// three taps are the same u rows at offsets -d, 0 and +d: ldmatrix takes
// one row address per lane, so the shift costs nothing. wgmma does not fit:
// its shared-memory operand is built of 8-row core matrices at fixed
// offsets, and a shift by d = 2 or 3 breaks that alignment. Rows are 128
// bytes whose 16-byte chunks are XOR-swizzled by the row (swz), so the 8
// rows of any ldmatrix, at any shift, and the epilogue's pair accesses hit
// distinct banks. W_i (24.6 KB) sits in shared memory; W_{i+1} and x's
// group i+2 arrive by cp.async while conv i runs. The epilogue (bias, ReLU,
// BN, masking, rounding) runs on the accumulator fragments: it writes the
// tile's own rows of group i to the output and turns the buffer holding x's
// group i+1 into the next conv's input, u = bf16(g + s), in place. Three
// row buffers rotate (u_i read, g_{i+1} -> u_{i+1}, g_{i+2} arriving):
// 105 KB at d = 4, two blocks per SM.
// TT = 96 was measured (chip_smoke.py's phase 2 on an H100 SXM at 700 W)
// against 64 and 128 rows, and against one persistent block per SM that
// keeps all seven W_i (172 KB) and walks the tiles: 0.086-0.087 ms a launch
// at (64, 750, 512), against 0.101-0.106, 0.095-0.098 (one block per SM at
// d = 4) and 0.121-0.124 (8 warps an SM hide less latency than 16; the W
// traffic it saves is not what bounds the kernel). At T = 750 it also runs
// 512 blocks, 1.94 waves of 264.
//
// f32, the default of the feature-file scorers and ServingECAPA(dtype=
// float32) (res2_chain_tf32_kernel): the same product on mma.sync m16n8k8
// in 3xTF32. Every operand v is split as it is read into big = rna-TF32(v)
// and small = v - big (tensor_core.cuh's split), and a w is taken as
// a_small w_big + a_big w_small + a_big w_big: 2^-21 of each operand, f32's
// accuracy. The two small terms go to one accumulator and a_big w_big to
// another, added in the epilogue: the tensor cores' f32 accumulation
// truncates, and the small terms are then not accumulated at the sum's
// magnitude, which halves the error against the plain f32 chain (2.5e-5 to
// 1.3e-5 at (64, 750, 512), bar 1e-4) at the same speed. The tiling is the
// bf16 kernel's, in f32: u's 256-byte rows are XOR-swizzled by 16-byte
// chunks (swz_f32) so ldmatrix (b16 pairs load TF32 A fragments) reads the
// shifted taps at any d and the epilogue's float2 accesses without bank
// conflicts; W_i (49 KB) in swizzled rows (swz_w) gives conflict-free
// scalar B reads. Three row buffers, two W buffers and the BN constants
// take 220 KB at d = 4: one block of 16 warps per SM. It is persistent: it walks its tiles conv
// after conv, so the next tile's first loads ride under this one's last
// convs, and a warp's job is 16 rows x 32 channels (12-18 jobs a conv at
// d = 4, against 6-10 of 32 rows). Bound: bytes, x in and out in f32
// (196.6 MB, 0.0588 ms at 3.35 TB/s) against 3 x 8.26 GFLOP at the TF32
// rate (0.050 ms); mma.sync reaches 314 TFLOP/s of TF32 on this card
// (tools/torch_mma_rate.py), so the products alone take 0.09-0.10 ms with
// the halo.
// Measured with tools/torch_kernel_turns.py (an H100 SXM at 700 W, ms a
// launch at (64, 750, 512), d = 2 / 3 / 4, each alternative in the same
// call as this design, which read 0.244-0.248 / 0.259 / 0.268-0.269; the
// first, FMA design read 0.527 / 0.806-0.810 / 0.864-0.868):
//   A by four 32-bit loads instead of ldmatrix   0.269 / 0.280 / 0.291
//   64-row tiles                                  0.289 / 0.297 / 0.306
//   one tile per block, not persistent            0.250 / 0.265 / 0.277
//   8 warps an SM (256 threads)                   0.265 / 0.274 / 0.283
//   loads waited in the conv that issues them     0.270 / 0.283 / 0.292
//   one accumulator for all three products        0.248 / 0.264 / 0.273
//   no split, one TF32 product (wrong; a bound)   0.148 / 0.151 / 0.158
// 32-row jobs read 0.260 / 0.273 / 0.282 against 0.250 / 0.264 / 0.276 for
// 16-row ones in an earlier call. What bounds it: the split (the last row:
// 0.10 ms of the 0.26), then the per-conv barrier, whose epilogue and
// copies the warps of a block cannot overlap with products. Splitting u
// once in the epilogue, or W once per conv, needs a second plane of each
// (another 49 KB for W, 39 KB per row buffer at d = 4): it does not fit
// beside the double-buffered W and three row buffers. wgmma (TF32, A from
// registers) was not tried: its B operand must be split in shared memory,
// the same planes that do not fit.
//
// Bound (bf16): bytes. x in + out, 2 * B * T * 512 elements (98 MB in bf16
// at B=64, T=750, 0.03 ms at 3.35 TB/s) against 8.3 GFLOP of conv products
// per launch (0.008 ms at the bf16 tensor-core rate).

#include "tensor_core.cuh"

namespace {

constexpr int WIDTH = 64;
constexpr int TT = 96;         // bf16: output rows per block (measured against 64 and 128)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TT_F32 = 96;     // f32: output rows per tile
constexpr int F32_THREADS = 512;
constexpr int F32_WARPS = F32_THREADS / 32;

using bf16 = __nv_bfloat16;
using asv::tc::FragA;
using asv::tc::FragB;
using asv::tc::ldsm4;
using asv::tc::mma_bf16;
using asv::tc::mma_tf32;
using asv::tc::split;

// ---- bf16: the convs on the tensor cores ----

// Element (r, c) of a tile of 64-channel bf16 rows: 16-byte chunk c / 8 of
// row r sits at chunk (c / 8) ^ (r % 8).
__device__ __forceinline__ int swz(int r, int c) {
  return r * WIDTH + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// Rows r < n of a swizzled tile from src[(r0 + r) * ld], 64 channels each,
// zero where r0 + r is outside [0, valid); cp.async, not committed.
__device__ __forceinline__ void copy_rows(const bf16* __restrict__ src, int ld, int r0, int n,
                                          int valid, bf16* dst) {
  for (int i = threadIdx.x; i < n * 8; i += THREADS) {
    const int r = i >> 3, c = (i & 7) * 8, gr = r0 + r;
    const bool ok = gr >= 0 && gr < valid;
    asv::cp16(dst + swz(r, c), src + (ok ? static_cast<size_t>(gr) * ld + c : 0), ok);
  }
}

// Grid (ceil(T / TT), B). Warp w computes 32-row x 32-channel jobs
// w, w + 8, ... of each conv: rows lo + 32 (job / 2), channels 32 (job % 2),
// so its channels, 32 (w % 2) + 8 n + 2 t + q, stay the same.
__global__ void __launch_bounds__(THREADS, 2)
res2_chain_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const float* __restrict__ cb, const float* __restrict__ ca,
                      const float* __restrict__ cbias, bf16* __restrict__ out, int Tlen,
                      int valid, int dil, int scale) {
  constexpr int WSZ = 3 * WIDTH * WIDTH;   // one conv's weights
  extern __shared__ float4 smem4[];
  const int H = (scale - 1) * dil, R = TT + 2 * H, C = WIDTH * scale;
  const int layers = scale - 1;
  bf16* ws = reinterpret_cast<bf16*>(smem4);   // 2 x 3 WIDTH rows: W_i, W_{i+1}
  bf16* rows = ws + 2 * WSZ;                   // 3 x R rows: u_i, g_{i+1}, g_{i+2}
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lchunk = 8 * (lane >> 4);
  const int n0 = 32 * (warp % 2);
  const int b = blockIdx.y, t0 = blockIdx.x * TT, r0 = t0 - H;
  const bf16* xb = x + static_cast<size_t>(b) * Tlen * C;
  bf16* ob = out + static_cast<size_t>(b) * Tlen * C;

  copy_rows(xb, C, r0, R, valid, rows);
  copy_rows(w, WIDTH, 0, 3 * WIDTH, 3 * WIDTH, ws);
  if (layers > 1) copy_rows(xb + WIDTH, C, r0, R, valid, rows + R * WIDTH);
  asv::cp_commit();

  // Pass-through group, zeroed past valid.
  for (int i = threadIdx.x; i < TT * 8; i += THREADS) {
    const int r = t0 + (i >> 3);
    if (r >= Tlen) break;
    const size_t off = static_cast<size_t>(r) * C + layers * WIDTH + (i & 7) * 8;
    *reinterpret_cast<uint4*>(ob + off) =
        r < valid ? *reinterpret_cast<const uint4*>(xb + off) : make_uint4(0, 0, 0, 0);
  }

  for (int i = 0; i < layers; ++i) {
    const bf16* wi = ws + (i % 2) * WSZ;
    const bf16* u = rows + (i % 3) * R * WIDTH;
    bf16* gn = rows + ((i + 1) % 3) * R * WIDTH;   // x's group i+1 -> u_{i+1}
    asv::cp_wait_all();
    __syncthreads();   // u_i, W_i and group i+1 are in; the other buffers are free
    if (i + 1 < layers) {
      copy_rows(w + static_cast<size_t>(i + 1) * WSZ, WIDTH, 0, 3 * WIDTH, 3 * WIDTH,
                ws + ((i + 1) % 2) * WSZ);
      if (i + 2 < layers)
        copy_rows(xb + (i + 2) * WIDTH, C, r0, R, valid, rows + ((i + 2) % 3) * R * WIDTH);
      asv::cp_commit();
    }
    // This lane's channels c = n0 + 8 (j / 2) + 2 t + j % 2: conv bias, BN a, b.
    float kb[8], ka[8], kc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = i * WIDTH + n0 + 8 * (j / 2) + 2 * t + j % 2;
      kb[j] = cb[c];
      ka[j] = ca[c];
      kc[j] = cbias[c];
    }
    const int lo = (i + 1) * dil, hi = R - (i + 1) * dil;
    const int jobs = 2 * ((hi - lo + 31) / 32);
    for (int job = warp; job < jobs; job += WARPS) {
      const int mb = lo + 32 * (job / 2);
      const bool two = mb + 16 < hi;   // the second 16-row tile has rows to compute
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) {
        // rows past the buffer feed only rows >= hi, which are not kept
        const int ra0 = min(mb + lrow + (tap - 1) * dil, R - 1);
        const int ra1 = min(ra0 + 16, R - 1);
#pragma unroll
        for (int k0 = 0; k0 < WIDTH; k0 += 16) {
          uint32_t a0[4], a1[4], bq[2][4];
          ldsm4<false>(a0, u + swz(ra0, k0 + lchunk));
          if (two) ldsm4<false>(a1, u + swz(ra1, k0 + lchunk));
#pragma unroll
          for (int p = 0; p < 2; ++p)
            ldsm4<true>(bq[p], wi + swz(tap * WIDTH + k0 + lrow, n0 + 16 * p + lchunk));
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint32_t b0 = bq[nt / 2][2 * (nt % 2)], b1 = bq[nt / 2][2 * (nt % 2) + 1];
            mma_bf16(acc[0][nt], a0, b0, b1);
            if (two) mma_bf16(acc[1][nt], a1, b0, b1);
          }
        }
      }
      // Epilogue: s = bf16(a relu(y + cb) + b), zero outside [0, valid).
#pragma unroll
      for (int mh = 0; mh < 4; ++mh) {
        const int l = mb + 8 * mh + g, r = r0 + l;   // local and global row
        if (l >= hi) continue;
        const bool in = r >= 0 && r < valid;
        const bool own = l >= H && l < H + TT && r < Tlen;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = n0 + 8 * nt + 2 * t, j = 2 * nt, e = 2 * (mh % 2);
          const __nv_bfloat162 s = __floats2bfloat162_rn(
              in ? ka[j] * fmaxf(acc[mh / 2][nt][e] + kb[j], 0.f) + kc[j] : 0.f,
              in ? ka[j + 1] * fmaxf(acc[mh / 2][nt][e + 1] + kb[j + 1], 0.f) + kc[j + 1]
                 : 0.f);
          if (own)
            *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(r) * C + i * WIDTH + c) = s;
          if (i + 1 < layers) {
            __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(gn + swz(l, c));
            const float2 gv = __bfloat1622float2(*p), sv = __bfloat1622float2(s);
            *p = __floats2bfloat162_rn(gv.x + sv.x, gv.y + sv.y);
          }
        }
      }
    }
  }
}

// ---- f32: the convs on the tensor cores in 3xTF32 ----

// Element (r, c) of a tile of 64-channel f32 rows (256 bytes): 16-byte chunk
// c / 4 of row r sits at chunk (c / 4) ^ key(r), key(r) = 2 (r % 4) + (r / 4)
// % 2. Any 8 consecutive rows get 8 keys (ldmatrix's 8-row reads at any
// shift), and any 4 consecutive rows keys that differ in bits 1-2, so a
// half-warp's float2 accesses of the epilogue (4 rows x 2 chunks) hit 8
// distinct chunk positions.
__device__ __forceinline__ int swz_f32(int r, int c) {
  return r * WIDTH + ((((c >> 2) ^ (((r & 3) << 1) | ((r >> 2) & 1))) << 2) | (c & 3));
}

// Element (k, n) of W_i (192 rows of 64 f32 channels): chunk n / 4 of row k
// sits at chunk (n / 4) ^ 2 (k % 4), so the B fragment's 8 x 4 reads (rows
// k0 + t, columns n0 + g) hit 32 banks.
__device__ __forceinline__ int swz_w(int k, int n) {
  return k * WIDTH + ((((n >> 2) ^ ((k & 3) << 1)) << 2) | (n & 3));
}

// The copies below are cp.async, not committed. Thread j copies chunk j % 16
// of rows j / 16, j / 16 + 32, ...: both swizzles depend on the row only
// through r % 8, so a thread's destinations are 32 rows apart.
constexpr int COPY_STEP = F32_THREADS / 16;   // rows a pass

// Rows r < n of a swizzled f32 tile from src[(r0 + r) * ld], zero where
// r0 + r is outside [0, valid).
__device__ __forceinline__ void copy_rows_f32(const float* __restrict__ src, int ld, int r0,
                                              int n, int valid, float* dst) {
  const int c = threadIdx.x % 16 * 4;
  float* d = dst + swz_f32(threadIdx.x / 16, c);
  for (int r = threadIdx.x / 16; r < n; r += COPY_STEP, d += COPY_STEP * WIDTH) {
    const int gr = r0 + r;
    const bool ok = gr >= 0 && gr < valid;
    asv::cp16(d, src + (ok ? static_cast<size_t>(gr) * ld + c : 0), ok);
  }
}

// W_i (3 WIDTH x WIDTH, row-major) into its swizzled tile.
__device__ __forceinline__ void copy_w_f32(const float* __restrict__ src, float* dst) {
  const int k0 = threadIdx.x / 16, n = threadIdx.x % 16 * 4;
  float* d = dst + swz_w(k0, n);
  const float* s = src + k0 * WIDTH + n;
  for (int k = k0; k < 3 * WIDTH; k += COPY_STEP, d += COPY_STEP * WIDTH, s += COPY_STEP * WIDTH)
    asv::cp16(d, s, true);
}

// One conv of one tile as its jobs see it (local rows l, global r0 + l).
struct ConvF32 {
  const float* u;     // the conv's input rows, swizzled
  const float* wi;    // W_i, swizzled
  const float* prm;   // cb_i; a_i and b_i follow at +pstride and +2 pstride
  float* gn;          // x's next group, turned into the next conv's input in place
  float* ob;          // this utterance's output rows
  int r0, lo, hi, H, R, dil, valid, Tlen, C, pstride, col;
  bool next;          // there is a next conv in this tile
};

// One warp's job of a conv: local rows mb .. mb + 15 (those < hi are kept),
// channels n0 .. n0 + 31; bcol: the lane's B offsets in a row of W_i, one per
// 8-channel tile. Each product a w is a_small w_big + a_big w_small + a_big
// w_big on the tensor cores: the two small terms go to one accumulator and
// a_big w_big to another, added at the end, so the small terms are not
// accumulated at the magnitude of the whole sum. The epilogue runs on the
// accumulators: s = a relu(y + cb) + b, zero outside [0, valid), written to
// the output where the row is the tile's own and added in place to x's next
// group, which becomes the next conv's input.
__device__ __forceinline__ void tf32_job(const ConvF32& cv, int mb, int n0, const int (&bcol)[4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lchunk = 4 * (lane >> 4);
  float acc[4][4] = {}, accs[4][4] = {};
#pragma unroll
  for (int tap = 0; tap < 3; ++tap) {
    // rows past the buffer feed only rows >= hi, which are not kept
    const int ra = min(mb + lrow + (tap - 1) * cv.dil, cv.R - 1);
    const float* wt = cv.wi + (tap * WIDTH + t) * WIDTH;
#pragma unroll
    for (int k0 = 0; k0 < WIDTH; k0 += 8) {
      FragA fa;
      FragB fb[4];
      uint32_t v[4];
      ldsm4<false>(v, reinterpret_cast<const bf16*>(cv.u + swz_f32(ra, k0 + lchunk)));
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__uint_as_float(v[e]), fa.big[e], fa.small[e]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        split(wt[k0 * WIDTH + bcol[nt]], fb[nt].big[0], fb[nt].small[0]);
        split(wt[(k0 + 4) * WIDTH + bcol[nt]], fb[nt].big[1], fb[nt].small[1]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_tf32(accs[nt], fa.small, fb[nt].big);
        mma_tf32(accs[nt], fa.big, fb[nt].small);
        mma_tf32(acc[nt], fa.big, fb[nt].big);
      }
    }
  }
#pragma unroll
  for (int mh = 0; mh < 2; ++mh) {
    const int l = mb + 8 * mh + g, r = cv.r0 + l;   // local and global row
    if (l >= cv.hi) continue;
    const bool in = r >= 0 && r < cv.valid;
    const bool own = l >= cv.H && l < cv.H + TT_F32 && r < cv.Tlen;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = n0 + 8 * nt + 2 * t, e = 2 * mh;
      const float2 kb = *reinterpret_cast<const float2*>(cv.prm + c);
      const float2 ka = *reinterpret_cast<const float2*>(cv.prm + cv.pstride + c);
      const float2 kc = *reinterpret_cast<const float2*>(cv.prm + 2 * cv.pstride + c);
      const float y0 = acc[nt][e] + accs[nt][e], y1 = acc[nt][e + 1] + accs[nt][e + 1];
      const float2 s = in ? make_float2(ka.x * fmaxf(y0 + kb.x, 0.f) + kc.x,
                                        ka.y * fmaxf(y1 + kb.y, 0.f) + kc.y)
                          : make_float2(0.f, 0.f);
      if (own) *reinterpret_cast<float2*>(cv.ob + static_cast<size_t>(r) * cv.C + cv.col + c) = s;
      if (cv.next) {
        float2* p = reinterpret_cast<float2*>(cv.gn + swz_f32(l, c));
        const float2 gv = *p;
        *p = make_float2(gv.x + s.x, gv.y + s.y);
      }
    }
  }
}

// Grid (min(tiles, resident blocks)): block j walks tiles j, j + gridDim.x,
// ... of the B x tiles_t tiles (utterance-major), one conv after another:
// conv q is conv q % layers of its tile q / layers, so the loads of the next
// tile's groups 0 and 1 and W_0 ride under the last two convs of this one.
// Warp w runs jobs w, w + 16, ... of each conv: rows lo + 16 (job / 2),
// channels 32 (job % 2), so its channels, 32 (w % 2) + 8 nt + 2 t + q, stay
// the same.
__global__ void __launch_bounds__(F32_THREADS, 1)
res2_chain_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ cb, const float* __restrict__ ca,
                       const float* __restrict__ cbias, float* __restrict__ out, int Tlen,
                       int valid, int dil, int scale, int tiles_t, int tiles) {
  constexpr int WSZ = 3 * WIDTH * WIDTH;   // one conv's weights
  static_assert(F32_WARPS % 2 == 0, "a warp's jobs keep one channel half");
  extern __shared__ float4 smem4[];
  const int H = (scale - 1) * dil, R = TT_F32 + 2 * H, C = WIDTH * scale;
  const int layers = scale - 1;
  float* ws = reinterpret_cast<float*>(smem4);   // 2 x 3 WIDTH rows: W_q, W_{q+1}
  float* rows = ws + 2 * WSZ;                    // 3 x R rows: u_q, g_{q+1}, g_{q+2}
  float* prm = rows + 3 * R * WIDTH;             // cb, ca, cbias: 3 x layers x WIDTH
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int n0 = 32 * (warp % 2);
  int bcol[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) bcol[nt] = swz_w(t, n0 + 8 * nt + g) - t * WIDTH;
  const int convs = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * layers;
  // x's group of conv q (its input before the previous conv's output is
  // added) into row buffer q % 3.
  auto load_group = [&](int q) {
    const int tile = blockIdx.x + q / layers * gridDim.x;
    const int b = tile / tiles_t, r0 = tile % tiles_t * TT_F32 - H;
    copy_rows_f32(x + static_cast<size_t>(b) * Tlen * C + q % layers * WIDTH, C, r0, R, valid,
                  rows + q % 3 * R * WIDTH);
  };

  load_group(0);
  copy_w_f32(w, ws);
  if (convs > 1) load_group(1);
  asv::cp_commit();
  for (int j = threadIdx.x; j < layers * WIDTH; j += F32_THREADS) {
    prm[j] = cb[j];
    prm[layers * WIDTH + j] = ca[j];
    prm[2 * layers * WIDTH + j] = cbias[j];
  }

  for (int q = 0; q < convs; ++q) {
    const int i = q % layers, tile = blockIdx.x + q / layers * gridDim.x;
    const int b = tile / tiles_t, t0 = tile % tiles_t * TT_F32, r0 = t0 - H;
    const float* xb = x + static_cast<size_t>(b) * Tlen * C;
    float* ob = out + static_cast<size_t>(b) * Tlen * C;
    asv::cp_wait_all();
    __syncthreads();   // u_q, W_q and group q+1 are in; the other buffers are free
    if (q + 1 < convs) {
      copy_w_f32(w + static_cast<size_t>((q + 1) % layers) * WSZ, ws + (q + 1) % 2 * WSZ);
      if (q + 2 < convs) load_group(q + 2);
      asv::cp_commit();
    }
    if (i == 0) {   // pass-through group, zeroed past valid
      for (int j = threadIdx.x; j < TT_F32 * 16; j += F32_THREADS) {
        const int r = t0 + j / 16;
        if (r >= Tlen) break;
        const size_t off = static_cast<size_t>(r) * C + layers * WIDTH + j % 16 * 4;
        *reinterpret_cast<float4*>(ob + off) =
            r < valid ? *reinterpret_cast<const float4*>(xb + off) : make_float4(0, 0, 0, 0);
      }
    }
    const ConvF32 cv{rows + q % 3 * R * WIDTH, ws + q % 2 * WSZ, prm + i * WIDTH,
                     rows + (q + 1) % 3 * R * WIDTH, ob, r0, (i + 1) * dil, R - (i + 1) * dil,
                     H, R, dil, valid, Tlen, C, layers * WIDTH, i * WIDTH, i + 1 < layers};
    const int jobs = 2 * ((cv.hi - cv.lo + 15) / 16);
    for (int job = warp; job < jobs; job += F32_WARPS)
      tf32_job(cv, cv.lo + 16 * (job / 2), n0, bcol);
  }
}

}  // namespace

// x, out (B, T, 64 * scale) and w (scale-1, 192, 64) of one type (code 0:
// f32, 1: bf16), both starting on a 16-byte boundary; cb, ca, cbias
// (scale-1, 64) f32. Returns cudaGetLastError().
extern "C" int res2_chain_forward(const void* x, const void* w, const float* cb,
                                  const float* ca, const float* cbias,
                                  void* out, int B, int Tlen, int valid,
                                  int dil, int scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == asv::kF32) {
    const size_t smem = (2 * 3 * WIDTH * WIDTH + 3 * (TT_F32 + 2 * (scale - 1) * dil) * WIDTH +
                         3 * (scale - 1) * WIDTH) * sizeof(float);
    cudaError_t err = asv::allow_smem(res2_chain_tf32_kernel, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, res2_chain_tf32_kernel,
                                                          F32_THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles_t = (Tlen + TT_F32 - 1) / TT_F32, tiles = B * tiles_t;
    const int grid = per_sm > 0 ? min(tiles, sms * per_sm) : tiles;
    res2_chain_tf32_kernel<<<grid, F32_THREADS, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), cb, ca, cbias,
        static_cast<float*>(out), Tlen, valid, dil, scale, tiles_t, tiles);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == asv::kBF16) {
    const size_t R = TT + 2 * (scale - 1) * dil;
    const size_t smem = (2 * 3 * WIDTH * WIDTH + 3 * R * WIDTH) * sizeof(bf16);
    cudaError_t err = asv::allow_smem(res2_chain_mma_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    res2_chain_mma_kernel<<<dim3((Tlen + TT - 1) / TT, B), THREADS, smem, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), cb, ca, cbias,
        static_cast<bf16*>(out), Tlen, valid, dil, scale);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// f32 (the f32 check and ServingECAPA(dtype=float32); res2_chain_fma_kernel)
// keeps the port's first design: f32 FMAs from shared memory, 4 channels x
// 8 rows a thread, bound by the FMA rate.
//
// Bound: bytes. x in + out, 2 * B * T * 512 elements (98 MB in bf16 at B=64,
// T=750, 0.03 ms at 3.35 TB/s) against 8.3 GFLOP of conv products per
// launch (0.008 ms at the bf16 tensor-core rate).

#include "tensor_core.cuh"

namespace {

constexpr int WIDTH = 64;
constexpr int TT = 96;         // output rows per block (measured against 64 and 128)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int USTRIDE = WIDTH + 1;   // f32 kernel: padded row stride of u

using bf16 = __nv_bfloat16;
using asv::tc::ldsm4;
using asv::tc::mma_bf16;

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

// ---- f32: the first design, FMAs from shared memory ----

__global__ void __launch_bounds__(THREADS)
res2_chain_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ cb, const float* __restrict__ ca,
                      const float* __restrict__ cbias, float* __restrict__ out,
                      int Tlen, int valid, int dil, int scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = (scale - 1) * dil;
  const int R = TT + 2 * H;
  const int C = WIDTH * scale;
  float* ws = smem;                      // 3*WIDTH x WIDTH conv weights
  float* u = ws + 3 * WIDTH * WIDTH;     // R x USTRIDE chain input
  float* s = u + R * USTRIDE;            // R x WIDTH chain output

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int r0 = t0 - H;                 // global row of local row 0
  const float* xb = x + static_cast<size_t>(b) * Tlen * C;
  float* ob = out + static_cast<size_t>(b) * Tlen * C;

  const int cg = tid % 16;               // channels cg + 16 q
  const int rg = tid / 16;               // rows rg * 8 + i of a 128-row pass

  for (int i = 0; i < scale - 1; ++i) {
    // u = g_i + s, zero outside [0, valid); W_i to shared.
    for (int idx = tid; idx < R * WIDTH; idx += THREADS) {
      const int l = idx / WIDTH, c = idx % WIDTH;
      const int r = r0 + l;
      const bool in = r >= 0 && r < valid;
      const float g = in ? xb[static_cast<size_t>(r) * C + i * WIDTH + c] : 0.f;
      u[l * USTRIDE + c] = (i == 0) ? g : g + s[l * WIDTH + c];
    }
    const float* wi = w + static_cast<size_t>(i) * 3 * WIDTH * WIDTH;
    for (int idx = tid; idx < 3 * WIDTH * WIDTH; idx += THREADS) ws[idx] = wi[idx];
    __syncthreads();

    // s = a * relu(conv(u) + cb) + b on local rows [lo, hi).
    const int lo = (i + 1) * dil, hi = R - (i + 1) * dil;
    float bias[4], sa[4], sb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = cg + 16 * q;
      bias[q] = cb[i * WIDTH + o];
      sa[q] = ca[i * WIDTH + o];
      sb[q] = cbias[i * WIDTH + o];
    }
    for (int base = lo; base < hi; base += 128) {
      int rows[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) rows[k] = min(base + rg * 8 + k, hi - 1);
      float acc[8][4];
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[k][q] = 0.f;
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) {
        const int shift = (tap - 1) * dil;
        for (int c = 0; c < WIDTH; ++c) {
          float wv[4], av[8];
#pragma unroll
          for (int q = 0; q < 4; ++q) wv[q] = ws[(tap * WIDTH + c) * WIDTH + cg + 16 * q];
#pragma unroll
          for (int k = 0; k < 8; ++k) av[k] = u[(rows[k] + shift) * USTRIDE + c];
#pragma unroll
          for (int k = 0; k < 8; ++k)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[k][q] = fmaf(av[k], wv[q], acc[k][q]);
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int l = base + rg * 8 + k;
        if (l >= hi) continue;
        const int r = r0 + l;
        const bool in = r >= 0 && r < valid;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v = sa[q] * fmaxf(acc[k][q] + bias[q], 0.f) + sb[q];
          s[l * WIDTH + cg + 16 * q] = in ? v : 0.f;
        }
      }
    }
    __syncthreads();

    // Group i of the tile's own rows.
    for (int idx = tid; idx < TT * WIDTH; idx += THREADS) {
      const int l = H + idx / WIDTH, c = idx % WIDTH;
      const int r = r0 + l;
      if (r < Tlen) ob[static_cast<size_t>(r) * C + i * WIDTH + c] = s[l * WIDTH + c];
    }
  }

  // Pass-through group, zeroed past valid.
  const int last = (scale - 1) * WIDTH;
  for (int idx = tid; idx < TT * WIDTH; idx += THREADS) {
    const int r = t0 + idx / WIDTH, c = idx % WIDTH;
    if (r < Tlen) {
      const size_t off = static_cast<size_t>(r) * C + last + c;
      ob[off] = r < valid ? xb[off] : 0.f;
    }
  }
}

template <typename T, typename K>
cudaError_t launch(K kernel, size_t smem, const void* x, const void* w, const float* cb,
                   const float* ca, const float* cbias, void* out, int B, int Tlen,
                   int valid, int dil, int scale, cudaStream_t stream) {
  cudaError_t err = asv::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Tlen + TT - 1) / TT, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), cb, ca, cbias,
      static_cast<T*>(out), Tlen, valid, dil, scale);
  return cudaGetLastError();
}

}  // namespace

// x, out (B, T, 64 * scale) and w (scale-1, 192, 64) of one type (code 0:
// f32, 1: bf16; in bf16 x and w start on a 16-byte boundary); cb, ca, cbias
// (scale-1, 64) f32. Returns cudaGetLastError().
extern "C" int res2_chain_forward(const void* x, const void* w, const float* cb,
                                  const float* ca, const float* cbias,
                                  void* out, int B, int Tlen, int valid,
                                  int dil, int scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t R = TT + 2 * (scale - 1) * dil;
  if (dtype == asv::kF32)
    return static_cast<int>(launch<float>(
        res2_chain_fma_kernel, (3 * WIDTH * WIDTH + R * USTRIDE + R * WIDTH) * sizeof(float),
        x, w, cb, ca, cbias, out, B, Tlen, valid, dil, scale, st));
  if (dtype == asv::kBF16)
    return static_cast<int>(launch<bf16>(
        res2_chain_mma_kernel, (2 * 3 * WIDTH * WIDTH + 3 * R * WIDTH) * sizeof(bf16), x, w,
        cb, ca, cbias, out, B, Tlen, valid, dil, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

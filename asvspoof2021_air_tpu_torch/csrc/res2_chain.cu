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
// of TT output rows needs (scale-1) * d halo rows each side of the input.
// One block owns one utterance's tile: it keeps the running input u and
// output s of the chain, (TT + 2 H) x 64 each, in shared memory and
// recomputes the halo (H = 7 d; 1.4x the conv work at d = 4), so no
// intermediate leaves the block: x is read once and the output written
// once, as on the TPU. Values are rounded to the I/O type wherever the
// Pallas kernel stores them in that type (sp + g, and the BN output), with
// f32 accumulation and an f32 BN affine.
//
// Bound: bytes. x in + out, 2 * B * T * 512 elements (98 MB in bf16 at B=64,
// T=750, 0.03 ms at 3.35 TB/s) against 8.3 GFLOP of conv products per
// launch (0.008 ms at the bf16 tensor-core rate). This first version does
// the products as f32 FMAs from shared memory (4 channels x 8 rows a thread),
// so it is bound by the FMA rate, not by bytes.

#include "common.cuh"

namespace {

constexpr int WIDTH = 64;
constexpr int TT = 64;         // output rows per block
constexpr int THREADS = 256;
constexpr int USTRIDE = WIDTH + 1;   // padded row stride of u (bank spread)

template <typename T>
__global__ void __launch_bounds__(THREADS)
res2_chain_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ cb, const float* __restrict__ ca,
                  const float* __restrict__ cbias, T* __restrict__ out,
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
  const T* xb = x + static_cast<size_t>(b) * Tlen * C;
  T* ob = out + static_cast<size_t>(b) * Tlen * C;

  const int cg = tid % 16;               // channels cg + 16 q
  const int rg = tid / 16;               // rows rg * 8 + i of a 128-row pass

  for (int i = 0; i < scale - 1; ++i) {
    // u = g_i + s (rounded to T), zero outside [0, valid); W_i to shared.
    for (int idx = tid; idx < R * WIDTH; idx += THREADS) {
      const int l = idx / WIDTH, c = idx % WIDTH;
      const int r = r0 + l;
      const bool in = r >= 0 && r < valid;
      const float g = in ? asv::to_f32<T>(xb[static_cast<size_t>(r) * C + i * WIDTH + c]) : 0.f;
      u[l * USTRIDE + c] = (i == 0) ? g : asv::round_to<T>(g + s[l * WIDTH + c]);
    }
    const T* wi = w + static_cast<size_t>(i) * 3 * WIDTH * WIDTH;
    for (int idx = tid; idx < 3 * WIDTH * WIDTH; idx += THREADS)
      ws[idx] = asv::to_f32<T>(wi[idx]);
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
          s[l * WIDTH + cg + 16 * q] = in ? asv::round_to<T>(v) : 0.f;
        }
      }
    }
    __syncthreads();

    // Group i of the tile's own rows.
    for (int idx = tid; idx < TT * WIDTH; idx += THREADS) {
      const int l = H + idx / WIDTH, c = idx % WIDTH;
      const int r = r0 + l;
      if (r < Tlen)
        ob[static_cast<size_t>(r) * C + i * WIDTH + c] = asv::from_f32<T>(s[l * WIDTH + c]);
    }
  }

  // Pass-through group, zeroed past valid.
  const int last = (scale - 1) * WIDTH;
  for (int idx = tid; idx < TT * WIDTH; idx += THREADS) {
    const int r = t0 + idx / WIDTH, c = idx % WIDTH;
    if (r < Tlen) {
      const size_t off = static_cast<size_t>(r) * C + last + c;
      ob[off] = r < valid ? xb[off] : asv::from_f32<T>(0.f);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* cb,
                   const float* ca, const float* cbias, void* out, int B,
                   int Tlen, int valid, int dil, int scale,
                   cudaStream_t stream) {
  const int R = TT + 2 * (scale - 1) * dil;
  const size_t smem =
      (3 * WIDTH * WIDTH + static_cast<size_t>(R) * USTRIDE + static_cast<size_t>(R) * WIDTH) *
      sizeof(float);
  cudaError_t err = asv::allow_smem(res2_chain_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tlen + TT - 1) / TT, B);
  res2_chain_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), cb, ca, cbias,
      static_cast<T*>(out), Tlen, valid, dil, scale);
  return cudaGetLastError();
}

}  // namespace

// x, out (B, T, 64 * scale) and w (scale-1, 192, 64) of one type (code 0:
// f32, 1: bf16); cb, ca, cbias (scale-1, 64) f32. Returns cudaGetLastError().
extern "C" int res2_chain_forward(const void* x, const void* w, const float* cb,
                                  const float* ca, const float* cbias,
                                  void* out, int B, int Tlen, int valid,
                                  int dil, int scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == asv::kF32)
    return static_cast<int>(launch<float>(x, w, cb, ca, cbias, out, B, Tlen,
                                          valid, dil, scale, st));
  if (dtype == asv::kBF16)
    return static_cast<int>(launch<__nv_bfloat16>(x, w, cb, ca, cbias, out, B,
                                                  Tlen, valid, dil, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

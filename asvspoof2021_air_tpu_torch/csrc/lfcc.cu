// B1: fused LFCC of one tile of frames, for any hop with win == 2 * hop.
//
// Replaces the JAX package's Pallas kernels _lfcc_lane128_kernel
// (ops/lfcc_pallas.py:98) and _lfcc_kernel (ops/lfcc_pallas.py:45): one
// function, whose lane-128 and hop-row layouts were TPU tiling choices.
//
// Per block: TT consecutive frames of one utterance. Their samples overlap
// (frame t starts at t * hop + start), so the block stages one strip of
// (TT - 1) * hop + win samples in shared memory and reads every frame from
// it. The windowed DFT is one full-f32 FMA product (TT x win) @ (win x 512)
// against [cos | sin], streamed through shared memory KC rows at a time;
// then re^2 + im^2, the (256 x nf) filterbank, log10 and the (nf x nf) DCT,
// and only (TT, nf) leaves the block.
//
// Bound: the function is bound by its bytes, the (B, L) waveform read and
// the (B, T, 20) write (35 MB at B=64, L=119840: about 0.01 ms at
// 3.35 TB/s). A real FFT of n_fft=512 needs about 12k flops a frame, no
// more time than the bytes take. This design does not get near that bound:
// its direct DFT costs 2 * B * T * win * 512 f32 FMA flops (15.7 GFLOP, about
// 0.23 ms at 67 TFLOP/s of non-tensor f32), some 28x the FFT's work. An FFT
// in the block is the way to the bound. The DFT stays f32: the front-end's
// bar (atol 5e-4 after log10) rules out TF32 or bf16 products. Each thread
// holds an 8 x 8 register tile (8 frames x 8 columns, 64 FMAs per 16
// shared-memory loads, the frame values broadcast across the warp).

#include "common.cuh"

namespace {

constexpr int TT = 32;         // frames per block
constexpr int NC = 512;        // DFT columns: re [0, 256) | im [256, 512)
constexpr int NBIN = NC / 2;
constexpr int KC = 16;         // DFT rows staged per step
constexpr int THREADS = 256;
constexpr float INV_LN10 = 0.43429448190325176f;
constexpr float F32_EPS = 1.1920928955078125e-07f;

__host__ __device__ inline int strip_floats(int hop, int win) {
  return (((TT - 1) * hop + win) + 3) / 4 * 4;
}

__global__ void __launch_bounds__(THREADS)
lfcc_kernel(const float* __restrict__ x, int L, int T, int hop, int win,
            int start, const float* __restrict__ cs,
            const float* __restrict__ fb, const float* __restrict__ dct,
            int nf, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_strip = strip_floats(hop, win);
  float* strip = smem;                 // frame samples
  float* csb = smem + n_strip;         // KC x NC chunk, later TT x NBIN power
  float* fbl = csb + KC * NC;          // TT x nf log filterbank energies

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const float* xb = x + static_cast<size_t>(b) * L;
  const int s0 = t0 * hop + start;
  for (int s = tid; s < n_strip; s += THREADS) {
    const int g = s0 + s;
    strip[s] = (g >= 0 && g < L) ? xb[g] : 0.f;
  }

  const int tx = tid % 64;   // columns tx + 64 * j
  const int ty = tid / 64;   // frames ty * 8 + i
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const float* frame0 = strip + (ty * 8) * hop;
  for (int k0 = 0; k0 < win; k0 += KC) {
    __syncthreads();
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < KC * NC / 4; i += THREADS) {
      const int kr = i / (NC / 4);
      const int c4 = i % (NC / 4);
      reinterpret_cast<float4*>(csb)[i] =
          (k0 + kr < win)
              ? reinterpret_cast<const float4*>(cs + static_cast<size_t>(k0 + kr) * NC)[c4]
              : zero4;
    }
    __syncthreads();
    const int kmax = min(KC, win - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float a[8], w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = frame0[i * hop + k0 + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = csb[kk * NC + tx + 64 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
  __syncthreads();

  // Columns tx + 64 j (j < 4) are the real parts of bins tx + 64 j, and
  // columns tx + 64 (j + 4) their imaginary parts.
  float* pw = csb;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float re = acc[i][j], im = acc[i][j + 4];
      pw[(ty * 8 + i) * NBIN + tx + 64 * j] = re * re + im * im;
    }
  __syncthreads();

  for (int idx = tid; idx < TT * nf; idx += THREADS) {
    const int r = idx / nf, f = idx % nf;
    const float* p = pw + r * NBIN;
    float s = 0.f;
    for (int k = 0; k < NBIN; ++k) s = fmaf(p[k], fb[k * nf + f], s);
    fbl[idx] = logf(s + F32_EPS) * INV_LN10;
  }
  __syncthreads();

  for (int idx = tid; idx < TT * nf; idx += THREADS) {
    const int r = idx / nf, g = idx % nf;
    const int t = t0 + r;
    if (t >= T) continue;
    float s = 0.f;
    for (int f = 0; f < nf; ++f) s = fmaf(fbl[r * nf + f], dct[f * nf + g], s);
    out[(static_cast<size_t>(b) * T + t) * nf + g] = s;
  }
}

}  // namespace

// x (B, L) f32 pre-emphasized; cs (win, 512) f32 = [cos | sin] with bins
// past n_fft/2 zero; fb (256, nf) f32 with the same rows zero; dct (nf, nf);
// out (B, T, nf) f32. Returns cudaGetLastError() after the launch.
extern "C" int lfcc_forward(const float* x, int B, int L, int T, int hop,
                            int win, int start, const float* cs,
                            const float* fb, const float* dct, int nf,
                            float* out, void* stream) {
  if (nf > 64 || win != 2 * hop) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (static_cast<size_t>(strip_floats(hop, win)) + KC * NC + TT * nf) * sizeof(float);
  cudaError_t err = asv::allow_smem(lfcc_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + TT - 1) / TT, B);
  lfcc_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, L, T, hop, win, start, cs, fb, dct, nf, out);
  return static_cast<int>(cudaGetLastError());
}

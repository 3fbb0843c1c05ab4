// B1: fused LFCC of one tile of frames, for any hop with win == 2 * hop and
// a power-of-two n_fft with win <= n_fft <= 512.
//
// Replaces the JAX package's Pallas kernels _lfcc_lane128_kernel
// (ops/lfcc_pallas.py:98) and _lfcc_kernel (ops/lfcc_pallas.py:45): one
// function, whose lane-128 and hop-row layouts were TPU tiling choices.
//
// Per block: TT consecutive frames of one utterance. Their samples overlap
// (frame t starts at t * hop + start), so the block stages one strip of
// (TT - 1) * hop + win samples in shared memory with cp.async and reads
// every frame from it. Each frame is its windowed win samples at offset
// (n_fft - win) / 2 in a zero frame of n_fft, as dsp.windowed_dft_matrices
// defines it, and gets its own real FFT: its even and odd samples are the
// real and imaginary parts of an M = n_fft / 2 point complex signal z, and
// G = M / P lanes of one warp transform it, P = 8 points a lane (M = 256:
// one frame a warp). The complex FFT is a Stockham FFT (natural order in and
// out, no bit reversal): pass 0 takes z[g + G j], j < P, into lane g's
// registers for a P-point DFT; each further pass of span NS and radix R
// (8, 8 and 4 at M = 256) reads R points z[j + r M / R] from the warp's row
// in shared memory, twiddles them by W_(NS R)^((j mod NS) r), takes an
// R-point DFT in registers and writes z[(j / NS) NS R + j mod NS + r NS].
// The row is swizzled so that every pass is free of bank conflicts. The
// bins follow by the real-FFT post-twiddle
//   X[k] = E + w^k O,  X[M - k] = conj(E - w^k O),  w = W_n_fft,
//   E = (Z[k] + conj Z[M - k]) / 2,  O = -i (Z[k] - conj Z[M - k]) / 2.
// Every twiddle comes from one table of w^k, k < M, computed on the host in
// float64; each lane keeps the few its passes need in registers, and the
// block keeps the table, the filterbank and the DCT in shared memory. Then
// |X|^2, the filterbank (each filter summed over its nonzero bins only, from
// a compact (width, nf) table), log10 and the (nf x nf) DCT; only (TT, nf)
// leaves the block. Frames are never packed two to a complex transform:
// each frame's rounding then scales with its own norm, and an all-zero frame
// gives exactly 0 (log10(eps)), as in the plain version.
//
// Bound: bytes and operations bound the function about equally at B = 64,
// L = 119840: the waveform read and the (B, T, 20) write are 34.5 MB,
// 0.0103 ms at 3.35 TB/s; the FFT (2.5 n log2 n a frame), the window, the
// power, the filterbank's nonzero weights, log10 and the DCT are 0.69 GFLOP,
// 0.0103 ms at the f32 rate. The transform stays f32: the front-end's bar
// (atol 5e-4 after log10) rules out lower precision.

#include "common.cuh"

namespace {

constexpr int TT = 64;          // frames per block
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr float INV_LN10 = 0.43429448190325176f;
constexpr float F32_EPS = 1.1920928955078125e-07f;

// The FFT's layout for M = n_fft / 2 points: P points a lane, G lanes a
// frame, FPW frames a warp. The transform is a Stockham FFT: pass 0 of radix
// P in registers, then passes of radix 8 (the last one 4 or 2) through a
// warp's own row of M points in shared memory. zidx() swizzles the row
// (bits 0-3 of a point's index XOR bits 3-6), which puts every pass's loads
// and stores, and the post-twiddle's reads, on 16 distinct 8-byte bank pairs
// per half-warp for M >= 128; it is a permutation of [0, M) for every M.
template <int M> struct Fft {
  static constexpr int P = M < 8 ? M : 8;
  static constexpr int G = M / P;
  static constexpr int FPW = 32 / G;
  static constexpr int R1 = M / P < 8 ? M / P : 8;        // pass 1's radix
  static constexpr int R2 = M / (P * R1) < 8 ? M / (P * R1) : 8;   // pass 2's
  static_assert(P * R1 * R2 == M, "three passes cover M <= 512");
  static __device__ __forceinline__ int zidx(int k) { return k ^ ((k >> 3) & 15); }
};

__host__ __device__ constexpr int ilog2(int v) { return v > 1 ? 1 + ilog2(v / 2) : 0; }

__host__ __device__ inline int strip_floats(int hop, int win) {
  return (((TT - 1) * hop + win) + 3) / 4 * 4;
}

// The block's copy of the tables, in 4-byte words, rounded to 16 bytes:
// M twiddles, the (width, nf) filterbank weights, the (nf, nf) DCT and the
// (nf, 2) bands.
__host__ __device__ inline int table_floats(int M, int width, int nf) {
  return (2 * M + width * nf + nf * nf + 2 * nf + 3) / 4 * 4;
}

// 4-byte copy global -> shared that fills a zero where !valid.
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// w^q = exp(-2 pi i q / n_fft) for q < n_fft, from the half table tw (q < M).
template <int M>
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw, int q) {
  const float2 v = __ldg(tw + (q < M ? q : q - M));
  return q < M ? v : make_float2(-v.x, -v.y);
}

template <int BITS>
__device__ __forceinline__ int bitrev(int v) {
  return BITS ? static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - BITS)) : 0;
}

// R-point DFT of v in registers, natural order in and out: radix-2
// decimation in frequency, then the bit-reversal permutation. w8[e] = W_8^e.
template <int R>
__device__ __forceinline__ void dft(float2* v, const float2* w8) {
#pragma unroll
  for (int h = R / 2; h >= 1; h /= 2)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j & h) continue;
      const float2 a = v[j], c = v[j + h];
      v[j] = make_float2(a.x + c.x, a.y + c.y);
      const float2 d = make_float2(a.x - c.x, a.y - c.y);
      const int e = (j & (h - 1)) * (4 / h);   // W_2h^(j mod h) = W_8^e
      v[j + h] = e ? cmul(d, w8[e]) : d;
    }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int k = bitrev<ilog2(R)>(j);
    if (j < k) {
      const float2 s = v[j];
      v[j] = v[k];
      v[k] = s;
    }
  }
}

// The twiddles of this lane's butterflies j = g + G q in the Stockham pass
// of span NS and radix R: pw[q R + r] = W_(NS R)^((j mod NS) r), r >= 1.
template <int M, int NS, int R>
__device__ __forceinline__ void pass_twiddles(const float2* __restrict__ tw, int g,
                                              float2 (&pw)[8]) {
  constexpr int G = Fft<M>::G;
#pragma unroll
  for (int q = 0; q < 8 / R; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r)
      pw[q * R + r] = twiddle<M>(tw, ((g + G * q) % NS) * r * (2 * M / (NS * R)));
}

// One Stockham pass of span NS and radix R over the frame's row z, for this
// lane's butterflies j = g + G q (q < 8 / R): the R points z[j + r M / R],
// times W_(NS R)^((j mod NS) r), through an R-point DFT, to
// z[(j / NS) NS R + j mod NS + r NS]. The row is read whole before it is
// written.
template <int M, int NS, int R>
__device__ __forceinline__ void pass(float2* z, int g, const float2 (&pw)[8],
                                     const float2* w8) {
  using F = Fft<M>;
  constexpr int NB = 8 / R;
  float2 v[8];
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) v[q * R + r] = z[F::zidx(g + F::G * q + r * (M / R))];
  __syncwarp();
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    float2* u = v + q * R;
#pragma unroll
    for (int r = 1; r < R; ++r) u[r] = cmul(u[r], pw[q * R + r]);
    dft<R>(u, w8);
    const int j = g + F::G * q;
    const int base = (j / NS) * NS * R + j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) z[F::zidx(base + r * NS)] = u[r];
  }
  __syncwarp();
}

template <int M>
__global__ void __launch_bounds__(THREADS)
lfcc_kernel(const float* __restrict__ x, int L, int T, int hop, int win,
            int start, const float* __restrict__ window,
            const float2* __restrict__ tw, const float* __restrict__ fbw,
            int width, const int* __restrict__ bands,
            const float* __restrict__ dct, int nf, float* __restrict__ out) {
  using F = Fft<M>;
  constexpr int P = F::P, G = F::G, FPW = F::FPW, R1 = F::R1, R2 = F::R2;
  extern __shared__ float4 smem4[];
  const int n_strip = strip_floats(hop, win);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int grp = lane / G, g = lane % G;
  // Shared memory: the strip, the tables (twiddles, filterbank weights, DCT,
  // bands), then each warp's Z rows, powers and logs.
  float* strip = reinterpret_cast<float*>(smem4);
  float2* tws = reinterpret_cast<float2*>(strip + n_strip);
  float* fbs = reinterpret_cast<float*>(tws + M);
  float* dcts = fbs + width * nf;
  int* bds = reinterpret_cast<int*>(dcts + nf * nf);
  float2* zs_all = reinterpret_cast<float2*>(strip + n_strip + table_floats(M, width, nf));
  float* ps_all = reinterpret_cast<float*>(zs_all + NWARPS * FPW * M);
  float* ls_all = ps_all + NWARPS * FPW * M;
  float2* zs = zs_all + warp * FPW * M;
  float* ps = ps_all + warp * FPW * M;
  float* ls = ls_all + warp * FPW * nf;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const float* xb = x + static_cast<size_t>(b) * L;
  const int s0 = t0 * hop + start;
  for (int s = threadIdx.x; s < n_strip; s += THREADS) {
    const int gi = s0 + s;
    const bool ok = gi >= 0 && gi < L;
    cp4(strip + s, xb + (ok ? gi : 0), ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = threadIdx.x; i < M; i += THREADS) tws[i] = __ldg(tw + i);
  for (int i = threadIdx.x; i < width * nf; i += THREADS) fbs[i] = __ldg(fbw + i);
  for (int i = threadIdx.x; i < nf * nf; i += THREADS) dcts[i] = __ldg(dct + i);
  for (int i = threadIdx.x; i < 2 * nf; i += THREADS) bds[i] = __ldg(bands + i);

  // This lane's constants, read while the strip arrives: its samples'
  // positions in the frame and window weights (sample 2 (g + G j) + e sits
  // at p = that - (n_fft - win) / 2 of the window, zero outside [0, win)),
  // and its twiddles.
  const int base = 2 * g - (2 * M - win) / 2;
  float wv[P][2];
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = base + 2 * G * j + e;
      wv[j][e] = static_cast<unsigned>(p) < static_cast<unsigned>(win) ? __ldg(window + p) : 0.f;
    }
  float2 w8[4];   // W_8^e; only W_8^0 = 1 is used when M < 4
#pragma unroll
  for (int e = 0; e < 4; ++e) w8[e] = twiddle<M>(tw, e * (2 * M / 8));
  float2 pw1[8], pw2[8];
  if constexpr (R1 > 1) pass_twiddles<M, P, R1>(tw, g, pw1);
  if constexpr (R2 > 1) pass_twiddles<M, P * R1, R2>(tw, g, pw2);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // With hop and the frame's offset even (every configuration of the repo),
  // a lane's two samples are one aligned 8-byte load.
  const bool pairs = ((hop | (2 * M - win) / 2) & 1) == 0;
  for (int rb = warp * FPW; rb < TT && t0 + rb < T; rb += NWARPS * FPW) {
    const int r = rb + grp;
    const bool live = r < TT;
    const float* fr = strip + (live ? r * hop : 0);
    float2* z = zs + grp * M;
    float2 v[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int p = base + 2 * G * j;
      const bool ok0 = live && static_cast<unsigned>(p) < static_cast<unsigned>(win);
      const bool ok1 = live && static_cast<unsigned>(p + 1) < static_cast<unsigned>(win);
      if (pairs) {
        const float2 s2 = ok0 ? *reinterpret_cast<const float2*>(fr + p) : make_float2(0.f, 0.f);
        v[j] = make_float2(wv[j][0] * s2.x, wv[j][1] * s2.y);
      } else {
        v[j] = make_float2(ok0 ? wv[j][0] * fr[p] : 0.f, ok1 ? wv[j][1] * fr[p + 1] : 0.f);
      }
    }
    // Pass 0: the P-point DFT over j of z[g + G j], to z[g P + r].
    dft<P>(v, w8);
#pragma unroll
    for (int r2 = 0; r2 < P; ++r2) z[F::zidx(g * P + r2)] = v[r2];
    __syncwarp();
    if constexpr (R1 > 1) pass<M, P, R1>(z, g, pw1, w8);
    if constexpr (R2 > 1) pass<M, P * R1, R2>(z, g, pw2, w8);

    // Post-twiddle: the lane of (frame, k), k <= M / 2, writes the powers of
    // bins k and M - k. Bin M (Nyquist) is not kept: its filter weight is 0.
    for (int i = lane; i < FPW * (M / 2 + 1); i += 32) {
      const int rl = i / (M / 2 + 1), k = i % (M / 2 + 1);
      const float2 a = zs[rl * M + F::zidx(k)];
      const float2 c = zs[rl * M + F::zidx((M - k) & (M - 1))];
      const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
      const float2 o = make_float2(0.5f * (a.y + c.y), -0.5f * (a.x - c.x));
      const float2 wo = cmul(tws[k], o);
      const float p1x = e.x + wo.x, p1y = e.y + wo.y;
      const float p2x = e.x - wo.x, p2y = e.y - wo.y;
      ps[rl * M + k] = p1x * p1x + p1y * p1y;
      if (k != 0 && k != M / 2) ps[rl * M + M - k] = p2x * p2x + p2y * p2y;
    }
    __syncwarp();

    // Filterbank over each filter's nonzero bins [lo, hi), log10; then the
    // DCT. Frames past the block's or the utterance's end are not written.
    for (int rl = 0; rl < FPW; ++rl)
      for (int f = lane; f < nf; f += 32) {
        const int lo = bds[2 * f], hi = bds[2 * f + 1];
        const float* p = ps + rl * M + lo;
        float s = 0.f;
        for (int k = 0; k < hi - lo; ++k) s = fmaf(p[k], fbs[k * nf + f], s);
        ls[rl * nf + f] = logf(s + F32_EPS) * INV_LN10;
      }
    __syncwarp();
    for (int rl = 0; rl < FPW; ++rl) {
      const int t = t0 + rb + rl;
      if (rb + rl >= TT || t >= T) break;
      for (int q = lane; q < nf; q += 32) {
        float s = 0.f;
        for (int f = 0; f < nf; ++f) s = fmaf(ls[rl * nf + f], dcts[f * nf + q], s);
        out[(static_cast<size_t>(b) * T + t) * nf + q] = s;
      }
    }
    __syncwarp();   // zs, ps and ls are free for the warp's next frames
  }
}

template <int M>
int launch(const float* x, int B, int L, int T, int hop, int win, int start,
           const float* window, const float* tw, const float* fbw, int width,
           const int* bands, const float* dct, int nf, float* out,
           cudaStream_t st) {
  using F = Fft<M>;
  const size_t smem =
      static_cast<size_t>(strip_floats(hop, win) + table_floats(M, width, nf)) * sizeof(float) +
      static_cast<size_t>(NWARPS) * F::FPW *
          (M * sizeof(float2) + (M + nf) * sizeof(float));
  cudaError_t err = asv::allow_smem(lfcc_kernel<M>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + TT - 1) / TT, B);
  lfcc_kernel<M><<<grid, THREADS, smem, st>>>(
      x, L, T, hop, win, start, window, reinterpret_cast<const float2*>(tw),
      fbw, width, bands, dct, nf, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, L) f32 pre-emphasized; window (win,) f32; tw (n_fft / 2) complex
// f32, tw[k] = exp(-2 pi i k / n_fft); bands (nf, 2) int32, each filter's
// nonzero bins [lo, hi) within [0, n_fft / 2), hi - lo <= width; fbw
// (width, nf) f32, fbw[i, f] = the filterbank's weight of bin lo_f + i in
// filter f; dct (nf, nf); out (B, T, nf) f32. Returns cudaGetLastError()
// after the launch.
extern "C" int lfcc_forward(const float* x, int B, int L, int T, int hop,
                            int win, int start, const float* window,
                            const float* tw, int n_fft, const float* fbw,
                            int width, const int* bands, const float* dct,
                            int nf, float* out, void* stream) {
  if (nf < 1 || nf > 64 || win != 2 * hop || win > n_fft || width < 1 ||
      width > n_fft / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ASV_LFCC(N)                                                          \
  case N:                                                                    \
    return launch<N / 2>(x, B, L, T, hop, win, start, window, tw, fbw,       \
                         width, bands, dct, nf, out, st);
  switch (n_fft) {
    ASV_LFCC(4) ASV_LFCC(8) ASV_LFCC(16) ASV_LFCC(32) ASV_LFCC(64)
    ASV_LFCC(128) ASV_LFCC(256) ASV_LFCC(512)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ASV_LFCC
}

// BN-bwd: the backward of the port's train-mode BatchNorm(-activation) rule,
// ops/bn_relu_vjp.py BNTrainVJP.backward, on CUDA tensors.
//
// It replaces no TPU kernel: the JAX package's ops/bn_relu_vjp.py rules
// (relu_bn_train, bn_relu_train, bn_leaky_relu_train, bn_train) are plain jnp
// that XLA fuses. In PyTorch the same backward ran as some eleven f32 passes
// over the activation (relu, centring, xhat, the cast of gy, the mask, two
// sums, dxhat, two means, three terms of dr, the last mask, the cast back).
//
// Per channel c over its N elements, r = relu(x) (relu_bn) or x, d = r - mu,
// g = gy masked by the activation after the BN (bn_relu: z > 0; bn_leaky_relu:
// slope where z < 0) with z = d * a + bias, a = rsqrt(var + eps) * scale, the
// forward's own expression rounded step by step as the forward rounds it, so
// the mask is the one the forward applied:
//   S1 = sum g (= dbeta),  S2 = sum g d (dgamma = inv S2)
//   dr = A g + B d + C,  A = inv scale,  B = 2 gvar / N - inv^2 m2,
//   C = gmu / N - inv m1,  m1 = scale S1 / N,  m2 = scale inv S2 / N
//   dx = dr [x > 0] (relu_bn), else dr, in x's type.
// B multiplies the centred d rather than r, so no large B mu cancels against
// B r where |mu| is large against the channel's spread. The (mu, var)
// cotangents gmu, gvar (zero where the caller passes null) keep it a VJP.
//
// Two passes, each one read of x and gy per element in their stored type
// (f32 or bf16), every sum and coefficient in f32:
//   1. bn_bwd_reduce: blocks over (split, channel) write (S1, S2) partials,
//      (2, splits, C) f32. No atomics: a warp sums its lanes by a fixed
//      shuffle tree, a block its warps in order, so a replay gives the same
//      partials bit for bit.
//   2. bn_bwd_apply: each block sums its channel's partials in a fixed order
//      (every block of a channel gets the same sums), folds them into
//      (A, B, C), and writes dx with two FMAs and the masks per element; the
//      first split writes dgamma and dbeta. With a process group the caller
//      sums the partials in the same order (bn_bwd_sums), all-reduces the
//      sums and hands them in as one split, so on one rank the group's
//      gradients are bitwise the ones without it.
// Two layouts: channel dim over a contiguous inner extent (ECAPA's (B, C, T),
// NCHW), where a block's warps walk pieces of rows of one channel with
// coalesced vector loads of 1, 2 or 4 elements; and channels last (inner
// extent 1: ECAPA's attention BN on (B, T, 128)), where a lane owns 1 or 2
// channels and the warps walk rows.
//
// Bound: bytes. Each pass reads x and gy once and the apply writes dx once:
// 10 bytes an element in bf16 (2 + 2, 2 + 2 + 2), 20 in f32; the per-channel
// vectors and partials are a few KB. At the training cells' shapes (bf16)
// that is about 2.4 GB a step for ECAPA-TDNN-512 (243 M BN elements), 0.73 ms
// at 3.35 TB/s, and 4.5 GB for ResNet18 (450 M), 1.35 ms. The grid splits
// each channel across enough blocks to fill the SMs even at C = 16 (the
// ResNet18 stem, 864 K elements a channel) and C = 64 (ECAPA's chain BNs),
// and a piece of a row is at most 512 vectors, so short rows (282 elements at
// ResNet18's layer4) still give every warp whole rows.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;               // ops/bn_relu_vjp.py WARPS
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;              // vector loads in flight a lane
enum Mode { kReluBn = 0, kBnRelu = 1, kBnLeaky = 2, kBn = 3 };

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// d = r - mu and the masked gradient g of one element.
__device__ __forceinline__ void point(int mode, float xv, float gv, float mu,
                                      float a, float b, float slope, float& d,
                                      float& g) {
  const float r = (mode == kReluBn) ? (xv > 0.f ? xv : 0.f) : xv;
  d = __fsub_rn(r, mu);
  g = gv;
  if (mode == kBnRelu || mode == kBnLeaky) {
    const float z = __fadd_rn(__fmul_rn(d, a), b);
    if (mode == kBnRelu) g = z > 0.f ? gv : 0.f;
    else g = z >= 0.f ? gv : __fmul_rn(slope, gv);
  }
}

struct Coefs {
  float A, B, C;
};

__device__ __forceinline__ Coefs coefs(float s1, float s2, float inv,
                                       float scale, float a, float gm,
                                       float gv, float n) {
  const float m1 = scale * s1 / n;
  const float m2 = scale * inv * s2 / n;
  return {a, 2.f * gv / n - inv * inv * m2, gm / n - inv * m1};
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
}

// Channel c's nsum partials of part (2, nsum, C) summed by one warp in a
// fixed order, lane-strided then the shuffle tree: (S1, S2) in lane 0. Every
// kernel that sums partials does it so, so the sums a process group
// all-reduces between the passes are, on one rank, the apply's own.
__device__ __forceinline__ void channel_sums(const float* __restrict__ part,
                                             int nsum, int C, int c, int lane,
                                             float& t1, float& t2) {
  t1 = t2 = 0.f;
  for (int j = lane; j < nsum; j += 32) {
    t1 += part[static_cast<size_t>(j) * C + c];
    t2 += part[(static_cast<size_t>(nsum) + j) * C + c];
  }
  warp_sum2(t1, t2);
}

// ---- channel dim over a contiguous inner extent: x is (outer, C, inner) ----
// An item is one piece of one row (o, c, .); a channel's items are its outer
// rows times `pieces`, and block (k, c) takes items [k per_block, (k + 1)
// per_block), warp w every kWarps-th of them from w.

template <typename T, int V, bool kApply>
__device__ __forceinline__ void walk_rows(
    const T* __restrict__ x, const T* __restrict__ gy, T* __restrict__ dx,
    int C, int inner, int items, int pieces, int per_block, int mode,
    float slope, float mu, float a, float b, Coefs f, float& s1, float& s2) {
  using VT = Vec<T, V>;
  const int k = blockIdx.x, c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sv = inner / V, lv = (sv + pieces - 1) / pieces;
  const int i1 = min(items, (k + 1) * per_block);
  for (int i = k * per_block + warp; i < i1; i += kWarps) {
    const int o = i / pieces, p = i - o * pieces;
    const int v0 = p * lv, v1 = min(sv, v0 + lv);
    const size_t base = (static_cast<size_t>(o) * C + c) * inner;
    const VT* xr = reinterpret_cast<const VT*>(x + base);
    const VT* gr = reinterpret_cast<const VT*>(gy + base);
    for (int v = v0 + lane; v < v1; v += 32 * kUnroll) {
      VT xb[kUnroll], gb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (v + 32 * u < v1) {
          xb[u] = xr[v + 32 * u];
          gb[u] = gr[v + 32 * u];
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (v + 32 * u >= v1) continue;
        VT ob;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xv = asv::to_f32(xb[u].v[j]);
          float d, g;
          point(mode, xv, asv::to_f32(gb[u].v[j]), mu, a, b, slope, d, g);
          if (kApply) {
            float dr = fmaf(f.A, g, fmaf(f.B, d, f.C));
            if (mode == kReluBn && !(xv > 0.f)) dr = 0.f;
            ob.v[j] = from_f32<T>(dr);
          } else {
            s1 += g;
            s2 = fmaf(g, d, s2);
          }
        }
        if (kApply) reinterpret_cast<VT*>(dx + base)[v + 32 * u] = ob;
      }
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) reduce_rows(
    const T* __restrict__ x, const T* __restrict__ gy,
    const float* __restrict__ mu, const float* __restrict__ a,
    const float* __restrict__ bias, int C, int inner, int items, int pieces,
    int per_block, int mode, float slope, float* __restrict__ part) {
  const int k = blockIdx.x, c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s1 = 0.f, s2 = 0.f;
  walk_rows<T, V, false>(x, gy, nullptr, C, inner, items, pieces, per_block,
                         mode, slope, mu[c], a[c], bias[c], Coefs{}, s1, s2);
  warp_sum2(s1, s2);
  __shared__ float sh[2][kWarps];
  if (lane == 0) {
    sh[0][warp] = s1;
    sh[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      t1 += sh[0][w];
      t2 += sh[1][w];
    }
    part[static_cast<size_t>(k) * C + c] = t1;
    part[(static_cast<size_t>(gridDim.x) + k) * C + c] = t2;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) apply_rows(
    const T* __restrict__ x, const T* __restrict__ gy,
    const float* __restrict__ mu, const float* __restrict__ inv,
    const float* __restrict__ scale, const float* __restrict__ a,
    const float* __restrict__ bias, const float* __restrict__ part, int nsum,
    const float* __restrict__ gmu, const float* __restrict__ gvar, float n,
    int C, int inner, int items, int pieces, int per_block, int mode,
    float slope, T* __restrict__ dx, float* __restrict__ dgamma,
    float* __restrict__ dbeta) {
  const int k = blockIdx.x, c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ Coefs sf;
  if (warp == 0) {
    float t1, t2;
    channel_sums(part, nsum, C, c, lane, t1, t2);
    if (lane == 0) {
      sf = coefs(t1, t2, inv[c], scale[c], a[c], gmu ? gmu[c] : 0.f,
                 gvar ? gvar[c] : 0.f, n);
      if (k == 0 && dgamma != nullptr) {
        dgamma[c] = inv[c] * t2;
        dbeta[c] = t1;
      }
    }
  }
  __syncthreads();
  float s1 = 0.f, s2 = 0.f;
  walk_rows<T, V, true>(x, gy, dx, C, inner, items, pieces, per_block, mode,
                        slope, mu[c], a[c], bias[c], sf, s1, s2);
}

// ---- channels last: x is (R, C) ----
// Block (k, t) takes rows [k per_block, (k + 1) per_block) of the channel
// tile t (32 V channels, lane l owning V of them), warp w every kWarps-th
// row from w.

template <typename T, int V, bool kApply>
__device__ __forceinline__ void walk_cols(
    const T* __restrict__ x, const T* __restrict__ gy, T* __restrict__ dx,
    int R, int C, int per_block, int mode, float slope, const float* mu,
    const float* a, const float* b, const Coefs* f, float* s1, float* s2) {
  using VT = Vec<T, V>;
  const int k = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = (blockIdx.y * 32 + lane) * V;
  if (c0 >= C) return;
  const int r1 = min(R, (k + 1) * per_block);
  for (int r = k * per_block + warp; r < r1; r += kWarps * kUnroll) {
    VT xb[kUnroll], gb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + kWarps * u;
      if (rr < r1) {
        const size_t at = static_cast<size_t>(rr) * C + c0;
        xb[u] = *reinterpret_cast<const VT*>(x + at);
        gb[u] = *reinterpret_cast<const VT*>(gy + at);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + kWarps * u;
      if (rr >= r1) continue;
      VT ob;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xv = asv::to_f32(xb[u].v[j]);
        float d, g;
        point(mode, xv, asv::to_f32(gb[u].v[j]), mu[j], a[j], b[j], slope, d,
              g);
        if (kApply) {
          float dr = fmaf(f[j].A, g, fmaf(f[j].B, d, f[j].C));
          if (mode == kReluBn && !(xv > 0.f)) dr = 0.f;
          ob.v[j] = from_f32<T>(dr);
        } else {
          s1[j] += g;
          s2[j] = fmaf(g, d, s2[j]);
        }
      }
      if (kApply)
        *reinterpret_cast<VT*>(dx + static_cast<size_t>(rr) * C + c0) = ob;
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) reduce_cols(
    const T* __restrict__ x, const T* __restrict__ gy,
    const float* __restrict__ mu, const float* __restrict__ a,
    const float* __restrict__ bias, int R, int C, int per_block, int mode,
    float slope, float* __restrict__ part) {
  constexpr int CT = 32 * V;
  const int k = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = (blockIdx.y * 32 + lane) * V;
  float m[V], aa[V], bb[V], s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool on = c0 + j < C;
    m[j] = on ? mu[c0 + j] : 0.f;
    aa[j] = on ? a[c0 + j] : 0.f;
    bb[j] = on ? bias[c0 + j] : 0.f;
    s1[j] = s2[j] = 0.f;
  }
  walk_cols<T, V, false>(x, gy, nullptr, R, C, per_block, mode, slope, m, aa,
                         bb, nullptr, s1, s2);
  __shared__ float sh[2][kWarps][CT];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sh[0][warp][lane * V + j] = s1[j];
    sh[1][warp][lane * V + j] = s2[j];
  }
  __syncthreads();
  const int t = threadIdx.x, c = blockIdx.y * CT + t;
  if (t < CT && c < C) {
    float t1 = 0.f, t2 = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      t1 += sh[0][w][t];
      t2 += sh[1][w][t];
    }
    part[static_cast<size_t>(k) * C + c] = t1;
    part[(static_cast<size_t>(gridDim.x) + k) * C + c] = t2;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) apply_cols(
    const T* __restrict__ x, const T* __restrict__ gy,
    const float* __restrict__ mu, const float* __restrict__ inv,
    const float* __restrict__ scale, const float* __restrict__ a,
    const float* __restrict__ bias, const float* __restrict__ part, int nsum,
    const float* __restrict__ gmu, const float* __restrict__ gvar, float n,
    int R, int C, int per_block, int mode, float slope, T* __restrict__ dx,
    float* __restrict__ dgamma, float* __restrict__ dbeta) {
  constexpr int CT = 32 * V;
  const int k = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ Coefs sf[CT];
  for (int t = warp; t < CT; t += kWarps) {
    const int c = blockIdx.y * CT + t;
    if (c >= C) break;
    float t1, t2;
    channel_sums(part, nsum, C, c, lane, t1, t2);
    if (lane == 0) {
      sf[t] = coefs(t1, t2, inv[c], scale[c], a[c], gmu ? gmu[c] : 0.f,
                    gvar ? gvar[c] : 0.f, n);
      if (k == 0 && dgamma != nullptr) {
        dgamma[c] = inv[c] * t2;
        dbeta[c] = t1;
      }
    }
  }
  __syncthreads();
  const int c0 = (blockIdx.y * 32 + lane) * V;
  float m[V], aa[V], bb[V], unused[V];
  Coefs f[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool on = c0 + j < C;
    m[j] = on ? mu[c0 + j] : 0.f;
    aa[j] = on ? a[c0 + j] : 0.f;
    bb[j] = on ? bias[c0 + j] : 0.f;
    f[j] = on ? sf[lane * V + j] : Coefs{};
  }
  walk_cols<T, V, true>(x, gy, dx, R, C, per_block, mode, slope, m, aa, bb,
                        f, unused, unused);
}

// (S1, S2) of every channel, out (2, C), from the partials (2, nsum, C):
// what a process group all-reduces between the passes.
__global__ void __launch_bounds__(kThreads) sum_splits(
    const float* __restrict__ part, int nsum, int C, float* __restrict__ out) {
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= C) return;
  float t1, t2;
  channel_sums(part, nsum, C, c, lane, t1, t2);
  if (lane == 0) {
    out[c] = t1;
    out[C + c] = t2;
  }
}

// ---- launches ----

struct Args {
  const void *x, *gy;
  const float *mu, *inv, *scale, *a, *bias, *gmu, *gvar;
  float* part;        // written by the reduce, read by the apply
  int nsum;           // the partials the apply sums: splits, or 1
  float n;
  int outer, C, inner, pieces, per_block, splits, mode;
  float slope;
  void* dx;
  float *dgamma, *dbeta;
};

template <typename T, int V>
cudaError_t launch(const Args& s, bool apply, cudaStream_t st) {
  const T* x = static_cast<const T*>(s.x);
  const T* gy = static_cast<const T*>(s.gy);
  T* dx = static_cast<T*>(s.dx);
  if (s.inner == 1) {
    const dim3 grid(s.splits, (s.C + 32 * V - 1) / (32 * V));
    if (apply)
      apply_cols<T, V><<<grid, kThreads, 0, st>>>(
          x, gy, s.mu, s.inv, s.scale, s.a, s.bias, s.part, s.nsum, s.gmu,
          s.gvar, s.n, s.outer, s.C, s.per_block, s.mode, s.slope, dx,
          s.dgamma, s.dbeta);
    else
      reduce_cols<T, V><<<grid, kThreads, 0, st>>>(
          x, gy, s.mu, s.a, s.bias, s.outer, s.C, s.per_block, s.mode,
          s.slope, s.part);
  } else {
    const dim3 grid(s.splits, s.C);
    const int items = s.outer * s.pieces;
    if (apply)
      apply_rows<T, V><<<grid, kThreads, 0, st>>>(
          x, gy, s.mu, s.inv, s.scale, s.a, s.bias, s.part, s.nsum, s.gmu,
          s.gvar, s.n, s.C, s.inner, items, s.pieces, s.per_block, s.mode,
          s.slope, dx, s.dgamma, s.dbeta);
    else
      reduce_rows<T, V><<<grid, kThreads, 0, st>>>(
          x, gy, s.mu, s.a, s.bias, s.C, s.inner, items, s.pieces,
          s.per_block, s.mode, s.slope, s.part);
  }
  return cudaGetLastError();
}

// The element type code and the vector width (1, 2 or 4 elements; channels
// last takes 1 or 2) pick the instance.
cudaError_t run(const Args& s, bool apply, int dtype, int vec,
                cudaStream_t st) {
  // vectors run along the inner extent, or along C where it is 1
  const int along = s.inner == 1 ? s.C : s.inner;
  const bool ok = s.outer > 0 && s.C > 0 && s.inner > 0 && vec > 0 &&
                  along % vec == 0 &&
                  (s.inner == 1 ? vec <= 2 : s.C <= 65535) && s.pieces > 0 &&
                  s.per_block > 0 && s.splits > 0 && s.nsum > 0 &&
                  s.mode >= kReluBn && s.mode <= kBn &&
                  static_cast<long long>(s.outer) * s.pieces < (1LL << 31);
  if (!ok) return cudaErrorInvalidValue;
  if (dtype == asv::kF32) {
    if (vec == 1) return launch<float, 1>(s, apply, st);
    if (vec == 2) return launch<float, 2>(s, apply, st);
    if (vec == 4) return launch<float, 4>(s, apply, st);
  } else if (dtype == asv::kBF16) {
    if (vec == 1) return launch<__nv_bfloat16, 1>(s, apply, st);
    if (vec == 2) return launch<__nv_bfloat16, 2>(s, apply, st);
    if (vec == 4) return launch<__nv_bfloat16, 4>(s, apply, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Pass 1: the (S1, S2) partials, part (2, splits, C) f32.
extern "C" int bn_bwd_reduce(const void* x, const void* gy, const float* mu,
                             const float* a, const float* bias, int outer,
                             int C, int inner, int pieces, int per_block,
                             int splits, int mode, float slope, int dtype,
                             int vec, float* part, void* stream) {
  Args s{};
  s.x = x; s.gy = gy; s.mu = mu; s.a = a; s.bias = bias; s.part = part;
  s.nsum = 1; s.outer = outer; s.C = C; s.inner = inner; s.pieces = pieces;
  s.per_block = per_block; s.splits = splits; s.mode = mode; s.slope = slope;
  return static_cast<int>(run(s, false, dtype, vec,
                              static_cast<cudaStream_t>(stream)));
}

// Pass 2: dx in x's type from the nsum partials part (2, nsum, C) on the
// grid of pass 1; dgamma and dbeta (f32, C) unless null; gmu and gvar
// (f32, C) read as zeros where null.
extern "C" int bn_bwd_apply(const void* x, const void* gy, const float* mu,
                            const float* inv, const float* scale,
                            const float* a, const float* bias,
                            const float* part, int nsum, const float* gmu,
                            const float* gvar, float n, int outer, int C,
                            int inner, int pieces, int per_block, int splits,
                            int mode, float slope, int dtype, int vec,
                            void* dx, float* dgamma, float* dbeta,
                            void* stream) {
  Args s{};
  s.x = x; s.gy = gy; s.mu = mu; s.inv = inv; s.scale = scale; s.a = a;
  s.bias = bias; s.gmu = gmu; s.gvar = gvar; s.part = const_cast<float*>(part);
  s.nsum = nsum; s.n = n; s.outer = outer; s.C = C; s.inner = inner;
  s.pieces = pieces; s.per_block = per_block; s.splits = splits;
  s.mode = mode; s.slope = slope; s.dx = dx; s.dgamma = dgamma;
  s.dbeta = dbeta;
  return static_cast<int>(run(s, true, dtype, vec,
                              static_cast<cudaStream_t>(stream)));
}

// Between the passes, with a process group: the partials' per-channel sums,
// out (2, C) f32.
extern "C" int bn_bwd_sums(const float* part, int splits, int C, float* out,
                           void* stream) {
  if (splits < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  sum_splits<<<(C + kWarps - 1) / kWarps, kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(part, splits, C, out);
  return static_cast<int>(cudaGetLastError());
}

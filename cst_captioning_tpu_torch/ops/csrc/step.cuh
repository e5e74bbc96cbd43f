// The phases of one caption decode step for NVIDIA Hopper (sm_90a), shared
// by the decode-step entry (decode_step.cu) and the beam-step entry
// (beam_step.cu): attention, the LSTM stack and the vocab projection for
// every (lane, row) of a [G, B] batch. Per (lane g, row b), with the memory
// bank of row b shared by the G lanes:
//
//   q      = h_top Wq + bq
//   s_m    = v . tanh(proj_m + q)        mask_m > 0, else -1e9
//   ctx    = softmax(s) . mem
//   gates  = [emb, ctx] Wx + h Wh + b    split i|f|g|o, per LSTM layer
//   logits = h_top Wo + bo               -> [G, B, V] float32
//
// All arithmetic is float32 whatever the bank dtype; PAD and BOS are not
// masked and no token is selected here (the caller selects), and the
// embedding rows are gathered by the caller, as in the TPU kernels.
//
// The carry is float32 [L, G, B, H] c and h, stepped in place so a decode
// loop keeps one buffer for its whole run. With carry_bf16 the new c and h
// are rounded to bfloat16 (the model's carry dtype, as the TPU kernels
// return it); the next layer and the logits read the layer's h before
// that rounding, as in the TPU kernels.
//
// step::run runs five hand-written kernels on the caller's stream:
//   1. q     = h_top Wq + bq                  tiled GEMM
//   2. x0    = [emb, attend(q, bank of b)]    one block per (lane, row)
//   3. gates = x Wx + h Wh + b                tiled GEMM over both inputs
//   4. (c, h) from the gates                  pointwise, per layer (3-4)
//   5. logits = h_top Wo + bo                 tiled GEMM over vocab tiles
// Each GEMM block computes a 64 x 64 output tile from 64 x 16 / 16 x 64
// tiles in shared memory, every weight tile shared by the 64 rows of the
// block. The caller allocates the float32 scratch for q, x0, the gates and
// the layer's unrounded h. In place is safe: each kernel reads a layer's
// old c and h before the pointwise kernel after it overwrites them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attend.cuh"

struct StepArgs {
  const void* mem;      // [B, M, Em]
  const void* proj;     // [B, M, A]
  const float* mask;    // [B, M]
  const float* wq;      // [H, A]
  const float* bq;      // [A]
  const float* v;       // [A]
  const float* wx;      // layer 0 [E + Em, 4H], then layers 1.. [H, 4H]
  const float* wh;      // [L, H, 4H]
  const float* bg;      // [L, 4H]
  const float* wo;      // [H, V]
  const float* bo;      // [V]
  const float* emb;     // [G, B, E]
  float* c;             // [L, G, B, H] carry, stepped in place
  float* h;             // [L, G, B, H]
  float* logits;        // [G, B, V]
  float* scratch;       // G*B*(A + E + Em + 5H) floats
  int bank_bf16;        // 1: mem/proj are bfloat16, 0: float32
  int carry_bf16;       // 1: round the new c, h to bfloat16, 0: float32
  int G, B, M, V, E, Em, A, H, L;
};

namespace step {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kGemmThreads = 256;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct Gemm {
  // C [R, N] = A1 [R, K1] W1 [K1, N] + A2 [R, K2] W2 [K2, N] + bias [N]
  const float* a1;
  const float* w1;
  const float* a2;
  const float* w2;
  const float* bias;
  float* c;
  int lda1, lda2, k1, k2, R, N;
};

__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(const Gemm g) {
  __shared__ float as[kBK][kBM + 4];  // A tile, k-major
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int K = g.k1 + g.k2;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + kGemmThreads * i;
      const int r = idx / kBK;
      const int kk = idx % kBK;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      float val = 0.0f;
      if (gr < g.R && gk < K) {
        val = gk < g.k1 ? g.a1[(size_t)gr * g.lda1 + gk]
                        : g.a2[(size_t)gr * g.lda2 + (gk - g.k1)];
      }
      as[kk][r] = val;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + kGemmThreads * i;
      const int kk = idx / kBN;
      const int c = idx % kBN;
      const int gk = k0 + kk;
      const int gc = col0 + c;
      float val = 0.0f;
      if (gk < K && gc < g.N) {
        val = gk < g.k1 ? g.w1[(size_t)gk * g.N + gc]
                        : g.w2[(size_t)(gk - g.k1) * g.N + gc];
      }
      ws[kk][c] = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4];
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= g.R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < g.N) g.c[(size_t)r * g.N + c] = acc[i][j] + g.bias[c];
    }
  }
}

inline int run_gemm(const Gemm& g, cudaStream_t stream) {
  const dim3 grid((g.N + kBN - 1) / kBN, (g.R + kBM - 1) / kBM);
  gemm_kernel<<<grid, kGemmThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// x0[r] = [emb[r], ctx[r]] for r = g * B + b, attending over bank row b
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attend_kernel(const StepArgs p, const float* q, float* x0) {
  extern __shared__ float smem[];
  const int A = p.A, E = p.E, Em = p.Em, M = p.M;
  float* q_s = smem;        // [A]
  float* v_s = q_s + A;     // [A]
  float* ctx_s = v_s + A;   // [Em]
  float* scratch = ctx_s + Em;
  const size_t r = blockIdx.x;
  const size_t b = r % p.B;
  for (int a = threadIdx.x; a < A; a += kThreads) {
    q_s[a] = q[r * A + a];
    v_s[a] = p.v[a];
  }
  float* xr = x0 + r * (E + Em);
  for (int e = threadIdx.x; e < E; e += kThreads) xr[e] = p.emb[r * E + e];
  __syncthreads();
  attend::attend_row<T, false, kWarps>(
      q_s, v_s, static_cast<const T*>(p.proj) + b * M * A,
      static_cast<const T*>(p.mem) + b * M * Em, p.mask + b * M, M, A, Em,
      scratch, ctx_s);
  for (int e = threadIdx.x; e < Em; e += kThreads) xr[E + e] = ctx_s[e];
}

template <typename T>
inline int run_attend(const StepArgs& p, const float* q, float* x0,
               cudaStream_t stream) {
  const size_t bytes =
      (size_t)(2 * p.A + p.Em + attend::scratch_floats(p.Em, kWarps)) *
      sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&attend_kernel<T>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  attend_kernel<T><<<p.G * p.B, kThreads, bytes, stream>>>(p, q, x0);
  return (int)cudaGetLastError();
}

using attend::sigmoid_f32;

// gates [R, 4H] split i|f|g|o -> c, h [R, H] in place (rounded to
// bfloat16 when round_bf16) and x [R, H], the new h unrounded
__global__ void lstm_kernel(const float* gates, float* c, float* h, float* x,
                            int R, int H, int round_bf16) {
  const size_t n = (size_t)R * H;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / H;
    const size_t j = i % H;
    const float* gr = gates + r * 4 * H;
    const float ig = sigmoid_f32(gr[j]);
    const float fg = sigmoid_f32(gr[H + j]);
    const float gg = tanhf(gr[2 * H + j]);
    const float og = sigmoid_f32(gr[3 * H + j]);
    const float cn = fg * c[i] + ig * gg;
    const float hn = og * tanhf(cn);
    x[i] = hn;
    c[i] = round_bf16 ? attend::round_to<__nv_bfloat16>(cn) : cn;
    h[i] = round_bf16 ? attend::round_to<__nv_bfloat16>(hn) : hn;
  }
}

// The whole step; 0 or the first launch's cudaError.
inline int run(const StepArgs& p, cudaStream_t st) {
  const int R = p.G * p.B;
  if (R == 0) return 0;
  const int H = p.H, H4 = 4 * p.H, X0 = p.E + p.Em;
  const size_t layer = (size_t)R * H;
  float* q = p.scratch;               // [R, A]
  float* x0 = q + (size_t)R * p.A;    // [R, E + Em]
  float* gates = x0 + (size_t)R * X0;  // [R, 4H]
  float* xh = gates + (size_t)R * H4;  // [R, H] the layer's h, unrounded
  int rc = run_gemm(Gemm{p.h + (p.L - 1) * layer, p.wq, nullptr, nullptr,
                         p.bq, q, H, 0, H, 0, R, p.A},
                    st);
  if (rc) return rc;
  rc = p.bank_bf16 ? run_attend<__nv_bfloat16>(p, q, x0, st)
                   : run_attend<float>(p, q, x0, st);
  if (rc) return rc;
  const float* wx = p.wx;
  for (int l = 0; l < p.L; ++l) {
    const float* x = l == 0 ? x0 : xh;
    const int n_in = l == 0 ? X0 : H;
    rc = run_gemm(Gemm{x, wx, p.h + l * layer, p.wh + (size_t)l * H * H4,
                       p.bg + (size_t)l * H4, gates, n_in, H, n_in, H, R, H4},
                  st);
    if (rc) return rc;
    const int blocks = (int)((layer + 255) / 256 < 4096 ? (layer + 255) / 256
                                                        : 4096);
    lstm_kernel<<<blocks, 256, 0, st>>>(gates, p.c + l * layer,
                                       p.h + l * layer, xh, R, H,
                                       p.carry_bf16);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    wx += (size_t)n_in * H4;
  }
  return run_gemm(Gemm{xh, p.wo, nullptr, nullptr, p.bo, p.logits, H, 0, H,
                       0, R, p.V},
                  st);
}

}  // namespace step

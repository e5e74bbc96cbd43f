// Device code the kernels share: bfloat16/float32 conversions, warp sums,
// the sigmoid, and masked additive attention over one row's memory bank
// for one thread block (additive_attention.cu and decode_step.cu):
//
//   s_m = v . tanh(proj_m + q)        mask_m > 0, else -1e9
//   ctx = softmax(s) . mem            softmax statistics in float32
//
// Each warp walks the slots m = warp, warp + kWarps, ... with an online
// softmax: the lanes split the A-wide score sum (a warp reduction) and the
// E-wide weighted sum (per-lane accumulators in shared memory); the warps'
// (max, denominator, accumulator) triples merge at the end. Any M works;
// nothing is sized by it. A row whose slots are all masked scores -1e9
// everywhere and gets the uniform softmax over its M slots.
//
// kRound rounds proj + q and tanh to the bank type T before the float32
// sums, as the TPU additive-attention kernel does in the model dtype;
// without it every step is float32, as in the TPU decode-step kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace attend {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1.0e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision (round to nearest even) and back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Shared-memory floats attend_row needs beyond q_s, v_s and ctx_s.
__host__ __device__ inline int scratch_floats(int E, int warps) {
  return warps * E + 2 * warps;
}

// Context of one row into ctx_s [E] (float32, shared). q_s, v_s: [A]
// float32 in shared memory, written before the call. proj [M, A], mem
// [M, E] and mask [M] are the row's bank in device memory. scratch:
// scratch_floats(E, kWarps) shared floats. All threads of the block call
// it; it ends with a __syncthreads().
template <typename T, bool kRound, int kWarps>
__device__ void attend_row(const float* q_s, const float* v_s, const T* proj,
                           const T* mem, const float* mask, int M, int A,
                           int E, float* scratch, float* ctx_s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* acc = scratch + warp * E;
  float* stat = scratch + kWarps * E;  // [kWarps] max, then [kWarps] sums
  for (int e = lane; e < E; e += 32) acc[e] = 0.0f;
  float m_run = -INFINITY;
  float d_run = 0.0f;
  for (int m = warp; m < M; m += kWarps) {
    const T* pr = proj + (size_t)m * A;
    float s = 0.0f;
    for (int a = lane; a < A; a += 32) {
      float t;
      if (kRound) {
        t = round_to<T>(tanhf(round_to<T>(to_f32(pr[a]) + q_s[a])));
      } else {
        t = tanhf(to_f32(pr[a]) + q_s[a]);
      }
      s = fmaf(t, v_s[a], s);
    }
    s = warp_sum(s);
    if (!(mask[m] > 0.0f)) s = kNeg;
    const float m_new = fmaxf(m_run, s);
    const float alpha = expf(m_run - m_new);  // 0 while m_run is -inf
    const float p = expf(s - m_new);
    d_run = fmaf(d_run, alpha, p);
    const T* mr = mem + (size_t)m * E;
    for (int e = lane; e < E; e += 32) {
      acc[e] = fmaf(p, to_f32(mr[e]), acc[e] * alpha);
    }
    m_run = m_new;
  }
  if (lane == 0) {
    stat[warp] = m_run;
    stat[kWarps + warp] = d_run;
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, stat[w]);
  float den = 0.0f;
  for (int w = 0; w < kWarps; ++w) {
    if (stat[w] != -INFINITY) den += stat[kWarps + w] * expf(stat[w] - mx);
  }
  den = fmaxf(den, 1e-30f);
  for (int e = threadIdx.x; e < E; e += kWarps * 32) {
    float a = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      if (stat[w] != -INFINITY) a += scratch[w * E + e] * expf(stat[w] - mx);
    }
    ctx_s[e] = a / den;
  }
  __syncthreads();
}

}  // namespace attend

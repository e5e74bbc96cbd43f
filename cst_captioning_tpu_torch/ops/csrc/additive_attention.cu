// Fused masked additive-attention context for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fused_additive_attention (_kernel, _fused_forward)
// of cst_captioning_tpu/ops/attention_pallas.py. Per row b:
//
//   s_m  = v . tanh(proj[b, m] + q[b])   mask[b, m] > 0, else -1e9
//   ctx  = softmax_f32(s) . memory[b]    -> [E] in the memory dtype
//
// Numerics follow the TPU kernel: proj + q and tanh are rounded to the input
// dtype (bfloat16 or float32), the score sum, the softmax statistics and the
// weighted sum are float32, and the output is rounded once to the input
// dtype. A fully masked row gets the uniform softmax over its M slots.
//
// Design: one thread block of 8 warps per row, an online softmax over the
// memory slots (attend.cuh), so M is not capped (the TPU kernel is the
// long-context insurance of the model's attention).
//
// Bound: the kernel reads each input byte once (memory + proj dominate:
// B*M*(E + A) values) and does about 4A + 2E float32 operations per slot,
// about 1 operation per byte in bfloat16, so the card's memory rate bounds
// it. With one block per row it fills only B of the 132 SMs at B < 132.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attend.cuh"

struct AttentionArgs {
  const void* q;      // [B, A]
  const void* v;      // [A]
  const void* mem;    // [B, M, E]
  const void* proj;   // [B, M, A]
  const float* mask;  // [B, M]
  void* out;          // [B, E]
  int bf16;           // 1: q, v, mem, proj, out are bfloat16; 0: float32
  int B, M, A, E;
};

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    additive_attention_kernel(const AttentionArgs p) {
  extern __shared__ float smem[];
  const int A = p.A, E = p.E, M = p.M;
  float* q_s = smem;         // [A]
  float* v_s = q_s + A;      // [A]
  float* ctx_s = v_s + A;    // [E]
  float* scratch = ctx_s + E;
  const size_t b = blockIdx.x;
  const T* q = static_cast<const T*>(p.q) + b * A;
  const T* v = static_cast<const T*>(p.v);
  for (int a = threadIdx.x; a < A; a += kThreads) {
    q_s[a] = attend::to_f32(q[a]);
    v_s[a] = attend::to_f32(v[a]);
  }
  __syncthreads();
  attend::attend_row<T, true, kWarps>(
      q_s, v_s, static_cast<const T*>(p.proj) + b * M * A,
      static_cast<const T*>(p.mem) + b * M * E, p.mask + b * M, M, A, E,
      scratch, ctx_s);
  T* out = static_cast<T*>(p.out) + b * E;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    out[e] = attend::from_f32<T>(ctx_s[e]);
  }
}

template <typename T>
int launch(const AttentionArgs& p, cudaStream_t stream) {
  const size_t bytes =
      (size_t)(2 * p.A + p.E + attend::scratch_floats(p.E, kWarps)) *
      sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&additive_attention_kernel<T>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  additive_attention_kernel<T><<<p.B, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int additive_attention(const AttentionArgs* args, void* stream) {
  const AttentionArgs& p = *args;
  if (p.B == 0 || p.E == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p.bf16 ? launch<__nv_bfloat16>(p, st) : launch<float>(p, st);
}

const char* additive_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Fused masked additive-attention context for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fused_additive_attention
// (cst_captioning_tpu/ops/attention_pallas.py:169, its _kernel and
// pallas_call). Per row b:
//
//   s_m  = v . tanh(proj[b, m] + q[b])   mask[b, m] > 0, else -1e9
//   ctx  = softmax_f32(s) . memory[b]    -> [E] in the memory dtype
//
// Numerics follow the TPU kernel: proj + q and tanh are rounded to the input
// dtype (bfloat16 or float32), the score sum, the softmax statistics and the
// weighted sum are float32, and the output is rounded once to the input
// dtype. A fully masked row gets the uniform softmax over its M slots.
//
// Bound: every input byte is read once (memory and proj dominate: B*M*(E+A)
// values) for about 4A + 2E float32 operations a slot, about 1 operation a
// byte in bfloat16, so the card's memory rate bounds it: 1.7 us of HBM
// traffic at the XE step's B=64, M=56, A=256, E=512.
//
// Design: one launch of B clusters of nE blocks, a cluster a row (Hopper's
// thread-block clusters; ops/attention.py's attention_split picks nE = 1,
// 2, 4 or 8 for about two blocks an SM and one column group where E
// allows: 4 at B=64, 2 at B=320). The row's nE blocks score its slots
// together and each warp sends its slots' scores to every block of the
// row through distributed shared memory, so each tanh is taken once a
// column group; each block then forms the context for its own
// kPasses x 128 (bfloat16) or x 64 (float32) columns. No workspace, no
// merge. The row is walked in chunks of kChunk slots, two phases a chunk:
//   scores  a warp a slot (the cluster's nE x 8 warps share the chunk),
//           each lane 16 bytes of proj (8 bfloat16 of A) and of q and v a
//           load, kSlotsInFlight slots of a warp loaded before their tanh;
//           the chunk's max (a fixed-order block reduction) rescales the
//           running denominator and the accumulators;
//   context threads over the block's columns in 16-byte vectors, kChains
//           independent slot chains (the chunk's slot i on chain
//           i % kChains) taking the weights exp(s - max), whose sum (in a
//           fixed order) joins the denominator; the first chunk's memory
//           rows are loaded while the slots are scored; the chains are
//           summed in chain order at the end.
// M is not capped. A width beyond nE x kPasses passes takes several
// column groups, each of which scores the row again. Every slot's score,
// the statistics and each column's chains are summed in an order fixed by A,
// M and these constants alone, so a row's bits do not depend on nE, on B
// or on the rows beside it. Widths that are multiples of 16 bytes with
// 16-byte aligned bases take vector loads; any other A, E take scalar
// loads in the same order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attend.cuh"

namespace cg = cooperative_groups;

struct AttentionArgs {
  const void* q;      // [B, A]
  const void* v;      // [A]
  const void* mem;    // [B, M, E]
  const void* proj;   // [B, M, A]
  const float* mask;  // [B, M]
  void* out;          // [B, E]
  int bf16;           // 1: q, v, mem, proj, out are bfloat16; 0: float32
  int B, M, A, E;
  int nE;             // blocks a row: the cluster size, 1, 2, 4 or 8
  int passes;         // column passes a block a group: 1 or 2
};

namespace {

using attend::from_f32;
using attend::kFull;
using attend::kNeg;
using attend::to_f32;
using attend::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 512;        // slots scored into shared memory at once
constexpr int kSlotsInFlight = 2;  // a warp's score loads in flight
constexpr int kChains = 16;        // slot chains of the weighted sum
constexpr int kColVecs = kThreads / kChains;  // column vectors a pass
constexpr int kChainLoads = 2;     // a chain's context loads in flight
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMinBlocks = 3;      // blocks an SM: 80 registers a thread

template <typename T>
constexpr int kVecOf = 16 / (int)sizeof(T);

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// a and b rounded to T and back (bfloat16: one packed convert, round to
// nearest even as __float2bfloat16)
template <typename T>
__device__ __forceinline__ void round2(float& a, float& b);
template <>
__device__ __forceinline__ void round2<float>(float&, float&) {}
template <>
__device__ __forceinline__ void round2<__nv_bfloat16>(float& a, float& b) {
  const float2 f = __bfloat1622float2(__floats2bfloat162_rn(a, b));
  a = f.x;
  b = f.y;
}

// the cluster barrier in halves: arrive, then wait before what must follow
// every block's arrival
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// element j of a 16-byte vector, exactly
template <typename T>
__device__ __forceinline__ float elem(const uint4& r, int j);
template <>
__device__ __forceinline__ float elem<float>(const uint4& r, int j) {
  return __uint_as_float(word(r, j));
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& r, int j) {
  const uint32_t w = word(r, j >> 1);
  return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
}

// VEC consecutive elements of a row: one raw 16-byte load (kVec), or
// scalar loads of the first n, the rest 0
template <typename T, bool kVec>
struct Pack;
template <typename T>
struct Pack<T, true> {
  uint4 r;
  __device__ __forceinline__ void load(const T* p, int) {
    r = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float operator[](int j) const {
    return elem<T>(r, j);
  }
};
template <typename T>
struct Pack<T, false> {
  float x[kVecOf<T>];
  __device__ __forceinline__ void load(const T* p, int n) {
#pragma unroll
    for (int j = 0; j < kVecOf<T>; ++j) x[j] = j < n ? to_f32(p[j]) : 0.0f;
  }
  __device__ __forceinline__ float operator[](int j) const { return x[j]; }
};

// Scores of the chunk's n slots (from slot c0) into own [n]: this warp is
// warp gw of the cluster's nw and takes slots gw, gw + nw, ...; lane l
// sums A's elements l*VEC + j + 32*VEC*k in (k, j) order, then the warp's
// butterfly.
template <typename T, bool kVec>
__device__ __forceinline__ void score_chunk(const T* proj, const T* q,
                                            const T* v, const float* mask,
                                            int c0, int n, int A, int gw,
                                            int nw, float* own) {
  constexpr int VEC = kVecOf<T>;
  const int lane = threadIdx.x & 31;
  for (int i0 = gw; i0 < n; i0 += nw * kSlotsInFlight) {
    float s[kSlotsInFlight], mk[kSlotsInFlight];
#pragma unroll
    for (int u = 0; u < kSlotsInFlight; ++u) {
      s[u] = 0.0f;
      if (lane == 0 && i0 + u * nw < n) mk[u] = mask[c0 + i0 + u * nw];
    }
    for (int a0 = lane * VEC; a0 < A; a0 += 32 * VEC) {
      const int na = min(VEC, A - a0);
      Pack<T, kVec> x[kSlotsInFlight], qa, va;
#pragma unroll
      for (int u = 0; u < kSlotsInFlight; ++u) {
        if (i0 + u * nw < n) {
          x[u].load(proj + (size_t)(c0 + i0 + u * nw) * A + a0, na);
        }
      }
      qa.load(q + a0, na);
      va.load(v + a0, na);
#pragma unroll
      for (int u = 0; u < kSlotsInFlight; ++u) {
        if (i0 + u * nw < n) {
#pragma unroll
          for (int j = 0; j < VEC; j += 2) {
            if (kVec || j < na) {
              float x0 = x[u][j] + qa[j], x1 = x[u][j + 1] + qa[j + 1];
              round2<T>(x0, x1);
              float t0 = tanhf(x0), t1 = tanhf(x1);
              round2<T>(t0, t1);
              s[u] = fmaf(t0, va[j], s[u]);
              if (kVec || j + 1 < na) s[u] = fmaf(t1, va[j + 1], s[u]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSlotsInFlight; ++u) {
      const int i = i0 + u * nw;
      if (i < n) {
        const float su = warp_sum(s[u]);
        if (lane == 0) own[i] = mk[u] > 0.0f ? su : kNeg;
      }
    }
  }
}

template <typename T, bool kVec, int kPasses>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    additive_attention_kernel(const AttentionArgs p) {
  constexpr int VEC = kVecOf<T>;
  constexpr int kPassCols = kColVecs * VEC;
  extern __shared__ float smem[];
  float* own = smem;                        // [kChunk] this block's scores
  float* w_s = own + kChunk;                // [kChunk] the chunk's scores
  float* red = w_s + kChunk;                // [kChains, kPassCols]
  float* stat = red + kChains * kPassCols;  // [kWarps] max, [kWarps] sums
  cg::cluster_group cluster = cg::this_cluster();
  const int A = p.A, E = p.E, M = p.M, nE = p.nE;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int gw = rank * kWarps + warp;
  const int nw = nE * kWarps;
  const size_t b = blockIdx.x / nE;
  const T* q = static_cast<const T*>(p.q) + b * A;
  const T* v = static_cast<const T*>(p.v);
  const T* proj = static_cast<const T*>(p.proj) + b * M * A;
  const T* mem = static_cast<const T*>(p.mem) + b * M * E;
  const float* mask = p.mask + b * M;
  T* out = static_cast<T*>(p.out) + b * E;
  const int chain = tid / kColVecs;
  const int cv = tid % kColVecs;
  const int row_passes = (E + kPassCols - 1) / kPassCols;
  const int groups = (row_passes + nE * kPasses - 1) / (nE * kPasses);
  const int chunks = (M + kChunk - 1) / kChunk;
  // A block writes into the others' shared memory only once they run and
  // once they have read what it overwrites: an arrival now, and one after
  // each chunk's last read of w_s, each met by a wait before the writes.
  cluster_arrive();
  for (int g = 0; g < groups; ++g) {
    const int col0 = (g * nE + rank) * kPasses * kPassCols;
    // the first chunk's memory rows of this thread's first pass, loaded
    // while the slots are scored
    Pack<T, kVec> pre[kChainLoads];
    const int e_pre = col0 + cv * VEC;
    if (e_pre < E) {
#pragma unroll
      for (int u = 0; u < kChainLoads; ++u) {
        const int i = chain + u * kChains;
        if (i < min(kChunk, M)) {
          pre[u].load(mem + (size_t)i * E + e_pre, min(VEC, E - e_pre));
        }
      }
    }
    float acc[kPasses][VEC];
#pragma unroll
    for (int ps = 0; ps < kPasses; ++ps) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[ps][j] = 0.0f;
    }
    float m_run = -INFINITY;
    float d_run = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      const int c0 = c * kChunk;
      const int n = min(kChunk, M - c0);
      score_chunk<T, kVec>(proj, q, v, mask, c0, n, A, gw, nw, own);
      // each warp sends its slots' scores to every block of the row
      __syncwarp();
      cluster_wait();
      for (int i = gw + lane * nw; i < n; i += 32 * nw) {
        for (int r = 0; r < nE; ++r) {
          *cluster.map_shared_rank(w_s + i, r) = own[i];
        }
      }
      cluster.sync();
      // the chunk's max (thread, warp, then warps 0..7), which rescales
      // the running denominator and the accumulators
      float mx = -INFINITY;
      for (int i = tid; i < n; i += kThreads) mx = fmaxf(mx, w_s[i]);
      mx = warp_max(mx);
      if (lane == 0) stat[warp] = mx;
      __syncthreads();
      float m_new = m_run;
      for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, stat[w]);
      const float alpha = expf(m_run - m_new);  // 0 on the first chunk
      m_run = m_new;
      // the sum of the weights exp(s - max) in the same order
      float sum = 0.0f;
      for (int i = tid; i < n; i += kThreads) sum += expf(w_s[i] - m_new);
      sum = warp_sum(sum);
      if (lane == 0) stat[kWarps + warp] = sum;
      // the weighted sum: chain `chain` takes the chunk's slots chain,
      // chain + kChains, ... in order, kChainLoads of them loaded at once,
      // each weight exp(s - max) taken again where it is used
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps) {
        const int e0 = col0 + ps * kPassCols + cv * VEC;
        if (e0 >= E) continue;
        const int ne = min(VEC, E - e0);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[ps][j] *= alpha;
        for (int i0 = chain; i0 < n; i0 += kChains * kChainLoads) {
          const bool first = ps == 0 && c == 0 && i0 == chain;
          Pack<T, kVec> x[kChainLoads];
#pragma unroll
          for (int u = 0; u < kChainLoads; ++u) {
            const int i = i0 + u * kChains;
            if (first) {
              x[u] = pre[u];
            } else if (i < n) {
              x[u].load(mem + (size_t)(c0 + i) * E + e0, ne);
            }
          }
#pragma unroll
          for (int u = 0; u < kChainLoads; ++u) {
            const int i = i0 + u * kChains;
            if (i < n) {
              const float w = expf(w_s[i] - m_new);
#pragma unroll
              for (int j = 0; j < VEC; ++j) {
                acc[ps][j] = fmaf(w, x[u][j], acc[ps][j]);
              }
            }
          }
        }
      }
      if (c + 1 < chunks || g + 1 < groups) cluster_arrive();
      __syncthreads();
      float csum = 0.0f;
      for (int w = 0; w < kWarps; ++w) csum += stat[kWarps + w];
      d_run = fmaf(d_run, alpha, csum);
    }
    // the chains' sums in chain order, then the output's one rounding
#pragma unroll
    for (int ps = 0; ps < kPasses; ++ps) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        red[chain * kPassCols + cv * VEC + j] = acc[ps][j];
      }
      __syncthreads();
      for (int c = tid; c < kPassCols; c += kThreads) {
        const int e = col0 + ps * kPassCols + c;
        if (e < E) {
          float a = 0.0f;
          for (int k = 0; k < kChains; ++k) a += red[k * kPassCols + c];
          out[e] = from_f32<T>(a / d_run);
        }
      }
      __syncthreads();  // red is rewritten by the next pass
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <typename T, bool kVec, int kPasses>
int launch_as(const AttentionArgs& p, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((size_t)p.B * p.nE));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes =
      (2 * kChunk + kChains * kColVecs * kVecOf<T> + 2 * kWarps) *
      sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = p.nE;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  void (*kernel)(AttentionArgs) = &additive_attention_kernel<T, kVec, kPasses>;
  return (int)cudaLaunchKernelEx(&cfg, kernel, p);
}

template <typename T, bool kVec>
int launch_passes(const AttentionArgs& p, cudaStream_t stream) {
  return p.passes == 1 ? launch_as<T, kVec, 1>(p, stream)
                       : launch_as<T, kVec, 2>(p, stream);
}

template <typename T>
int launch(const AttentionArgs& p, cudaStream_t stream) {
  constexpr int VEC = kVecOf<T>;
  const bool vec = p.A % VEC == 0 && p.E % VEC == 0 && aligned16(p.q) &&
                   aligned16(p.v) && aligned16(p.mem) && aligned16(p.proj) &&
                   aligned16(p.out);
  return vec ? launch_passes<T, true>(p, stream)
             : launch_passes<T, false>(p, stream);
}

}  // namespace

extern "C" {

int additive_attention(const AttentionArgs* args, void* stream) {
  const AttentionArgs& p = *args;
  if (p.B == 0 || p.E == 0) return 0;
  const bool pow2 = p.nE > 0 && (p.nE & (p.nE - 1)) == 0;
  if (p.M < 1 || p.A < 1 || !pow2 || p.nE > kMaxCluster ||
      (p.passes != 1 && p.passes != 2) ||
      (long long)p.B * p.nE > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p.bf16 ? launch<__nv_bfloat16>(p, st) : launch<float>(p, st);
}

const char* additive_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// One beam-search step for NVIDIA Hopper (sm_90a): the decode step of every
// (beam lane, row) of a [W, B] batch, then the per-row global top-W
// candidate selection over (lane, token).
//
// Replaces the TPU kernel fused_beam_step (_beam_kernel, _beam_call) of
// cst_captioning_tpu/ops/decode_pallas.py. Per row b:
//
//   logits  = the decode step of lane g (step.cuh)         [W, V] float32
//   masked  = logits with PAD, BOS -> -1e9, EOS -> -1e9 while t < min_len
//   live g:     total[g, v] = score_g + (masked[g, v] - logsumexp(masked[g]))
//   finished g: total[g, 0] = score_g, total[g, 1 .. W-1] = score_g - 1e9
//               (the PAD-only continuation row's top W, in closed form)
//   out     = top W of total over the flat ids g * V + v, value
//             descending, ties toward the lower flat id (lax.top_k's order)
//   -> top_scores [B, W] float32, top_flat [B, W] int32
//
// Within a lane, raw-logit order is total order (the lane's logsumexp is
// one shift), so the lane's top W by (logit descending, lower column) are
// its only candidates; the global top W takes at most W from one lane.
// Known rounding edge, as in the TPU kernel: two distinct logits whose
// totals round to the same float32 keep raw-logit order here where a full
// sort of the totals would take the lower flat id.
//
// Design: the entry runs the decode step's five kernels (step.cuh, shared
// with decode_step.cu) with the logits written to the caller's float32
// scratch [W, B, V], then one selection kernel: one block of 256 threads
// per row b. For each live lane the threads walk strided columns keeping
// the running max and a register top-W list each; a block reduction gives
// the max and then the sum of exponentials (the lane's logsumexp in
// float32); a tree of pairwise merges in shared memory gives the lane's
// top W; thread 0 then merges the W x W lane candidates. The TPU kernel
// keeps the logits in VMEM; here they make one round trip through device
// memory (11.5 MB at W=5, B=64, V=9000), which later work can fuse away.
// The hypothesis reorder (a gather across lanes) stays with the caller,
// between launches.
//
// Bound: at W=5, B=64 and the msrvtt width the step does about 5.1 GFLOP
// of float32 multiply-adds (Wx, Wh, Wo and Wq for 320 lane rows) against
// about 37 MB of weights and bank: the card's float32 rate bounds it,
// 0.076 ms at 67 TFLOP/s; the memory bound is 0.011 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "step.cuh"

struct BeamArgs {
  StepArgs step;        // step.G = W lanes; step.logits: [W, B, V] scratch
  const int* finished;  // [W, B] 0 or 1
  const float* scores;  // [W, B] running hypothesis scores
  float* top_scores;    // [B, W]
  int* top_flat;        // [B, W] flat ids g * V + v
  int t;                // the step index, for min_len
  int min_len;
};

namespace {

constexpr int kMaxBeam = 16;  // the widest beam the selection takes
constexpr int kSelThreads = 256;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kPad = 0;
constexpr int kBos = 1;
constexpr int kEos = 2;

// (av, ai) goes before (bv, bi): value descending, then the lower id
__device__ __forceinline__ bool ahead(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ float masked(float x, int v, bool block_eos) {
  return (v == kPad || v == kBos || (block_eos && v == kEos)) ? attend::kNeg
                                                              : x;
}

// Block-wide max / sum of one value per thread; every thread gets it.
__device__ float block_max(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(attend::kFull, x, o));
  }
  __syncthreads();  // the previous reduction's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kSelWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

__device__ float block_sum(float x, float* red) {
  x = attend::warp_sum(x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < kSelWarps; ++w) s += red[w];
  return s;
}

// The first W of the union of two lists sorted by ahead(), into (av, ai).
__device__ void merge_lists(float* av, int* ai, const float* bv,
                            const int* bi, int W) {
  float ov[kMaxBeam];
  int oi[kMaxBeam];
  int x = 0;
  int y = 0;
  for (int j = 0; j < W; ++j) {
    if (ahead(av[x], ai[x], bv[y], bi[y])) {
      ov[j] = av[x];
      oi[j] = ai[x];
      ++x;
    } else {
      ov[j] = bv[y];
      oi[j] = bi[y];
      ++y;
    }
  }
  for (int j = 0; j < W; ++j) {
    av[j] = ov[j];
    ai[j] = oi[j];
  }
}

__global__ void __launch_bounds__(kSelThreads) select_kernel(const BeamArgs p) {
  __shared__ float list_v[kSelThreads * kMaxBeam];
  __shared__ int list_i[kSelThreads * kMaxBeam];
  __shared__ float cand_v[kMaxBeam * kMaxBeam];
  __shared__ int cand_i[kMaxBeam * kMaxBeam];
  __shared__ float red[kSelWarps];
  const int W = p.step.G;
  const int B = p.step.B;
  const int V = p.step.V;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const bool block_eos = p.t < p.min_len;
  for (int g = 0; g < W; ++g) {
    const float score = p.scores[g * B + b];
    if (p.finished[g * B + b]) {  // the same branch for the whole block
      if (tid < W) {
        cand_v[g * W + tid] = score + (tid == 0 ? 0.0f : attend::kNeg);
        cand_i[g * W + tid] = g * V + tid;
      }
      continue;
    }
    const float* row = p.step.logits + ((size_t)g * B + b) * V;
    float tv[kMaxBeam];
    int ti[kMaxBeam];
#pragma unroll
    for (int j = 0; j < kMaxBeam; ++j) {
      tv[j] = -INFINITY;
      ti[j] = INT_MAX;
    }
    float mx = -INFINITY;
    for (int v = tid; v < V; v += kSelThreads) {
      float x = masked(row[v], v, block_eos);
      int xi = v;
      mx = fmaxf(mx, x);
      // insert into the sorted register list, carrying the displaced
      // entry down (columns arrive in ascending order, so a tie stays
      // behind the lower column already there)
#pragma unroll
      for (int j = 0; j < kMaxBeam; ++j) {
        if (j < W && ahead(x, xi, tv[j], ti[j])) {
          const float sv = tv[j];
          const int si = ti[j];
          tv[j] = x;
          ti[j] = xi;
          x = sv;
          xi = si;
        }
      }
    }
    const float m = block_max(mx, red);
    float s = 0.0f;
    for (int v = tid; v < V; v += kSelThreads) {
      s += expf(masked(row[v], v, block_eos) - m);
    }
    const float lse = m + logf(block_sum(s, red));
#pragma unroll
    for (int j = 0; j < kMaxBeam; ++j) {
      if (j < W) {
        list_v[tid * W + j] = tv[j];
        list_i[tid * W + j] = ti[j];
      }
    }
    __syncthreads();
    for (int n = kSelThreads / 2; n > 0; n >>= 1) {
      if (tid < n) {
        merge_lists(list_v + tid * W, list_i + tid * W,
                    list_v + (tid + n) * W, list_i + (tid + n) * W, W);
      }
      __syncthreads();
    }
    if (tid < W) {
      cand_v[g * W + tid] = score + (list_v[tid] - lse);
      cand_i[g * W + tid] = g * V + list_i[tid];
    }
    // the next live lane writes the lists only after its reductions'
    // barriers, so these reads finish first
  }
  __syncthreads();
  if (tid == 0) {
    const int n = W * W;
    for (int j = 0; j < W; ++j) {
      int best = 0;
      for (int c = 1; c < n; ++c) {
        if (ahead(cand_v[c], cand_i[c], cand_v[best], cand_i[best])) best = c;
      }
      p.top_scores[b * W + j] = cand_v[best];
      p.top_flat[b * W + j] = cand_i[best];
      cand_v[best] = -INFINITY;
      cand_i[best] = INT_MAX;
    }
  }
}

}  // namespace

extern "C" {

int beam_step(const BeamArgs* args, void* stream) {
  const BeamArgs& p = *args;
  const StepArgs& s = p.step;
  if (s.G < 1 || s.G > kMaxBeam || s.G > s.V) {
    return (int)cudaErrorInvalidValue;
  }
  if (s.B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = step::run(s, st);
  if (rc) return rc;
  select_kernel<<<s.B, kSelThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

const char* beam_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

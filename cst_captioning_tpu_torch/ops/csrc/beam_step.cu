// One beam-search step for NVIDIA Hopper (sm_90a): the decode step of every
// (beam lane, row) of a [W, B] batch, then the per-row global top-W
// candidate selection over (lane, token).
//
// Replaces the TPU kernel fused_beam_step of
// cst_captioning_tpu/ops/decode_pallas.py (public fn :1643, _beam_kernel
// :1324, _beam_call :1500, pallas_call :1613). Per row b:
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
// Bound: at W=5, B=64 and the msrvtt width the step does about 5.1 GFLOP
// of float32 multiply-adds (Wx, Wh, Wo and Wq for 320 lane rows) against
// about 37 MB of float32 weights and bank (21 MB with the bfloat16 weights
// of a bfloat16 model): the card's float32 rate bounds it, 0.076 ms at 67
// TFLOP/s; the memory bound is 0.011 ms at 3.35 TB/s.
//
// Design: the decode step's launches (step.cuh, shared with decode_step.cu:
// split-K row-GEMM tiles for q and the gates, the attention a block a row,
// the LSTM update) and its logits GEMM, whose epilogue keeps the logits out
// of device memory as the TPU kernel keeps them in VMEM (its running
// (max, sumexp) and in-lane top W over vocab blocks, decode_pallas.py
// :1290-1322). Each (lane row, 64-column tile) leaves its max, its sum of
// exps and its own top W (value, column) in the caller's workspace
// (beam_workspace in ops/beam_step.py: 2.2 MB at W=5, B=64 against 11.5 MB
// of logits). One merge launch, a block per row b, then folds, per live
// lane (a warp each), the 141 tiles' (max, sumexp) into the lane's
// logsumexp and takes the lane's top W from the tiles' lists in W rounds
// (the best entry behind the last round's: each list is sorted, so a
// tile's first entry behind it is its best); thread 0 merges the W x W
// lane candidates. Ties go to the lower column inside a tile, across tiles
// and across lanes. The hypothesis reorder (a gather across lanes) stays
// with the caller, between launches.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "step.cuh"

struct BeamArgs {
  StepArgs step;        // step.G = W lanes; step.logits unused
  const int* finished;  // [W, B] 0 or 1
  const float* scores;  // [W, B] running hypothesis scores
  float* top_scores;    // [B, W]
  int* top_flat;        // [B, W] flat ids g * V + v
  float* part;          // beam_workspace(W, B, V) floats: the partials
  long long part_floats;
  int t;                // the step index, for min_len
  int min_len;
};

namespace {

using step::ahead;
using step::kThreads;
using step::kWarps;

constexpr int kMaxBeam = 16;  // the widest beam the selection takes

// online logsumexp: (m, s) stands for log(s) + m
__device__ __forceinline__ void lse_merge(float& m, float& s, float om,
                                          float os) {
  const float nm = fmaxf(m, om);
  if (nm == -INFINITY) return;
  s = s * expf(m - nm) + os * expf(om - nm);
  m = nm;
}

// Floats of the selection partials (beam_workspace in ops/beam_step.py).
long long part_floats(const StepArgs& s) {
  return (long long)s.G * s.B * step::cdiv(s.V, rowgemm::BN) *
         step::slots(s.G);
}

__global__ void __launch_bounds__(kThreads) beam_merge(const BeamArgs p) {
  __shared__ float cand_v[kMaxBeam * kMaxBeam];
  __shared__ int cand_i[kMaxBeam * kMaxBeam];
  const int W = p.step.G;
  const int B = p.step.B;
  const int V = p.step.V;
  const int nT = step::cdiv(V, rowgemm::BN);
  const int S = step::slots(W);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < W; g += kWarps) {
    const float score = p.scores[g * B + b];
    if (p.finished[g * B + b]) {
      if (lane < W) {
        cand_v[g * W + lane] = score + (lane == 0 ? 0.0f : attend::kNeg);
        cand_i[g * W + lane] = g * V + lane;
      }
      continue;
    }
    const float* pr = p.part + (size_t)(g * B + b) * nT * S;
    // the lane's logsumexp: tiles lane, lane + 32, .. in order, then a
    // butterfly over the lanes
    float lm = -INFINITY;
    float ls = 0.0f;
    for (int t = lane; t < nT; t += 32) {
      lse_merge(lm, ls, pr[(size_t)t * S], pr[(size_t)t * S + 1]);
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float om = __shfl_xor_sync(attend::kFull, lm, o);
      const float os = __shfl_xor_sync(attend::kFull, ls, o);
      lse_merge(lm, ls, om, os);
    }
    const float lse = lm + logf(ls);
    // the lane's top W: round k takes the best entry behind round k - 1's
    float pv = INFINITY;
    int pi = -1;
    for (int k = 0; k < W; ++k) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int t = lane; t < nT; t += 32) {
        const float* vals = pr + (size_t)t * S + 2;
        for (int j = 0; j < W; ++j) {
          const float v = vals[j];
          const int c = __float_as_int(vals[W + j]);
          if (ahead(pv, pi, v, c)) {
            if (ahead(v, c, bv, bi)) {
              bv = v;
              bi = c;
            }
            break;
          }
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(attend::kFull, bv, o);
        const int oi = __shfl_xor_sync(attend::kFull, bi, o);
        if (ahead(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        cand_v[g * W + k] = score + (bv - lse);
        cand_i[g * W + k] = g * V + bi;
      }
      pv = bv;
      pi = bi;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
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
  if (p.part == nullptr || p.part_floats < part_floats(s)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const step::Sel sel{p.part, s.G, p.t < p.min_len};
  const int rc = step::run(s, &sel, st);
  if (rc) return rc;
  beam_merge<<<s.B, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// Floats of selection partials a launch with these arguments needs (what
// the launch checks the caller's against).
long long beam_step_part_floats(const BeamArgs* args) {
  return part_floats(args->step);
}

const char* beam_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

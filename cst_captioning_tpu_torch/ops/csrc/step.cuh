// The launches of one caption decode step for NVIDIA Hopper (sm_90a),
// shared by the decode-step entry (decode_step.cu) and the beam-step entry
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
// All arithmetic is float32 whatever the bank dtype and the weight dtype;
// the embedding rows are gathered by the caller, as in the TPU kernels.
// With weights_bf16 every weight (Wq, bq, v, Wx, Wh, b, Wo, bo) and the
// embedding rows are bfloat16, the model's parameter dtype, and each is
// widened to float32 where it is read (rowgemm.cuh), as the TPU kernels
// widen the parameter-dtype weights in their body: the results are bit
// for bit those of the same launch on the float32 values.
//
// The carry is float32 [L, G, B, H] c and h, stepped in place so a decode
// loop keeps one buffer for its whole run. With carry_bf16 the new c and h
// are rounded to bfloat16 (the model's carry dtype, as the TPU kernels
// return it); the next layer and the logits read the layer's h before
// that rounding, as in the TPU kernels.
//
// step::run queues these kernels on the caller's stream, over the R = G * B
// lane rows (row r = g * B + b; every row is live):
//
//   step_q_gemm      h_top . Wq into split-K partials        row-GEMM tiles
//   step_attend      q = bq + the partials, in slice order;  a block a row
//                    x0 = [emb, attend(q, bank of b)]
//   step_gates_gemm  [x, h] . [Wx; Wh] into split-K partials  per layer
//   step_cell        gates = b + the partials, in slice order; the LSTM
//                    update of c and h                         per layer
//   step_logits      h_top . Wo + bo over 64-column tiles, with the
//                    epilogue the caller picks: the logits (decode step),
//                    or per-tile selection partials (beam step, Sel)
//
// The GEMMs run on rowgemm.cuh's tiles, the stride kernel's: 16 * TM rows
// by 64 columns a block, k staged 32 deep through a cp.async double buffer
// in shared memory, a TM x 4 register accumulator a thread, so a weight
// tile serves every row of the block. The q and gate GEMMs are split into
// 256-deep k slices (the gate GEMM: 192 blocks at G=1, B=64, 960 at G=5);
// each partial goes to the caller's scratch and is summed, with the bias,
// where it is read. Every sum runs in an order fixed by the shapes alone
// (a row's k order, then slice order; no atomics), so a row's results do
// not depend on which rows share its tiles. In place is safe: each kernel
// reads a layer's old c and h before the cell launch after it overwrites
// them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attend.cuh"
#include "rowgemm.cuh"

struct StepArgs {
  const void* mem;      // [B, M, Em]
  const void* proj;     // [B, M, A]
  const float* mask;    // [B, M]
  // weights and embedding rows: float32, or bfloat16 with weights_bf16
  const void* wq;       // [H, A]
  const void* bq;       // [A]
  const void* v;        // [A]
  const void* wx;       // layer 0 [E + Em, 4H], then layers 1.. [H, 4H]
  const void* wh;       // [L, H, 4H]
  const void* bg;       // [L, 4H]
  const void* wo;       // [H, V]
  const void* bo;       // [V]
  const void* emb;      // [G, B, E]
  float* c;             // [L, G, B, H] carry, stepped in place
  float* h;             // [L, G, B, H]
  float* logits;        // [G, B, V]; unused by the beam step
  float* scratch;       // step_workspace(...) floats (ops/decode_step.py)
  long long scratch_floats;
  int bank_bf16;        // 1: mem/proj are bfloat16, 0: float32
  int carry_bf16;       // 1: round the new c, h to bfloat16, 0: float32
  int weights_bf16;     // 1: the weights and emb are bfloat16, 0: float32
  int G, B, M, V, E, Em, A, H, L;
};

namespace step {

constexpr int kThreads = rowgemm::kThreads;
constexpr int kWarps = kThreads / 32;
// k of one split-K slice of the q and gate GEMMs (SPLIT_K in
// ops/decode_stride.py, which sizes the scratch)
constexpr int kSplitK = 256;
// Every GEMM's tile: 16 * kTM = 64 rows (128-row tiles made the logits
// launch slower at G=5 and at G=1; PERF.md), k staged kBK deep in kStages
// cp.async buffers
constexpr int kTM = 4;
constexpr int kBK = 32;
constexpr int kStages = 2;
using Tile = rowgemm::Tile<kTM, kBK, kStages>;
constexpr int kPad = 0;
constexpr int kBos = 1;
constexpr int kEos = 2;
using attend::kFull;
using attend::kNeg;
using attend::sigmoid_f32;
using attend::warp_sum;
using rowgemm::weight;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Rows, and split-K slices of q and of the widest gate GEMM.
struct Dims {
  int R, ksq, ksg;
};

inline Dims dims_of(const StepArgs& p) {
  return Dims{p.G * p.B, cdiv(p.H, kSplitK),
              cdiv(imax(p.E + p.Em, p.H) + p.H, kSplitK)};
}

struct Scratch {
  float* qpart;  // [ksq, R, A]
  float* gpart;  // [ksg, R, 4H]
  float* x0;     // [R, E + Em] layer-0 input (emb | ctx)
  float* xh;     // [R, H] the layer's new h, unrounded
};

// Carve the scratch (if s) and return its size in floats; the order and the
// rounding (every region 16-byte aligned) are step_workspace's in
// ops/decode_step.py.
inline long long carve(const StepArgs& p, Scratch* s) {
  const Dims d = dims_of(p);
  const long long R = d.R;
  long long off = 0;
  float* base = s ? p.scratch : nullptr;
  const auto take = [&](long long n) {
    float* q = base ? base + off : nullptr;
    off += (n + 3) / 4 * 4;
    return q;
  };
  Scratch v;
  v.qpart = take((long long)d.ksq * R * p.A);
  v.gpart = take((long long)d.ksg * R * 4 * p.H);
  v.x0 = take(R * (p.E + p.Em));
  v.xh = take(R * p.H);
  if (s) *s = v;
  return off;
}

// (av, ai) goes before (bv, bi): value descending, then the lower id
__device__ __forceinline__ bool ahead(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Four consecutive columns col .. col + 3 of a row of width N; 16 bytes at
// once where vec (N % 4 == 0 and o 16-byte aligned, so col + 4 <= N).
__device__ __forceinline__ void store4(float* o, int col, int N, float a0,
                                      float a1, float a2, float a3, bool vec) {
  if (vec) {
    if (col < N) {
      *reinterpret_cast<float4*>(o + col) = make_float4(a0, a1, a2, a3);
    }
    return;
  }
  if (col < N) o[col] = a0;
  if (col + 1 < N) o[col + 1] = a1;
  if (col + 2 < N) o[col + 2] = a2;
  if (col + 3 < N) o[col + 3] = a3;
}

__device__ __forceinline__ bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

// ---- the split-K GEMMs: q and the gates ------------------------------------

// out[slice, r, :] = X[r, k slice] W[k slice, :] over the two K segments,
// for rows r < R (the identity row list).
struct Job {
  rowgemm::Seg seg[2];
  int N;
  int R;
  float* out;  // [cdiv(k, kSplitK), R, N]
};

// Block (column tile x, row tile y, k slice z) of a split-K job, the
// weights of type WT.
template <typename WT>
__device__ __forceinline__ void split_gemm(const Job& j) {
  __shared__ __align__(16) float smem[Tile::kSmemFloats];
  __shared__ int rows[Tile::BM];
  const int n0 = blockIdx.x * rowgemm::BN;
  const int row0 = blockIdx.y * Tile::BM;
  const int slice = blockIdx.z;
  const int kb = slice * kSplitK;
  const int ke = min(j.seg[0].k + j.seg[1].k, kb + kSplitK);
  const int n_rows = min(Tile::BM, j.R - row0);
  if (threadIdx.x < Tile::BM) rows[threadIdx.x] = row0 + threadIdx.x;
  float acc[kTM][4];
  // syncs first
  Tile::run<WT>(j.seg, kb, ke, j.N, n0, rows, n_rows, smem, acc);
  const int ty = threadIdx.x / 16;
  const int col = n0 + (threadIdx.x % 16) * 4;
  float* out = j.out + (size_t)slice * j.R * j.N;
  const bool vec = (j.N % 4 == 0) && aligned16(j.out);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = ty * kTM + i;
    if (m < n_rows) {
      store4(out + (size_t)(row0 + m) * j.N, col, j.N, acc[i][0], acc[i][1],
             acc[i][2], acc[i][3], vec);
    }
  }
}

// Two kernels of one body, so a profile tells q from the gates.
template <typename WT>
__global__ void __launch_bounds__(kThreads, 2) step_q_gemm(const Job j) {
  split_gemm<WT>(j);
}

template <typename WT>
__global__ void __launch_bounds__(kThreads, 2) step_gates_gemm(const Job j) {
  split_gemm<WT>(j);
}

template <typename WT>
inline int run_split(const Job& j, bool gates, cudaStream_t st) {
  const dim3 grid(cdiv(j.N, rowgemm::BN), cdiv(j.R, Tile::BM),
                  cdiv(j.seg[0].k + j.seg[1].k, kSplitK));
  if (gates) {
    step_gates_gemm<WT><<<grid, kThreads, 0, st>>>(j);
  } else {
    step_q_gemm<WT><<<grid, kThreads, 0, st>>>(j);
  }
  return (int)cudaGetLastError();
}

// ---- attention --------------------------------------------------------------

// x0[r] = [emb[r], ctx[r]] for r = g * B + b, attending over bank row b
// with q[r] = bq + q's split-K partials, summed in slice order; bank type
// T, weight type WT.
template <typename T, typename WT>
__global__ void __launch_bounds__(kThreads)
    step_attend(const StepArgs p, const Scratch s, const Dims d) {
  extern __shared__ float smem[];
  const int A = p.A, E = p.E, Em = p.Em, M = p.M;
  float* q_s = smem;        // [A]
  float* v_s = q_s + A;     // [A]
  float* ctx_s = v_s + A;   // [Em]
  float* scratch = ctx_s + Em;
  const size_t r = blockIdx.x;
  const size_t b = r % p.B;
  for (int a = threadIdx.x; a < A; a += kThreads) {
    float acc = weight<WT>(p.bq, a);
    for (int k = 0; k < d.ksq; ++k) {
      acc += s.qpart[((size_t)k * d.R + r) * A + a];
    }
    q_s[a] = acc;
    v_s[a] = weight<WT>(p.v, a);
  }
  float* xr = s.x0 + r * (E + Em);
  for (int e = threadIdx.x; e < E; e += kThreads) {
    xr[e] = weight<WT>(p.emb, r * E + e);
  }
  __syncthreads();
  attend::attend_row<T, false, kWarps>(
      q_s, v_s, static_cast<const T*>(p.proj) + b * M * A,
      static_cast<const T*>(p.mem) + b * M * Em, p.mask + b * M, M, A, Em,
      scratch, ctx_s);
  for (int e = threadIdx.x; e < Em; e += kThreads) xr[E + e] = ctx_s[e];
}

template <typename T, typename WT>
inline int run_attend(const StepArgs& p, const Scratch& s, const Dims& d,
                      cudaStream_t st) {
  const size_t bytes =
      (size_t)(2 * p.A + p.Em + attend::scratch_floats(p.Em, kWarps)) *
      sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&step_attend<T, WT>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  step_attend<T, WT><<<d.R, kThreads, bytes, st>>>(p, s, d);
  return (int)cudaGetLastError();
}

// ---- the LSTM cell ----------------------------------------------------------

// Layer l: gates = bg + the ks split-K partials (slice order), split
// i|f|g|o -> c, h [R, H] in place (rounded to bfloat16 with carry_bf16)
// and xh [R, H], the new h unrounded.
template <typename WT>
__global__ void __launch_bounds__(kThreads)
    step_cell(const StepArgs p, const Scratch s, const Dims d, int l, int ks) {
  const int H = p.H;
  const int H4 = 4 * H;
  const size_t n = (size_t)d.R * H;
  const size_t bg = (size_t)l * H4;
  float* c = p.c + (size_t)l * n;
  float* h = p.h + (size_t)l * n;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / H;
    const int j = (int)(i % H);
    float gi = weight<WT>(p.bg, bg + j), gf = weight<WT>(p.bg, bg + H + j),
          gg = weight<WT>(p.bg, bg + 2 * H + j),
          go = weight<WT>(p.bg, bg + 3 * H + j);
    for (int k = 0; k < ks; ++k) {
      const float* gp = s.gpart + ((size_t)k * d.R + r) * H4;
      gi += gp[j];
      gf += gp[H + j];
      gg += gp[2 * H + j];
      go += gp[3 * H + j];
    }
    const float cn = sigmoid_f32(gf) * c[i] + sigmoid_f32(gi) * tanhf(gg);
    const float hn = sigmoid_f32(go) * tanhf(cn);
    s.xh[i] = hn;
    c[i] = p.carry_bf16 ? attend::round_to<__nv_bfloat16>(cn) : cn;
    h[i] = p.carry_bf16 ? attend::round_to<__nv_bfloat16>(hn) : hn;
  }
}

// ---- the logits -------------------------------------------------------------

// The beam step's selection partials: for each row r and 64-column tile,
// slots(W) floats at part[(r * nT + tile) * slots(W)]: the max of the
// masked logits, the sum of exp(masked - max), the tile's top W masked
// values (value descending, then the lower column) and their columns (int
// bits; INT_MAX past V). Masked: PAD and BOS at -1e9, EOS too while
// block_eos.
struct Sel {
  float* part;
  int W;
  int block_eos;
};

__host__ __device__ inline int slots(int W) { return 2 + 2 * W; }

__device__ __forceinline__ float masked(float x, int v, bool block_eos) {
  return (v == kPad || v == kBos || (block_eos && v == kEos)) ? kNeg : x;
}

// One warp: row m's partials from its 64 staged columns (two a lane).
__device__ __forceinline__ void tile_partials(const float* row, int n0, int V,
                                              const Sel& sel, float* out) {
  const int lane = threadIdx.x & 31;
  const float v0 = row[lane];
  const float v1 = row[lane + 32];
  const int i0 = n0 + lane < V ? n0 + lane : INT_MAX;
  const int i1 = n0 + lane + 32 < V ? n0 + lane + 32 : INT_MAX;
  const float mx = warp_max(fmaxf(v0, v1));
  const float sum = warp_sum(expf(v0 - mx) + expf(v1 - mx));
  if (lane == 0) {
    out[0] = mx;
    out[1] = sum;
  }
  // W rounds: the best (value, column) behind the last round's
  float pv = INFINITY;
  int pi = -1;
  for (int k = 0; k < sel.W; ++k) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    if (ahead(pv, pi, v0, i0)) {
      bv = v0;
      bi = i0;
    }
    if (ahead(pv, pi, v1, i1) && ahead(v1, i1, bv, bi)) {
      bv = v1;
      bi = i1;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (ahead(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      out[2 + k] = bv;
      out[2 + sel.W + k] = __int_as_float(bi);
    }
    pv = bv;
    pi = bi;
  }
}

// Block (column tile x, row tile y): logits = xh Wo + bo, then with
// kBeam the selection partials of each row, else the logits themselves.
template <bool kBeam, typename WT>
__global__ void __launch_bounds__(kThreads, 2)
    step_logits(const StepArgs p, const float* xh, const Sel sel) {
  __shared__ __align__(16) float smem[Tile::kSmemFloats];
  __shared__ int rows[Tile::BM];
  constexpr int BM = Tile::BM;
  constexpr int BN = rowgemm::BN;
  static_assert(BM * BN <= Tile::kSmemFloats, "staging fits the tile");
  const int R = p.G * p.B;
  const int V = p.V;
  const int n0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const int n_rows = min(BM, R - row0);
  if (threadIdx.x < BM) rows[threadIdx.x] = row0 + threadIdx.x;
  rowgemm::Seg seg[2] = {rowgemm::Seg{xh, p.H, p.wo, p.H},
                         rowgemm::Seg{xh, p.H, p.wo, 0}};
  float acc[kTM][4];
  Tile::run<WT>(seg, 0, p.H, V, n0, rows, n_rows, smem, acc);  // syncs at end
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int col = n0 + tx * 4;
  float bias[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bias[j] = col + j < V ? weight<WT>(p.bo, col + j) : 0.0f;
  }
  if (!kBeam) {
    const bool vec = (V % 4 == 0) && aligned16(p.logits);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = ty * kTM + i;
      if (m < n_rows) {
        store4(p.logits + (size_t)(row0 + m) * V, col, V, acc[i][0] + bias[0],
               acc[i][1] + bias[1], acc[i][2] + bias[2], acc[i][3] + bias[3],
               vec);
      }
    }
    return;
  }
  // stage the masked logits [BM, BN] (-inf past V), then a warp a row
  const bool block_eos = sel.block_eos != 0;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[j] = col + j < V ? masked(acc[i][j] + bias[j], col + j, block_eos)
                         : -INFINITY;
    }
    *reinterpret_cast<float4*>(smem + (ty * kTM + i) * BN + tx * 4) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
  __syncthreads();
  const int nT = gridDim.x;
  const int S = slots(sel.W);
  for (int m = threadIdx.x >> 5; m < n_rows; m += kWarps) {
    tile_partials(smem + m * BN, n0, V, sel,
                  sel.part + ((size_t)(row0 + m) * nT + blockIdx.x) * S);
  }
}

template <bool kBeam, typename WT>
inline int run_logits(const StepArgs& p, const float* xh, const Sel& sel,
                      cudaStream_t st) {
  const dim3 grid(cdiv(p.V, rowgemm::BN), cdiv(p.G * p.B, Tile::BM));
  step_logits<kBeam, WT><<<grid, kThreads, 0, st>>>(p, xh, sel);
  return (int)cudaGetLastError();
}

// ---- the whole step ---------------------------------------------------------

// The step with weights of type WT (run below picks it).
template <typename WT>
inline int run_typed(const StepArgs& p, const Sel* sel, cudaStream_t st) {
  const Dims d = dims_of(p);
  Scratch s;
  carve(p, &s);
  const int H = p.H, H4 = 4 * p.H, X0 = p.E + p.Em;
  const size_t layer = (size_t)d.R * H;
  const float* h_top = p.h + (p.L - 1) * layer;
  Job q{{rowgemm::Seg{h_top, H, p.wq, H}, rowgemm::Seg{h_top, H, p.wq, 0}},
        p.A, d.R, s.qpart};
  int rc = run_split<WT>(q, false, st);
  if (rc) return rc;
  rc = p.bank_bf16 ? run_attend<__nv_bfloat16, WT>(p, s, d, st)
                   : run_attend<float, WT>(p, s, d, st);
  if (rc) return rc;
  const WT* wx = static_cast<const WT*>(p.wx);
  const WT* wh = static_cast<const WT*>(p.wh);
  const int cell_blocks = (int)((layer + kThreads - 1) / kThreads < 4096
                                    ? (layer + kThreads - 1) / kThreads
                                    : 4096);
  for (int l = 0; l < p.L; ++l) {
    const int n_in = l == 0 ? X0 : H;
    const float* x = l == 0 ? s.x0 : s.xh;
    Job g{{rowgemm::Seg{x, n_in, wx, n_in},
           rowgemm::Seg{p.h + l * layer, H, wh + (size_t)l * H * H4, H}},
          H4, d.R, s.gpart};
    rc = run_split<WT>(g, true, st);
    if (rc) return rc;
    step_cell<WT><<<cell_blocks, kThreads, 0, st>>>(p, s, d, l,
                                                   cdiv(n_in + H, kSplitK));
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    wx += (size_t)n_in * H4;
  }
  return sel ? run_logits<true, WT>(p, s.xh, *sel, st)
             : run_logits<false, WT>(p, s.xh, Sel{nullptr, 0, 0}, st);
}

// The step, with the logits written to p.logits (sel == nullptr) or reduced
// to sel's partials; 0 or the first launch's cudaError.
inline int run(const StepArgs& p, const Sel* sel, cudaStream_t st) {
  if (dims_of(p).R == 0) return 0;
  if (p.scratch == nullptr || p.scratch_floats < carve(p, nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return p.weights_bf16 ? run_typed<__nv_bfloat16>(p, sel, st)
                        : run_typed<float>(p, sel, st);
}

}  // namespace step

// S-step caption decode stride for NVIDIA Hopper (sm_90a), one kernel body
// with two ways of reading the encoder memory bank.
//
// Replaces the TPU kernels _stride_kernel (cst_captioning_tpu/ops/
// decode_pallas.py:449, public fused_decode_stride at :839) and
// _paged_stride_kernel (:938, public fused_decode_stride_paged at :1214).
// Per step, for every live (lane g, row b):
//
//   q      = h_top Wq + bq
//   s_m    = v . tanh(proj_m + q)        mask_m == 0 -> -1e9, m >= len -> out
//   ctx    = softmax(s) . mem
//   gates  = [emb, ctx] Wx + h Wh + b    split i|f|g|o, per LSTM layer
//   logits = h_top Wo + bo               PAD/BOS -> -1e9, EOS while t < min_len
//   token  = argmax(logits)              lane 0
//            argmax(logits / T + noise)  lanes g >= 1 (noise is data)
//   logprob = logits[token] - logsumexp(logits)
//
// Finished rows emit PAD with logprob 0 and stop doing work (their carry is
// frozen, as the TPU kernel freezes a dead block's carry); rows b >= n_active
// emit PAD/0 for every step and pass their carry through. Argmax ties go to
// the lowest token id, across column tiles too. All arithmetic is float32;
// the carry stays float32 for the whole stride. The decoder weights and
// the embedding table are float32, or bfloat16 with weights_bf16 (the
// model's parameter dtype, as the TPU kernels take them): each is widened
// to float32 where it is read (rowgemm.cuh), so a launch on bfloat16
// weights gives, bit for bit, the launch on their float32 values.
//
// Bound: per step and live (row, lane) the decoder's weights (Wq, Wx, Wh,
// Wo: 7.88 M at the msrvtt presets) take about two operations each, so
// the card's float32 rate bounds a stride, not its memory
// (chip_smoke.bound_ms counts both). The weights are 31.5 MB in float32,
// 15.8 MB in bfloat16: read once a step for all rows they fit in the 50 MB
// L2; read once per row they do not.
//
// Design: one persistent cooperative grid (occupancy x SMs blocks, all
// co-resident) walks the S steps in lockstep, with grid-wide barriers
// between the phases of a step, over the R = G * n_active rows:
//
//   init     carry and tokens into the workspace, outputs to PAD/0, the
//            carry of rows past n_active passed through; then q of step 0
//   attend   per row (a block each): the previous step's selection (merge
//            of the logits tiles' partials), the next embedding, q from its
//            split-K partials, the masked softmax and the context
//   gates    per layer: [x, h] . [Wx; Wh] as split-K row-GEMM tiles
//   cell     per layer: the partials summed with the bias, the LSTM update
//   logits   h_top Wo + bo as row-GEMM tiles whose epilogue leaves each
//            row's (max, sum of exps, best selection value, its id, its
//            logit) per 64-column tile; beside them q of the next step
//
// The GEMM tiles (rowgemm.cuh) multiply all live rows by one weight tile, so
// each weight is read once a step for every row, not once per row, in
// register-tiled FMA chains that do not wait on each other. Each block
// rebuilds the same list of live rows after every barrier, so finished rows
// cost nothing and the stride ends early, for the whole grid at once, when
// no row is live. Sums run in an order fixed by the shapes alone, so the
// dense and paged entries, and any grid size, give the same bits. This
// file builds the float32-weight kernels; decode_stride_bf16.cu (this
// file with DECODE_STRIDE_BF16_WEIGHTS defined) the bfloat16-weight ones,
// a library of its own, so the two builds run side by side. The
// workspace comes from the caller (sizes: stride_workspace in
// ops/decode_stride.py, checked here). A card that refuses the cooperative
// launch returns its error; nothing falls back. Given a timeline buffer,
// block 0 records the time it leaves each barrier (chip_smoke's
// stride_phases splits a launch's time by phase from it).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

#include "attend.cuh"
#include "rowgemm.cuh"

struct StrideArgs {
  // memory bank: dense [B, M, Em] / [B, M, A] / [B, M], or page pools
  // [N+1, P, Em] / [N+1, P, A] / [N+1, P] read through table [B, width]
  const void* mem;
  const void* proj;
  const float* mask;
  const int* table;
  // decoder weights, [in, out] layouts: float32, or bfloat16 with
  // weights_bf16
  const void* wq;       // [H, A]
  const void* bq;       // [A]
  const void* v;        // [A]
  const void* wx;       // layer 0 [E + Em, 4H], then layers 1.. [H, 4H]
  const void* wh;       // [L, H, 4H]
  const void* bg;       // [L, 4H]
  const void* wo;       // [H, V]
  const void* bo;       // [V]
  const void* embt;     // [V, E]
  // lane state
  const int* token;     // [G, B]
  const int* finished;  // [G, B]
  const int* mem_lens;  // [B]
  const float* c_in;    // [L, G, B, H]
  const float* h_in;    // [L, G, B, H]
  const float* noise;   // [S, G - 1, B, V]
  // outputs
  int* tokens;          // [S, G, B]
  float* logprobs;      // [S, G, B]
  float* c_out;         // [L, G, B, H]
  float* h_out;         // [L, G, B, H]
  int bank_bf16;        // 1: mem/proj are bfloat16, 0: float32
  int weights_bf16;     // 1: the weights above are bfloat16, 0: float32
  int slots;            // dense: M; paged: page size P
  int width;            // paged: table width in pages; dense: unused
  int G, B, S, V, E, Em, A, H, L;
  int t0, n_active, min_len;
  float temperature;
  // the caller's scratch, stride_workspace(...) floats
  float* ws;
  long long ws_floats;
  // optional: (phase code, %globaltimer ns) pairs that block 0 records as
  // it leaves each grid barrier (kPhase* below); null records nothing
  unsigned long long* timeline;
};

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = rowgemm::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 0;
constexpr int kBos = 1;
constexpr int kEos = 2;
constexpr int kSlotLanes = 8;  // lanes that score one memory slot
// k of one split-K slice of the q and gate GEMMs (SPLIT_K in
// ops/decode_stride.py, which sizes the workspace)
constexpr int kSplitK = 256;
constexpr int kMinBlocks = 2;  // resident blocks per SM
constexpr int kTM = 4;         // GEMM tile rows per thread (16 * kTM a tile)
constexpr int kBK = 32;        // k depth of one staged GEMM tile
constexpr int kStages = 2;     // cp.async buffers in the GEMM's ring
// the row-GEMM tile: 16 * kTM rows x 64 columns, k staged kBK deep in a
// ring of kStages buffers
using Tile = rowgemm::Tile<kTM, kBK, kStages>;
// timeline phase codes: the phase that ends at the mark
enum { kPhaseStart, kPhaseInit, kPhaseQ, kPhaseAttend, kPhaseGates,
       kPhaseCell, kPhaseLogits, kPhaseEnd };
using attend::kFull;
using attend::kNeg;
using attend::sigmoid_f32;
using attend::to_f32;
using attend::warp_sum;
using rowgemm::weight;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Shapes of the workspace: rows (G * B: sized for every row, used for the
// G * n_active live ones), logits column tiles, split-K slices of q and of
// the widest gate GEMM.
struct Dims {
  int R, nT, ksq, ksg;
};

__host__ __device__ inline Dims dims_of(const StrideArgs& p) {
  return Dims{p.G * p.B, cdiv(p.V, rowgemm::BN), cdiv(p.H, kSplitK),
              cdiv(imax(p.E + p.Em, p.H) + p.H, kSplitK)};
}

struct Workspace {
  float4* part;   // [R, nT] (max, sum of exps, best selection, its logit)
  int* part_i;    // [R, nT] the best selection's token id
  float* qpart;   // [ksq, R, A]
  float* gpart;   // [ksg, R, 4H]
  float* x;       // [R, E + Em] layer-0 input (emb | ctx)
  float* h;       // [L, R, H]
  float* c;       // [L, R, H]
  int* fin;       // [R]
  int* tok;       // [R]
};

struct Carve {
  float* base;
  long long off;
  __host__ __device__ float* take(long long n) {
    float* q = base ? base + off : nullptr;
    off += (n + 3) / 4 * 4;  // every region 16-byte aligned
    return q;
  }
};

// Carve the workspace (if w) and return its size in floats; the order and
// the rounding are stride_workspace's in ops/decode_stride.py.
__host__ __device__ inline long long carve(const StrideArgs& p, Workspace* w) {
  const Dims d = dims_of(p);
  const long long R = d.R;
  Carve c{w ? p.ws : nullptr, 0};
  Workspace v;
  v.part = reinterpret_cast<float4*>(c.take(4 * R * d.nT));
  v.part_i = reinterpret_cast<int*>(c.take(R * d.nT));
  v.qpart = c.take((long long)d.ksq * R * p.A);
  v.gpart = c.take((long long)d.ksg * R * 4 * p.H);
  v.x = c.take(R * (p.E + p.Em));
  v.h = c.take((long long)p.L * R * p.H);
  v.c = c.take((long long)p.L * R * p.H);
  v.fin = reinterpret_cast<int*>(c.take(R));
  v.tok = reinterpret_cast<int*>(c.take(R));
  if (w) *w = v;
  return c.off;
}

// Shared floats of one phase: the GEMM tiles, or one row's attention (q,
// scores, slot offsets). The list of live rows [G * B] follows them.
__host__ __device__ inline int phase_floats(int A, int W) {
  return imax(Tile::kSmemFloats, (A + 2 * W + 3) / 4 * 4);
}

template <typename T>
struct DenseBank {
  const T* mem;
  const T* proj;
  const float* mask;
  int M;
  __device__ __forceinline__ int slots() const { return M; }
  __device__ __forceinline__ int slot(int b, int m) const { return b * M + m; }
};

template <typename T>
struct PagedBank {
  const T* mem;
  const T* proj;
  const float* mask;
  const int* table;
  int P;
  int width;
  __device__ __forceinline__ int slots() const { return P * width; }
  __device__ __forceinline__ int slot(int b, int m) const {
    return table[b * width + m / P] * P + m % P;
  }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// online logsumexp: (m, s) stands for log(s) + m
__device__ __forceinline__ void lse_merge(float& m, float& s, float om,
                                          float os) {
  const float nm = fmaxf(m, om);
  if (nm == -INFINITY) return;
  s = s * expf(m - nm) + os * expf(om - nm);
  m = nm;
}

// running argmax: larger value wins, equal values go to the lower index
__device__ __forceinline__ void pick_merge(float& sel, int& idx, float& lg,
                                           float osel, int oidx, float olg) {
  if (osel > sel || (osel == sel && oidx < idx)) {
    sel = osel;
    idx = oidx;
    lg = olg;
  }
}

// butterfly over lanes lane ^ o, o = top .. 1: each lane ends with the
// merge of its group of 2 * top lanes
__device__ __forceinline__ void reduce_sel(float& lm, float& ls, float& best,
                                           int& best_i, float& best_lg,
                                           int top) {
  for (int o = top; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(kFull, lm, o);
    const float os = __shfl_xor_sync(kFull, ls, o);
    lse_merge(lm, ls, om, os);
    const float ob = __shfl_xor_sync(kFull, best, o);
    const int oi = __shfl_xor_sync(kFull, best_i, o);
    const float ol = __shfl_xor_sync(kFull, best_lg, o);
    pick_merge(best, best_i, best_lg, ob, oi, ol);
  }
}

// The rows r < R with fin[r] == 0, ascending, into live; returns how many.
// Every block builds the same list from the same data.
__device__ int build_live(const int* fin, int R, int* live, int* wcount) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int total = 0;
  for (int base = 0; base < R; base += kThreads) {
    const int r = base + tid;
    const bool f = r < R && __ldcg(fin + r) == 0;
    const unsigned m = __ballot_sync(kFull, f);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    int off = total;
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) off += wcount[w];
      sum += wcount[w];
    }
    if (f) live[off + __popc(m & ((1u << lane) - 1u))] = r;
    __syncthreads();
    total += sum;
  }
  __syncthreads();
  return total;
}

// One row-GEMM of a phase: Y = X[live rows] . W over k slices of kslice,
// either into split-K partials out[ks, R, N] or, with out == nullptr,
// through the selection epilogue of the logits.
struct Job {
  rowgemm::Seg seg[2];
  int N;
  int kslice;
  float* out;
};

__device__ __forceinline__ int job_slices(const Job& j) {
  return cdiv(j.seg[0].k + j.seg[1].k, j.kslice);
}

// Selection epilogue: this tile's partials for each of its rows.
template <typename WT>
__device__ __forceinline__ void select_epilogue(
    const StrideArgs& p, const Workspace& ws, const Dims& d, int step,
    int tile, int n0, const int* rows, int n_rows, float (&acc)[kTM][4]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int NA = p.n_active;
  const bool eos_blocked = p.t0 + step < p.min_len;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = ty * kTM + i;
    const bool ok = m < n_rows;
    const int r = ok ? rows[m] : 0;
    const int g = ok ? r / NA : 0;
    const int b = ok ? r % NA : 0;
    const float* nz =
        g > 0 ? p.noise + (((size_t)step * (p.G - 1) + (g - 1)) * p.B + b) * p.V
              : nullptr;
    float lm = -INFINITY;
    float ls = 0.0f;
    float best = -INFINITY;
    float best_lg = 0.0f;
    int best_i = INT_MAX;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int vv = n0 + tx * 4 + j;
      if (ok && vv < p.V) {
        float lg = acc[i][j] + weight<WT>(p.bo, vv);
        if (vv == kPad || vv == kBos || (eos_blocked && vv == kEos)) lg = kNeg;
        lse_merge(lm, ls, lg, 1.0f);
        const float sel = nz ? lg / p.temperature + nz[vv] : lg;
        if (sel > best) {  // strict: within a thread ids ascend
          best = sel;
          best_i = vv;
          best_lg = lg;
        }
      }
    }
    // the 16 threads of a tile row are lanes 16 * (ty & 1) .. + 15
    reduce_sel(lm, ls, best, best_i, best_lg, 8);
    if (tx == 0 && ok) {
      const size_t o = (size_t)r * d.nT + tile;
      ws.part[o] = make_float4(lm, ls, best, best_lg);
      ws.part_i[o] = best_i;
    }
  }
}

// The tiles of up to two jobs, spread over the grid: (column tile, row
// chunk, k slice) each; weights of type WT.
template <typename WT>
__device__ void gemm_phase(const StrideArgs& p, const Workspace& ws,
                           const Dims& d, const Job* jobs, int n_jobs,
                           const int* live, int n_live, float* smem,
                           int step) {
  const int n_rc = cdiv(n_live, Tile::BM);
  int count[2];
  int total = 0;
  for (int j = 0; j < n_jobs; ++j) {
    count[j] = cdiv(jobs[j].N, rowgemm::BN) * n_rc * job_slices(jobs[j]);
    total += count[j];
  }
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    int j = 0;
    int local = item;
    while (local >= count[j]) local -= count[j++];
    const Job& job = jobs[j];
    const int ks = job_slices(job);
    const int slice = local % ks;
    const int rest = local / ks;
    const int rc = rest % n_rc;
    const int ct = rest / n_rc;
    const int k_all = job.seg[0].k + job.seg[1].k;
    const int kb = slice * job.kslice;
    const int ke = min(k_all, kb + job.kslice);
    const int* rows = live + rc * Tile::BM;
    const int n_rows = min(Tile::BM, n_live - rc * Tile::BM);
    const int n0 = ct * rowgemm::BN;
    float acc[kTM][4];
    Tile::run<WT>(job.seg, kb, ke, job.N, n0, rows, n_rows, smem, acc);
    if (job.out == nullptr) {
      select_epilogue<WT>(p, ws, d, step, ct, n0, rows, n_rows, acc);
      continue;
    }
    float* out = job.out + (size_t)slice * d.R * job.N;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = ty * kTM + i;
      if (m >= n_rows) continue;
      float* o = out + (size_t)rows[m] * job.N;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = n0 + tx * 4 + jj;
        if (col < job.N) o[col] = acc[i][jj];
      }
    }
  }
}

// Merge row r's logits partials of `step`: write its token and logprob,
// mark it finished on EOS. Returns the token (the same in every thread).
__device__ int select_row(const StrideArgs& p, const Workspace& ws,
                          const Dims& d, int r, int step, float* red,
                          int* red_i) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float lm = -INFINITY;
  float ls = 0.0f;
  float best = -INFINITY;
  float best_lg = 0.0f;
  int best_i = INT_MAX;
  for (int t = tid; t < d.nT; t += kThreads) {
    const size_t o = (size_t)r * d.nT + t;
    const float4 pt = __ldcg(ws.part + o);
    lse_merge(lm, ls, pt.x, pt.y);
    pick_merge(best, best_i, best_lg, pt.z, __ldcg(ws.part_i + o), pt.w);
  }
  reduce_sel(lm, ls, best, best_i, best_lg, 16);
  if (lane == 0) {
    red[warp] = lm;
    red[kWarps + warp] = ls;
    red[2 * kWarps + warp] = best;
    red[3 * kWarps + warp] = best_lg;
    red_i[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    const bool has = lane < kWarps;
    lm = has ? red[lane] : -INFINITY;
    ls = has ? red[kWarps + lane] : 0.0f;
    best = has ? red[2 * kWarps + lane] : -INFINITY;
    best_lg = has ? red[3 * kWarps + lane] : 0.0f;
    best_i = has ? red_i[lane] : INT_MAX;
    reduce_sel(lm, ls, best, best_i, best_lg, 16);
    if (lane == 0) {
      const int NA = p.n_active;
      const size_t out = ((size_t)step * p.G + r / NA) * p.B + r % NA;
      p.tokens[out] = best_i;
      p.logprobs[out] = best_lg - (lm + logf(ls));
      ws.tok[r] = best_i;
      if (best_i == kEos) ws.fin[r] = 1;
      red_i[kWarps] = best_i;
    }
  }
  __syncthreads();
  const int tok = red_i[kWarps];
  __syncthreads();  // red_i is reused by the next row
  return tok;
}

// One row's attention for the step: x[r] = (emb of tok | ctx).
template <class Bank, typename WT>
__device__ void attend_row(const StrideArgs& p, const Bank& bank,
                           const Workspace& ws, const Dims& d, int r, int tok,
                           float* smem) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int A = p.A, E = p.E, Em = p.Em;
  const int W = bank.slots();
  const int b = r % p.n_active;
  float* q = smem;                                 // [A]
  float* att = q + A;                              // [W]
  int* slot_of = reinterpret_cast<int*>(att + W);  // [W]
  float* xr = ws.x + (size_t)r * (E + Em);
  for (int e = tid; e < E; e += kThreads) {
    xr[e] = weight<WT>(p.embt, (size_t)tok * E + e);
  }
  for (int a = tid; a < A; a += kThreads) {
    float acc = weight<WT>(p.bq, a);
    for (int k = 0; k < d.ksq; ++k) {
      acc += __ldcg(ws.qpart + ((size_t)k * d.R + r) * A + a);
    }
    q[a] = acc;
  }
  const int len = min(max(p.mem_lens[b], 1), W);
  for (int m = tid; m < len; m += kThreads) slot_of[m] = bank.slot(b, m);
  __syncthreads();
  // scores: eight lanes per memory slot, 32 slots at a time
  const int grp = tid / kSlotLanes;
  const int sub = tid % kSlotLanes;
  for (int m0 = 0; m0 < len; m0 += kThreads / kSlotLanes) {
    const int m = m0 + grp;
    float acc = 0.0f;
    if (m < len) {
      const size_t base = (size_t)slot_of[m] * A;
      for (int a = sub; a < A; a += kSlotLanes) {
        acc += tanhf(to_f32(bank.proj[base + a]) + q[a]) *
               weight<WT>(p.v, a);
      }
    }
    for (int o = kSlotLanes / 2; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(kFull, acc, o);
    }
    if (m < len && sub == 0) {
      att[m] = bank.mask[slot_of[m]] > 0.0f ? acc : kNeg;
    }
  }
  __syncthreads();
  // softmax over the row's slots (slots past len carry exactly 0 weight)
  if (warp == 0) {
    float mx = -INFINITY;
    for (int m = lane; m < len; m += 32) mx = fmaxf(mx, att[m]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int m = lane; m < len; m += 32) {
      const float e = expf(att[m] - mx);
      att[m] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int m = lane; m < len; m += 32) att[m] = att[m] / sum;
  }
  __syncthreads();
  // context: columns over the threads, four independent slot chains each
  for (int e = tid; e < Em; e += kThreads) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int m = 0;
    for (; m + 4 <= len; m += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[u] = fmaf(att[m + u],
                      to_f32(bank.mem[(size_t)slot_of[m + u] * Em + e]),
                      acc[u]);
      }
    }
    for (int u = 0; m < len; ++m, ++u) {
      acc[u] = fmaf(att[m], to_f32(bank.mem[(size_t)slot_of[m] * Em + e]),
                    acc[u]);
    }
    xr[E + e] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  __syncthreads();  // smem is reused by the next row
}

// The gate GEMM of layer l: [x_l, h_l] . [Wx_l; Wh_l] into split-K partials.
template <typename WT>
__device__ __forceinline__ Job gate_job(const StrideArgs& p,
                                        const Workspace& ws, const Dims& d,
                                        int l) {
  const int H4 = 4 * p.H;
  const size_t layer = (size_t)d.R * p.H;
  const WT* wx = static_cast<const WT*>(p.wx);
  const WT* wh = static_cast<const WT*>(p.wh);
  Job j;
  if (l == 0) {
    j.seg[0] = rowgemm::Seg{ws.x, p.E + p.Em, wx, p.E + p.Em};
  } else {
    j.seg[0] = rowgemm::Seg{
        ws.h + (l - 1) * layer, p.H,
        wx + (size_t)(p.E + p.Em) * H4 + (size_t)(l - 1) * p.H * H4, p.H};
  }
  j.seg[1] = rowgemm::Seg{ws.h + l * layer, p.H, wh + (size_t)l * p.H * H4,
                          p.H};
  j.N = H4;
  j.kslice = kSplitK;
  j.out = ws.gpart;
  return j;
}

// q = h_top Wq into split-K partials (the bias is added where it is read).
__device__ __forceinline__ Job q_job(const StrideArgs& p, const Workspace& ws,
                                     const Dims& d) {
  Job j;
  j.seg[0] = rowgemm::Seg{ws.h + (size_t)(p.L - 1) * d.R * p.H, p.H, p.wq,
                          p.H};
  j.seg[1] = rowgemm::Seg{ws.h, p.H, p.wq, 0};
  j.N = p.A;
  j.kslice = kSplitK;
  j.out = ws.qpart;
  return j;
}

// logits = h_top Wo, one k slice, through the selection epilogue.
__device__ __forceinline__ Job logits_job(const StrideArgs& p,
                                          const Workspace& ws, const Dims& d) {
  Job j;
  j.seg[0] = rowgemm::Seg{ws.h + (size_t)(p.L - 1) * d.R * p.H, p.H, p.wo,
                          p.H};
  j.seg[1] = rowgemm::Seg{ws.h, p.H, p.wo, 0};
  j.N = p.V;
  j.kslice = p.H;
  j.out = nullptr;
  return j;
}

__device__ __forceinline__ void mark(const StrideArgs& p, int& n, int code) {
  if (p.timeline != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.timeline[2 * n] = code;
    p.timeline[2 * n + 1] = t;
  }
  ++n;
}

template <class Bank, typename WT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    stride_kernel(const StrideArgs p, const Bank bank) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[4 * kWarps];
  __shared__ int red_i[kWarps + 1];
  const int tid = threadIdx.x;
  const int G = p.G, B = p.B, H = p.H, L = p.L, S = p.S, NA = p.n_active;
  const int H4 = 4 * H;
  const int R = G * NA;
  const Dims d = dims_of(p);
  Workspace ws;
  carve(p, &ws);
  int* live = reinterpret_cast<int*>(smem + phase_floats(p.A, bank.slots()));
  const size_t gtid = (size_t)blockIdx.x * kThreads + tid;
  const size_t gstride = (size_t)gridDim.x * kThreads;
  int marks = 0;
  mark(p, marks, kPhaseStart);

  // ---- init: outputs PAD/0, the carry in (or through), lane state
  for (size_t i = gtid; i < (size_t)S * G * B; i += gstride) {
    p.tokens[i] = kPad;
    p.logprobs[i] = 0.0f;
  }
  for (size_t i = gtid; i < (size_t)L * G * B * H; i += gstride) {
    const size_t lgb = i / H;
    const int b = (int)(lgb % B);
    if (b >= NA) {
      p.c_out[i] = p.c_in[i];
      p.h_out[i] = p.h_in[i];
      continue;
    }
    const int g = (int)((lgb / B) % G);
    const int l = (int)(lgb / ((size_t)B * G));
    const size_t o = ((size_t)l * d.R + g * NA + b) * H + i % H;
    ws.c[o] = p.c_in[i];
    ws.h[o] = p.h_in[i];
  }
  for (size_t r = gtid; r < (size_t)R; r += gstride) {
    const int gb = (int)(r / NA) * B + (int)(r % NA);
    ws.fin[r] = p.finished[gb] != 0;
    ws.tok[r] = p.token[gb];
  }
  grid.sync();
  mark(p, marks, kPhaseInit);
  int n_live = build_live(ws.fin, R, live, red_i);
  Job jobs[2];
  jobs[0] = q_job(p, ws, d);
  gemm_phase<WT>(p, ws, d, jobs, 1, live, n_live, smem, 0);
  grid.sync();
  mark(p, marks, kPhaseQ);

  int pending = -1;  // the step whose logits partials wait for selection
  for (int s = 0; s < S; ++s) {
    // ---- attend: the last step's selection, then this step's context
    for (int i = blockIdx.x; i < n_live; i += gridDim.x) {
      const int r = live[i];
      const int tok = pending >= 0 ? select_row(p, ws, d, r, pending, red,
                                                red_i)
                                   : __ldcg(ws.tok + r);
      if (tok == kEos && pending >= 0) continue;
      attend_row<Bank, WT>(p, bank, ws, d, r, tok, smem);
    }
    pending = -1;
    grid.sync();
    mark(p, marks, kPhaseAttend);
    n_live = build_live(ws.fin, R, live, red_i);
    if (n_live == 0) break;  // the same in every block
    // ---- LSTM stack
    for (int l = 0; l < L; ++l) {
      jobs[0] = gate_job<WT>(p, ws, d, l);
      gemm_phase<WT>(p, ws, d, jobs, 1, live, n_live, smem, s);
      grid.sync();
      mark(p, marks, kPhaseGates);
      const int ks = job_slices(jobs[0]);
      const size_t bg = (size_t)l * H4;
      float* c = ws.c + (size_t)l * d.R * H;
      float* h = ws.h + (size_t)l * d.R * H;
      for (size_t i = gtid; i < (size_t)n_live * H; i += gstride) {
        const int r = live[i / H];
        const int j = (int)(i % H);
        float gi = weight<WT>(p.bg, bg + j),
              gf = weight<WT>(p.bg, bg + H + j),
              gg = weight<WT>(p.bg, bg + 2 * H + j),
              go = weight<WT>(p.bg, bg + 3 * H + j);
        for (int k = 0; k < ks; ++k) {
          const float* gp = ws.gpart + ((size_t)k * d.R + r) * H4;
          gi += __ldcg(gp + j);
          gf += __ldcg(gp + H + j);
          gg += __ldcg(gp + 2 * H + j);
          go += __ldcg(gp + 3 * H + j);
        }
        const size_t o = (size_t)r * H + j;
        const float cn = sigmoid_f32(gf) * __ldcg(c + o) +
                         sigmoid_f32(gi) * tanhf(gg);
        c[o] = cn;
        h[o] = sigmoid_f32(go) * tanhf(cn);
      }
      grid.sync();
      mark(p, marks, kPhaseCell);
    }
    // ---- logits with their selection partials, and the next step's q
    int n_jobs = 0;
    if (s + 1 < S) jobs[n_jobs++] = q_job(p, ws, d);
    jobs[n_jobs++] = logits_job(p, ws, d);
    gemm_phase<WT>(p, ws, d, jobs, n_jobs, live, n_live, smem, s);
    grid.sync();
    mark(p, marks, kPhaseLogits);
    pending = s;
  }
  // ---- the last step's selection (if the stride ran to its end), carry out
  if (pending >= 0) {
    for (int i = blockIdx.x; i < n_live; i += gridDim.x) {
      select_row(p, ws, d, live[i], pending, red, red_i);
    }
  }
  for (size_t i = gtid; i < (size_t)L * R * H; i += gstride) {
    const size_t lr = i / H;
    const int r = (int)(lr % R);
    const int l = (int)(lr / R);
    const size_t o =
        (((size_t)l * G + r / NA) * B + r % NA) * H + i % H;
    const size_t src = ((size_t)l * d.R + r) * H + i % H;
    p.c_out[o] = __ldcg(ws.c + src);
    p.h_out[o] = __ldcg(ws.h + src);
  }
  mark(p, marks, kPhaseEnd);
}

template <class Bank, typename WT>
int launch_typed(const StrideArgs& p, const Bank& bank, int W,
                 cudaStream_t stream) {
  if (p.ws == nullptr || p.ws_floats < carve(p, nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const void* fn = reinterpret_cast<const void*>(&stride_kernel<Bank, WT>);
  const size_t bytes =
      ((size_t)phase_floats(p.A, W) + (size_t)p.G * p.B) * sizeof(float);
  // the grid for (device, shared bytes), worked out on first use
  static int cached_dev = -1;
  static size_t cached_bytes = 0;
  static int cached_blocks = 0;
  if (dev != cached_dev || bytes != cached_bytes) {
    int coop = 0;
    int sms = 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (!coop) return (int)cudaErrorNotSupported;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      bytes);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cached_blocks = (per_sm < kMinBlocks ? per_sm : kMinBlocks) * sms;
    cached_dev = dev;
    cached_bytes = bytes;
  }
  void* args[] = {const_cast<StrideArgs*>(&p), const_cast<Bank*>(&bank)};
  e = cudaLaunchCooperativeKernel(fn, dim3(cached_blocks), dim3(kThreads),
                                  args, bytes, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// This library's weight type (see the header comment).
#ifdef DECODE_STRIDE_BF16_WEIGHTS
using LibWeight = __nv_bfloat16;
#else
using LibWeight = float;
#endif

// The stride kernel of this library's weight type; arguments that name
// the other type are refused.
template <class Bank>
int launch(const StrideArgs& p, const Bank& bank, int W, cudaStream_t stream) {
  if (p.weights_bf16 != (int)std::is_same<LibWeight, __nv_bfloat16>::value) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_typed<Bank, LibWeight>(p, bank, W, stream);
}

}  // namespace

extern "C" {

// Dense bank: mem [B, M, Em], proj [B, M, A], mask [B, M]; slots = M.
int decode_stride_dense(const StrideArgs* args, void* stream) {
  const StrideArgs& p = *args;
  if (p.B == 0 || p.S == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.bank_bf16) {
    const DenseBank<__nv_bfloat16> bank{
        static_cast<const __nv_bfloat16*>(p.mem),
        static_cast<const __nv_bfloat16*>(p.proj), p.mask, p.slots};
    return launch(p, bank, p.slots, st);
  }
  const DenseBank<float> bank{static_cast<const float*>(p.mem),
                              static_cast<const float*>(p.proj), p.mask,
                              p.slots};
  return launch(p, bank, p.slots, st);
}

// Paged bank: pools [N+1, P, *] (page 0 the zero page) + table [B, width];
// slots = P.
int decode_stride_paged(const StrideArgs* args, void* stream) {
  const StrideArgs& p = *args;
  if (p.B == 0 || p.S == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = p.slots * p.width;
  if (p.bank_bf16) {
    const PagedBank<__nv_bfloat16> bank{
        static_cast<const __nv_bfloat16*>(p.mem),
        static_cast<const __nv_bfloat16*>(p.proj), p.mask, p.table, p.slots,
        p.width};
    return launch(p, bank, W, st);
  }
  const PagedBank<float> bank{static_cast<const float*>(p.mem),
                              static_cast<const float*>(p.proj), p.mask,
                              p.table, p.slots, p.width};
  return launch(p, bank, W, st);
}

// Floats of workspace a launch with these arguments needs (what the launch
// checks the caller's against).
long long decode_stride_workspace_floats(const StrideArgs* args) {
  return carve(*args, nullptr);
}

const char* decode_stride_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

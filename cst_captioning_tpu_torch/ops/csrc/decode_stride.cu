// S-step caption decode stride for NVIDIA Hopper (sm_90a), one kernel body
// with two ways of reading the encoder memory bank.
//
// Replaces the TPU kernels fused_decode_stride (_stride_kernel) and
// fused_decode_stride_paged (_paged_stride_kernel) of
// cst_captioning_tpu/ops/decode_pallas.py. Per step, per (row b, lane g):
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
// the lowest token id. All arithmetic is float32; the carry stays float32 for
// the whole stride. The next step's embedding is read by index from the
// [V, E] table.
//
// Design: one thread block per (row, lane) walks the S steps and, inside a
// step, the vocab in strides of the block width; x, h, c, the gates and the
// attention weights live in shared memory. The page table is plain address
// arithmetic: each row's slot offsets are resolved once per launch.
//
// Bound: per step and (row, lane) the block reads Wq + Wx + Wh + Wo (7.90 M
// float32 weights at the msrvtt_xe_attention preset) and does about two
// operations per weight, so the card's float32 rate bounds the stride,
// not its memory. This first design re-reads every weight once per block
// from L2 and launches only B*G blocks; it sits far from that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

#include "attend.cuh"

struct StrideArgs {
  // memory bank: dense [B, M, Em] / [B, M, A] / [B, M], or page pools
  // [N+1, P, Em] / [N+1, P, A] / [N+1, P] read through table [B, width]
  const void* mem;
  const void* proj;
  const float* mask;
  const int* table;
  // decoder weights, float32, [in, out] layouts
  const float* wq;      // [H, A]
  const float* bq;      // [A]
  const float* v;       // [A]
  const float* wx;      // layer 0 [E + Em, 4H], then layers 1.. [H, 4H]
  const float* wh;      // [L, H, 4H]
  const float* bg;      // [L, 4H]
  const float* wo;      // [H, V]
  const float* bo;      // [V]
  const float* embt;    // [V, E]
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
  int slots;            // dense: M; paged: page size P
  int width;            // paged: table width in pages; dense: unused
  int G, B, S, V, E, Em, A, H, L;
  int t0, n_active, min_len;
  float temperature;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 0;
constexpr int kBos = 1;
constexpr int kEos = 2;
using attend::kFull;
using attend::kNeg;
using attend::sigmoid_f32;
using attend::to_f32;
using attend::warp_sum;

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

// butterfly over a warp: every lane ends with the warp's result
__device__ __forceinline__ void warp_reduce_step(float& lm, float& ls,
                                                 float& best, int& best_i,
                                                 float& best_lg) {
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(kFull, lm, o);
    const float os = __shfl_xor_sync(kFull, ls, o);
    lse_merge(lm, ls, om, os);
    const float ob = __shfl_xor_sync(kFull, best, o);
    const int oi = __shfl_xor_sync(kFull, best_i, o);
    const float ol = __shfl_xor_sync(kFull, best_lg, o);
    pick_merge(best, best_i, best_lg, ob, oi, ol);
  }
}

template <class Bank>
__global__ void __launch_bounds__(kThreads)
    stride_kernel(const StrideArgs p, const Bank bank) {
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = p.G, B = p.B, H = p.H, A = p.A, E = p.E, Em = p.Em;
  const int V = p.V, L = p.L;
  const int H4 = 4 * H;
  const int W = bank.slots();
  const int x_len = max(E + Em, H);
  const size_t row = (size_t)g * B + b;          // index into [G, B]
  const size_t layer_stride = (size_t)G * B * H;  // of [L, G, B, H]

  if (b >= p.n_active) {
    // compacted away: frozen outputs, carry passed through
    for (int s = tid; s < p.S; s += kThreads) {
      p.tokens[((size_t)s * G + g) * B + b] = kPad;
      p.logprobs[((size_t)s * G + g) * B + b] = 0.0f;
    }
    for (int i = tid; i < L * H; i += kThreads) {
      const size_t o = (i / H) * layer_stride + row * H + i % H;
      p.c_out[o] = p.c_in[o];
      p.h_out[o] = p.h_in[o];
    }
    return;
  }

  extern __shared__ float smem[];
  float* x = smem;               // [x_len] layer input: (emb | ctx), then h
  float* gates = x + x_len;      // [4H]
  float* cs = gates + H4;        // [L, H]
  float* hs = cs + L * H;        // [L, H]
  float* q = hs + L * H;         // [A]
  float* att = q + A;            // [W] scores, then softmax weights
  float* red = att + W;          // [4, kWarps] cross-warp reduction
  int* red_i = reinterpret_cast<int*>(red + 4 * kWarps);  // [kWarps]
  int* slot_of = red_i + kWarps;                          // [W]
  __shared__ int next_tok;

  for (int i = tid; i < L * H; i += kThreads) {
    const size_t o = (i / H) * layer_stride + row * H + i % H;
    cs[i] = p.c_in[o];
    hs[i] = p.h_in[o];
  }
  const int len = min(max(p.mem_lens[b], 1), W);
  for (int m = tid; m < len; m += kThreads) slot_of[m] = bank.slot(b, m);
  const int tok0 = p.token[row];
  for (int e = tid; e < E; e += kThreads) x[e] = p.embt[(size_t)tok0 * E + e];
  bool fin = p.finished[row] != 0;
  const int K = G - 1;
  __syncthreads();

  for (int s = 0; s < p.S; ++s) {
    const size_t out = ((size_t)s * G + g) * B + b;
    if (fin) {  // uniform over the block
      if (tid == 0) {
        p.tokens[out] = kPad;
        p.logprobs[out] = 0.0f;
      }
      continue;
    }
    // query projection of the top layer's hidden state
    const float* h_top = hs + (L - 1) * H;
    for (int a = tid; a < A; a += kThreads) {
      float acc = 0.0f;
      for (int k = 0; k < H; ++k) acc = fmaf(h_top[k], p.wq[(size_t)k * A + a], acc);
      q[a] = acc + p.bq[a];
    }
    __syncthreads();
    // scores: one warp per memory slot of this row
    for (int m = warp; m < len; m += kWarps) {
      const size_t base = (size_t)slot_of[m] * A;
      float acc = 0.0f;
      for (int a = lane; a < A; a += 32) {
        acc += tanhf(to_f32(bank.proj[base + a]) + q[a]) * p.v[a];
      }
      acc = warp_sum(acc);
      if (lane == 0) att[m] = bank.mask[slot_of[m]] > 0.0f ? acc : kNeg;
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
    for (int e = tid; e < Em; e += kThreads) {
      float acc = 0.0f;
      for (int m = 0; m < len; ++m) {
        acc = fmaf(att[m], to_f32(bank.mem[(size_t)slot_of[m] * Em + e]), acc);
      }
      x[E + e] = acc;
    }
    __syncthreads();
    // LSTM stack
    const float* wx = p.wx;
    int n_in = E + Em;
    for (int l = 0; l < L; ++l) {
      const float* wh = p.wh + (size_t)l * H * H4;
      const float* bg = p.bg + (size_t)l * H4;
      float* c = cs + l * H;
      float* h = hs + l * H;
      for (int j = tid; j < H4; j += kThreads) {
        float ax = 0.0f;
        float ah = 0.0f;
        for (int k = 0; k < n_in; ++k) ax = fmaf(x[k], wx[(size_t)k * H4 + j], ax);
        for (int k = 0; k < H; ++k) ah = fmaf(h[k], wh[(size_t)k * H4 + j], ah);
        gates[j] = ax + ah + bg[j];
      }
      __syncthreads();
      for (int j = tid; j < H; j += kThreads) {
        const float ig = sigmoid_f32(gates[j]);
        const float fg = sigmoid_f32(gates[H + j]);
        const float gg = tanhf(gates[2 * H + j]);
        const float og = sigmoid_f32(gates[3 * H + j]);
        const float cn = fg * c[j] + ig * gg;
        const float hn = og * tanhf(cn);
        c[j] = cn;
        h[j] = hn;
        x[j] = hn;
      }
      __syncthreads();
      wx += (size_t)n_in * H4;
      n_in = H;
    }
    // vocab projection with online logsumexp and selection
    const float* hx = hs + (L - 1) * H;
    const bool eos_blocked = p.t0 + s < p.min_len;
    const float* nz =
        g > 0 ? p.noise + (((size_t)s * K + (g - 1)) * B + b) * V : nullptr;
    float lm = -INFINITY;
    float ls = 0.0f;
    float best = -INFINITY;
    float best_lg = 0.0f;
    int best_i = INT_MAX;
    for (int vv = tid; vv < V; vv += kThreads) {
      float acc = 0.0f;
      for (int k = 0; k < H; ++k) acc = fmaf(hx[k], p.wo[(size_t)k * V + vv], acc);
      float lg = acc + p.bo[vv];
      if (vv == kPad || vv == kBos || (eos_blocked && vv == kEos)) lg = kNeg;
      lse_merge(lm, ls, lg, 1.0f);
      const float sel = nz ? lg / p.temperature + nz[vv] : lg;
      if (sel > best) {  // strict: within a thread ids ascend
        best = sel;
        best_i = vv;
        best_lg = lg;
      }
    }
    warp_reduce_step(lm, ls, best, best_i, best_lg);
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
      warp_reduce_step(lm, ls, best, best_i, best_lg);
      if (lane == 0) {
        p.tokens[out] = best_i;
        p.logprobs[out] = best_lg - (lm + logf(ls));
        next_tok = best_i;
      }
    }
    __syncthreads();
    const int tok = next_tok;
    fin = tok == kEos;
    for (int e = tid; e < E; e += kThreads) x[e] = p.embt[(size_t)tok * E + e];
    __syncthreads();
  }

  for (int i = tid; i < L * H; i += kThreads) {
    const size_t o = (i / H) * layer_stride + row * H + i % H;
    p.c_out[o] = cs[i];
    p.h_out[o] = hs[i];
  }
}

template <class Bank>
int launch(const StrideArgs& p, const Bank& bank, int W, cudaStream_t stream) {
  const int x_len = p.E + p.Em > p.H ? p.E + p.Em : p.H;
  const size_t floats =
      (size_t)x_len + 4 * p.H + 2 * p.L * p.H + p.A + W + 4 * kWarps;
  const size_t bytes = floats * sizeof(float) + (kWarps + W) * sizeof(int);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&stride_kernel<Bank>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(p.B, p.G);
  stride_kernel<Bank><<<grid, kThreads, bytes, stream>>>(p, bank);
  return (int)cudaGetLastError();
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

const char* decode_stride_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

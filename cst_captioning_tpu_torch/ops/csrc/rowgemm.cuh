// A register-tiled row GEMM tile for one thread block of 256 threads
// (sm_90a), float32 arithmetic, for kernels that multiply a few hundred
// activation rows by a weight matrix that every row shares:
//
//   Y[m, n0:n0+BN] = sum_k X[rows[m], k] W[k, n]     m < n_rows <= BM
//
// K runs over two segments laid end to end, so [x, h] . [Wx; Wh] is one
// tile with no concatenated copy of either operand:
//
//   k <  seg[0].k : X = seg[0].x [*, ldx], W = seg[0].w [seg[0].k, N]
//   k >= seg[0].k : X = seg[1].x [*, ldx], W = seg[1].w [seg[1].k, N]
//
// and a tile may cover a k slice [k_begin, k_end) of it (split-K). Each
// thread keeps a TM x 4 (rows x columns) accumulator in registers, so every
// weight it loads from shared memory serves TM rows and every activation
// four columns, in 4 * TM independent FMA chains. Weight and activation
// tiles go to shared memory with cp.async (16 bytes a copy where the
// shapes and pointers allow, else 4) into a ring of STAGES buffers, so the
// copies of k tiles t + 1 .. t + STAGES - 1 are in flight under the FMAs
// of tile t. The 16-byte copies go through L2 only (the activation rows
// are written by other blocks of the same launch). Rows past n_rows,
// columns past N and k past k_end read as zero.
//
// The weights are float32 or bfloat16: the weight type WT is a template
// parameter of Tile::run (the kernels pick the instance from their
// run-time weights_bf16 flag), as the TPU kernels take the decoder weights
// in the parameter dtype and widen them in the body. A bfloat16 weight
// tile is staged as bfloat16, half the bytes of a float32 one (8 columns a
// 16-byte cp.async where N % 8 == 0 and the pointers allow; else element
// by element, exact for any N), and each weight is widened to float32 as
// it is read from shared memory. The widening is exact and the FMA order
// is the same, so a tile fed bfloat16 weights gives, bit for bit, what it
// gives fed their float32 values. weight<WT> reads the kernels' other
// weights (biases, score vector, embedding rows) the same way.
//
// Row and column order inside a sum are fixed by k alone, so a result does
// not depend on which block computes it or on which other rows share its
// tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace rowgemm {

constexpr int kThreads = 256;
constexpr int BN = 64;            // columns of a tile: 16 threads x 4

struct Seg {
  const float* x;  // activation rows, row r at x + r * ldx
  int ldx;
  const void* w;   // [k, N] row-major, of the tile's weight type
  int k;
};

// The float32 value of element i of a weight array of type WT (bfloat16
// widens exactly: its bits are the high half of the float's).
template <typename WT>
__device__ __forceinline__ float weight(const void* w, size_t i) {
  if constexpr (std::is_same<WT, float>::value) {
    return static_cast<const float*>(w)[i];
  } else {
    static_assert(std::is_same<WT, __nv_bfloat16>::value, "float or bf16");
    return __uint_as_float(
        static_cast<unsigned>(static_cast<const uint16_t*>(w)[i]) << 16);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_stages(int pending) {
  // wait until at most `pending` (0, 1 or 2) copy groups are in flight
  if (pending >= 2) {
    asm volatile("cp.async.wait_group 2;\n" ::);
  } else if (pending == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
}

// A tile of BM = 16 * TM rows by BN columns, k staged BK deep in a ring of
// STAGES shared-memory buffers (2 to 4): each of the 256 threads (ty = tid
// / 16, tx = tid % 16) accumulates rows ty * TM .. + TM by columns tx * 4
// .. + 4.
template <int TM, int BK, int STAGES>
struct Tile {
  static_assert(STAGES >= 2 && STAGES <= 4, "2 to 4 stages");
  static constexpr int BM = 16 * TM;
  static constexpr int XS = BK + 4;  // activation row stride in smem
  static constexpr int kXFloats = BM * XS;
  static constexpr int kWFloats = BK * BN;
  static constexpr int kStageFloats = kXFloats + kWFloats;
  // shared floats one tile needs
  static constexpr int kSmemFloats = STAGES * kStageFloats;

  // Weight rows k_tile .. + BK of columns n0 .. + BN into ws [BK, BN] of
  // WT: float32 four columns a copy (16 bytes with vec, else four 4-byte
  // copies); bfloat16 eight columns a copy (16 bytes with vec), else
  // element by element through registers (N and the pointers allow no
  // copy of whole 4-byte pairs).
  template <typename WT>
  static __device__ __forceinline__ void load_w(const Seg* seg, int k_tile,
                                                int k_end, int N, int n0,
                                                bool vec, float* ws) {
    const int tid = threadIdx.x;
    if constexpr (std::is_same<WT, float>::value) {
      const float* w0 = static_cast<const float*>(seg[0].w);
      const float* w1 = static_cast<const float*>(seg[1].w);
#pragma unroll
      for (int i = 0; i < (BK * BN / 4) / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int kr = idx / (BN / 4);
        const int c = (idx % (BN / 4)) * 4;
        const int kk = k_tile + kr;
        const int col = n0 + c;
        const float* src = w0;
        int valid = 0;
        if (kk < k_end && col < N) {
          src = kk < seg[0].k ? w0 + (size_t)kk * N + col
                              : w1 + (size_t)(kk - seg[0].k) * N + col;
          valid = min(N - col, 4);
        }
        float* dst = ws + kr * BN + c;
        if (vec) {
          cp_async16(dst, src, valid * 4);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            cp_async4(dst + j, j < valid ? src + j : w0, j < valid ? 4 : 0);
          }
        }
      }
    } else {
      static_assert((BK * BN / 8) % kThreads == 0, "whole bf16 copies");
      const uint16_t* w0 = static_cast<const uint16_t*>(seg[0].w);
      const uint16_t* w1 = static_cast<const uint16_t*>(seg[1].w);
      uint16_t* wsb = reinterpret_cast<uint16_t*>(ws);
#pragma unroll
      for (int i = 0; i < (BK * BN / 8) / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int kr = idx / (BN / 8);
        const int c = (idx % (BN / 8)) * 8;
        const int kk = k_tile + kr;
        const int col = n0 + c;
        const uint16_t* src = w0;
        int valid = 0;
        if (kk < k_end && col < N) {
          src = kk < seg[0].k ? w0 + (size_t)kk * N + col
                              : w1 + (size_t)(kk - seg[0].k) * N + col;
          valid = min(N - col, 8);
        }
        uint16_t* dst = wsb + kr * BN + c;
        if (vec) {
          cp_async16(dst, src, valid * 2);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) dst[j] = j < valid ? src[j] : 0;
        }
      }
    }
  }

  // Four weights of shared-memory row k at columns c .. c + 3 as float32.
  template <typename WT>
  static __device__ __forceinline__ float4 w4(const float* ws, int k,
                                              int c) {
    if constexpr (std::is_same<WT, float>::value) {
      return *reinterpret_cast<const float4*>(ws + k * BN + c);
    } else {
      const uint2 r = *reinterpret_cast<const uint2*>(
          reinterpret_cast<const uint16_t*>(ws) + k * BN + c);
      return make_float4(__uint_as_float(r.x << 16),
                         __uint_as_float(r.x & 0xffff0000u),
                         __uint_as_float(r.y << 16),
                         __uint_as_float(r.y & 0xffff0000u));
    }
  }

  // Activation rows of k tile k_tile into xs [BM, XS]: four k a copy. With
  // vec, 16 bytes through L2 only (.cg); else four 4-byte copies.
  static __device__ __forceinline__ void load_x(const Seg* seg, int k_tile,
                                                int k_end, const int* rows,
                                                int n_rows, bool vec,
                                                float* xs) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < (BM * BK / 4) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int m = idx / (BK / 4);
      const int kc = (idx % (BK / 4)) * 4;
      const int kk = k_tile + kc;
      const float* src = seg[0].x;
      int valid = 0;
      if (m < n_rows && kk < k_end) {
        const int r = rows[m];
        src = kk < seg[0].k
                  ? seg[0].x + (size_t)r * seg[0].ldx + kk
                  : seg[1].x + (size_t)r * seg[1].ldx + (kk - seg[0].k);
        valid = min(k_end - kk, 4);
      }
      float* dst = xs + m * XS + kc;
      if (vec) {
        cp_async16(dst, src, valid * 4);
      } else {
        // a 4-wide group may straddle the two segments
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* sj = seg[0].x;
          int bytes = 0;
          if (j < valid) {
            const int r = rows[m];
            const int kj = kk + j;
            sj = kj < seg[0].k
                     ? seg[0].x + (size_t)r * seg[0].ldx + kj
                     : seg[1].x + (size_t)r * seg[1].ldx + (kj - seg[0].k);
            bytes = 4;
          }
          cp_async4(dst + j, sj, bytes);
        }
      }
    }
  }

  // acc[i][j] = Y[ty * TM + i, n0 + tx * 4 + j] over k in [k_begin, k_end),
  // the weights of type WT (float or __nv_bfloat16). rows: the tile's row
  // indices (n_rows <= BM of them). smem: kSmemFloats floats, 16-byte
  // aligned. Every thread of the block calls it; it starts and ends with a
  // barrier.
  template <typename WT>
  static __device__ __forceinline__ void run(const Seg* seg, int k_begin,
                                             int k_end, int N, int n0,
                                             const int* rows, int n_rows,
                                             float* smem,
                                             float (&acc)[TM][4]) {
    const int tid = threadIdx.x;
    const int ty = tid / 16;
    const int tx = tid % 16;
    const auto aligned = [](const void* q) {
      return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
    };
    const bool two = seg[1].k > 0;
    // 16-byte weight copies: whole rows of 16-byte groups
    constexpr int kWVec = 16 / sizeof(WT);
    const bool wvec = (N % kWVec == 0) && aligned(seg[0].w) &&
                      (!two || aligned(seg[1].w));
    // 16-byte activation copies: rows and the segment seam on 4-float
    // boundaries (k_begin and BK are multiples of 4 by construction)
    const bool xvec = (seg[0].ldx % 4 == 0) && aligned(seg[0].x) &&
                      (k_begin % 4 == 0) && (k_end % 4 == 0) &&
                      (!two || ((seg[0].k % 4 == 0) &&
                                (seg[1].ldx % 4 == 0) && aligned(seg[1].x)));
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    }
    const int nt = (k_end - k_begin + BK - 1) / BK;
    __syncthreads();  // the previous user of smem is done
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nt) {
        float* buf = smem + st * kStageFloats;
        load_w<WT>(seg, k_begin + st * BK, k_end, N, n0, wvec,
                   buf + kXFloats);
        load_x(seg, k_begin + st * BK, k_end, rows, n_rows, xvec, buf);
      }
      cp_async_commit();
    }
    for (int t = 0; t < nt; ++t) {
      cp_async_wait_stages(STAGES - 2);  // tile t has landed
      __syncthreads();  // ... for every thread; tile t - 1's buffer is free
      const int ahead = t + STAGES - 1;
      if (ahead < nt) {
        float* buf = smem + (ahead % STAGES) * kStageFloats;
        load_w<WT>(seg, k_begin + ahead * BK, k_end, N, n0, wvec,
                   buf + kXFloats);
        load_x(seg, k_begin + ahead * BK, k_end, rows, n_rows, xvec, buf);
      }
      cp_async_commit();
      const float* stage = smem + (t % STAGES) * kStageFloats;
      const float* xb = stage + ty * TM * XS;
      const float* wb = stage + kXFloats;
#pragma unroll
      for (int k4 = 0; k4 < BK; k4 += 4) {
        float4 a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          a[i] = *reinterpret_cast<const float4*>(xb + i * XS + k4);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 w = w4<WT>(wb, k4 + kk, tx * 4);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float av = kk == 0   ? a[i].x
                             : kk == 1 ? a[i].y
                             : kk == 2 ? a[i].z
                                       : a[i].w;
            acc[i][0] = fmaf(av, w.x, acc[i][0]);
            acc[i][1] = fmaf(av, w.y, acc[i][1]);
            acc[i][2] = fmaf(av, w.z, acc[i][2]);
            acc[i][3] = fmaf(av, w.w, acc[i][3]);
          }
        }
      }
    }
    cp_async_wait_stages(0);
    __syncthreads();
  }
};

}  // namespace rowgemm

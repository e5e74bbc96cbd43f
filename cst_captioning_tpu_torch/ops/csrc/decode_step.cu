// One caption decode step for NVIDIA Hopper (sm_90a): attention, the LSTM
// stack and the vocab projection for every (lane, row) of a [G, B] batch,
// logits [G, B, V] float32 out, the carry stepped in place.
//
// Replaces the TPU kernel fused_decode_step (_kernel, _fused_call) of
// cst_captioning_tpu/ops/decode_pallas.py. The step's math and its five
// kernels live in step.cuh, which the beam step (beam_step.cu) shares.
//
// Design: the (G*B) rows are one batch of matrix products, each a tiled
// GEMM whose weight tiles are shared by the 64 rows of a block instead of
// re-read per (row, lane) as in the stride kernel.
//
// Bound: at G=5, B=64 and the msrvtt width the step does about 5.1 GFLOP
// of float32 multiply-adds (Wx, Wh and Wo dominate) and moves about 50 MB
// (float32 weights 31.6 MB, logits 11.5 MB, bank 5.5 MB): the card's
// float32 rate bounds it (0.076 ms at 67 TFLOP/s), not its memory. These
// GEMMs run on the CUDA cores in full float32, as the plain version does
// with TF32 off; the tensor cores would need TF32 or bf16 rounding.

#include <cuda_runtime.h>

#include "step.cuh"

extern "C" {

int decode_step(const StepArgs* args, void* stream) {
  return step::run(*args, static_cast<cudaStream_t>(stream));
}

const char* decode_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

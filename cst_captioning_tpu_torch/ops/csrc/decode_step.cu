// One caption decode step for NVIDIA Hopper (sm_90a): attention, the LSTM
// stack and the vocab projection for every (lane, row) of a [G, B] batch,
// logits [G, B, V] float32 out, the carry stepped in place.
//
// Replaces the TPU kernel fused_decode_step of
// cst_captioning_tpu/ops/decode_pallas.py (public fn :358, _kernel :162,
// _fused_call :241, pallas_call :340). The step's launches live in
// step.cuh, which the beam step (beam_step.cu) shares.
//
// Bound: at G=5, B=64 and the msrvtt width the step does about 5.1 GFLOP
// of float32 multiply-adds (Wx, Wh and Wo dominate) and moves about 50 MB
// (float32 weights 31.6 MB, 15.8 MB as the bfloat16 weights of a bfloat16
// model; logits 11.5 MB, bank 5.5 MB): the card's float32 rate bounds it
// (0.076 ms at 67 TFLOP/s), not its memory. These
// GEMMs run on the CUDA cores in full float32, as the plain version does
// with TF32 off; the tensor cores would need TF32 or bf16 rounding.
//
// Design: the (G*B) lane rows are one batch of matrix products on the
// stride kernel's register-tiled, cp.async double-buffered row-GEMM tiles
// (rowgemm.cuh), each weight tile shared by 64 rows: q and the gates split
// into 256-deep k slices so that the gate GEMM has 192 blocks at G=1 (64
// rows) and 960 at G=5 (320 rows), the partials summed with the bias in
// the attention and cell launches that read them, and the logits GEMM's
// epilogue adding the bias as it writes the logits. Separate launches on
// the caller's stream, not one persistent grid: a single step has nothing
// to amortise a cooperative grid's barriers over.

#include <cuda_runtime.h>

#include "step.cuh"

extern "C" {

int decode_step(const StepArgs* args, void* stream) {
  return step::run(*args, nullptr, static_cast<cudaStream_t>(stream));
}

// Floats of scratch a launch with these arguments needs (what the launch
// checks the caller's against).
long long decode_step_scratch_floats(const StepArgs* args) {
  return step::carve(*args, nullptr);
}

const char* decode_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

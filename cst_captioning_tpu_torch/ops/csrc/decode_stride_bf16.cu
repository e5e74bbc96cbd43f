// The stride kernels of decode_stride.cu on bfloat16 decoder weights (the
// weights_bf16 launches), built as a library of their own beside the
// float32-weight one so that the two compile side by side.

#define DECODE_STRIDE_BF16_WEIGHTS
#include "decode_stride.cu"

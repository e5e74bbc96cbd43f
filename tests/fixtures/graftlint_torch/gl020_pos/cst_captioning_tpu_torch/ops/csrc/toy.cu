#include "toy.cuh"

extern "C" {

int toy_launch(const ToyArgs* args, void* stream) {
  if (args->n == 0) return 0;
  return 0;
}

long long toy_scratch_floats(const ToyArgs* args) { return args->n; }

}  // extern "C"

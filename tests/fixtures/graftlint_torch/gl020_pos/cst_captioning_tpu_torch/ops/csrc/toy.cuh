struct ToyArgs {
  const float* x;       // [n]
  float* out;           // [n]
  long long scratch;
  int n, bf16;
  float scale;
};

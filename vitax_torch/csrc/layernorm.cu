// LN kernel: replaces _ln_fwd_kernel (vitax/ops/pallas_kernels.py:267),
// reached through layer_norm (:383) for the encoder's final norm.
//
// Bound on the H100: device memory. It moves 2*N*D*sizeof(T) bytes (read x,
// write y) plus the two parameter vectors, and does ~8 flops a value, far
// below the ~295 flops a byte at which the tensor cores would become the limit.
// Design (layernorm.cuh): one warp a row holds its lane's share of the row in
// registers (d <= 1280), all of the row's 16-byte loads issued together, and
// walks rows over a grid of the card's resident blocks, issuing the next
// row's loads before the current row's warp-shuffle reductions; γ and β are
// read once a block into shared memory. Wider rows loop over the row in three
// passes. The TPU kernel's 512-row VMEM blocks have no counterpart: rows are
// independent and a warp needs no staging.
#include "layernorm.cuh"

extern "C" int vitax_layer_norm(const void* x, const void* gamma, const void* beta, void* y,
                                int n, int d, float eps, int is_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  if (is_bf16) {
    return vitax::launch_layer_norm(static_cast<const vitax::bf16*>(x), g, b,
                                    static_cast<vitax::bf16*>(y), n, d, eps, st);
  }
  return vitax::launch_layer_norm(static_cast<const float*>(x), g, b, static_cast<float*>(y), n,
                                  d, eps, st);
}

extern "C" const char* vitax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

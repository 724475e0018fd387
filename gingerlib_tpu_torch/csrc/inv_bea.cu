// K2: modular inverse of plain integers by the binary extended Euclidean
// algorithm,  out = a^-1 mod p,  0 -> 0,  result canonical (< p).
//
// Replaces inv_bea_pallas / _bea_core of gingerlib_tpu/ops/pallas_mont.py.
// The TPU kernel runs a fixed bound of masked iterations over a whole tile
// because its lanes cannot branch; a CUDA thread can, so each thread runs
// the textbook data-dependent loop on its own element (u, v, b, c in
// registers as 32-bit limbs) and stops when u or v reaches 1.  The loop is
// gl::inv_bea_mem of fp_limbs.cuh, which the Poseidon kernel (poseidon.cu)
// runs per thread as well.
//
// This is a latency kernel: on the proving path the batch is ONE element
// (the root of a shared-inversion tree, or the Z of one point), so a single
// thread works through roughly 2 * bits(p) halvings and subtractions of L
// limbs each while the rest of the card idles.  The serial dependency chain
// bounds it.  The bound that chip_smoke.py prints for it (the limb
// operations this input needs over the card's peak integer rate; the bytes
// are fewer still) is a floor from counting, not a time one serial thread
// could reach.  Batching is already done one level up (batch_inverse_tree),
// so nothing here tries to spread one inverse over several threads.
#include <cuda_runtime.h>
#include <string.h>

#include "fp_limbs.cuh"

namespace {

template <int ND>
__global__ void __launch_bounds__(64)
inv_bea_kernel(const long long* __restrict__ a, long long* __restrict__ out,
               int n, const gl::FpConst<ND / 2> K) {
  constexpr int L = ND / 2;
  __shared__ uint32_t P[L];
  if (threadIdx.x < L) P[threadIdx.x] = K.p[threadIdx.x];
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[L], y[L];
  gl::load_digits<L>(a + (size_t)i * ND, x);
  gl::inv_bea_mem<L>(x, P, y);
  gl::store_digits<L>(out + (size_t)i * ND, y);
}

template <int ND>
int launch(const void* a, void* out, int n, const uint32_t* p_limbs,
           void* stream) {
  gl::FpConst<ND / 2> K;
  memcpy(K.p, p_limbs, sizeof(K.p));
  K.inv = 0;
  const int threads = 64;
  int blocks = (n + threads - 1) / threads;
  inv_bea_kernel<ND><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)a, (long long*)out, n, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() of the launch, or -1 for a digit count that was
// not built.
extern "C" int gl_inv_bea(int nd, const void* a, void* out, int n,
                          const uint32_t* p_limbs, void* stream) {
  if (n <= 0) return 0;
  switch (nd) {
    case 16: return launch<16>(a, out, n, p_limbs, stream);
    case 24: return launch<24>(a, out, n, p_limbs, stream);
    case 48: return launch<48>(a, out, n, p_limbs, stream);
    default: return -1;
  }
}

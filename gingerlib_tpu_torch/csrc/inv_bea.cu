// K2: modular inverse of plain integers by the binary extended Euclidean
// algorithm,  out = a^-1 mod p,  0 -> 0,  result canonical (< p).
//
// Replaces inv_bea_pallas / _bea_core of gingerlib_tpu/ops/pallas_mont.py.
// The TPU kernel runs a fixed bound of masked iterations over a whole tile
// because its lanes cannot branch; a CUDA thread can, so each thread runs
// the textbook data-dependent loop on its own element (u, v, b, c in
// registers as 32-bit limbs) and stops when u or v reaches 1.
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
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t u[L], v[L], b[L], c[L], t[L];
  gl::load_digits<L>(a + (size_t)i * ND, u);
#pragma unroll
  for (int j = 0; j < L; j++) {
    v[j] = K.p[j];
    b[j] = 0;
    c[j] = 0;
  }
  b[0] = 1;

  if (!gl::is_zero<L>(u)) {
    // every pass of the outer loop removes at least one bit from u or v,
    // so 2 * 32 * L + 2 passes suffice for any input coprime to p; the cap
    // only keeps a malformed input (a multiple of p) from spinning forever
    int guard = 64 * L + 2;
    while (!gl::is_one<L>(u) && !gl::is_one<L>(v) && guard-- > 0) {
      while ((u[0] & 1u) == 0 && !gl::is_zero<L>(u)) {
        gl::shr1<L>(u, 0);
        gl::half_mod<L>(b, K.p);
      }
      while ((v[0] & 1u) == 0) {
        gl::shr1<L>(v, 0);
        gl::half_mod<L>(c, K.p);
      }
      uint32_t borrow = gl::sub_limbs<L>(u, v, t);
      if (borrow == 0) {  // u >= v
#pragma unroll
        for (int j = 0; j < L; j++) u[j] = t[j];
        gl::sub_mod<L>(b, c, K.p, t);
#pragma unroll
        for (int j = 0; j < L; j++) b[j] = t[j];
      } else {
        gl::sub_limbs<L>(v, u, t);
#pragma unroll
        for (int j = 0; j < L; j++) v[j] = t[j];
        gl::sub_mod<L>(c, b, K.p, t);
#pragma unroll
        for (int j = 0; j < L; j++) c[j] = t[j];
      }
    }
    bool take_b = gl::is_one<L>(u);
#pragma unroll
    for (int j = 0; j < L; j++) t[j] = take_b ? b[j] : c[j];
  } else {
#pragma unroll
    for (int j = 0; j < L; j++) t[j] = 0;
  }
  gl::store_digits<L>(out + (size_t)i * ND, t);
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

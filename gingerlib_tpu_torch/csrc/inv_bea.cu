// K2: modular inverse of plain integers,  out = a^-1 mod p,  0 -> 0,
// result canonical (< p).
//
// Replaces inv_bea_pallas / _bea_core of gingerlib_tpu/ops/pallas_mont.py.
// The TPU kernel runs a fixed bound of masked binary-Euclid iterations over
// a whole tile because its lanes cannot branch.  Here each thread inverts
// its own element by batched divsteps, gl::inv_divsteps of fp_inv.cuh (the
// Poseidon kernel, poseidon.cu, runs its group form on a block's root): each
// pass runs 31 divsteps on 64-bit approximations of x and y in registers,
// then applies their 2x2 matrix to the full-width x, y and to the Bezout
// coefficients u, v mod p (x, y, u, v: 4 L words in registers), until
// x = 0.  The inverse is unique, so the digits are those of the binary
// Euclid.
//
// This is a latency kernel: on the proving path the batch is ONE element
// (the root of a shared-inversion tree, or the Z of one point), so a single
// thread works through its passes -- 33-36 for a random 753-bit input, at
// most 49 -- while the rest of the card idles.  The serial dependency chain
// of the passes bounds it: each is ~31 dependent divsteps on two-word
// values and ~10 L dependent multiply-adds.  The bound that chip_smoke.py
// prints for it (the operations of this input's passes over the card's
// peak integer rate; the bytes are fewer still) is a floor from counting,
// not a time one serial thread could reach.  Batching is done one level up
// (batch_inverse_tree), so nothing here spreads one inverse over several
// threads.
#include <cuda_runtime.h>
#include <string.h>

#include "fp_inv.cuh"
#include "fp_limbs.cuh"

namespace {

template <int ND>
__global__ void __launch_bounds__(64)
inv_bea_kernel(const long long* __restrict__ a, long long* __restrict__ out,
               int n, const gl::FpConst<gl::limbs_of<ND>> K) {
  constexpr int L = gl::limbs_of<ND>;
  __shared__ uint32_t P[L];
  if (threadIdx.x < L) P[threadIdx.x] = K.p[threadIdx.x];
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[L];
  gl::load_digits<L, ND>(a + (size_t)i * ND, x);
  gl::inv_divsteps<L>(x, P, K.inv, x);
  gl::store_digits<L, ND>(out + (size_t)i * ND, x);
}

template <int ND>
int launch(const void* a, void* out, int n, const uint32_t* p_limbs,
           uint32_t inv, void* stream) {
  gl::FpConst<gl::limbs_of<ND>> K;
  memcpy(K.p, p_limbs, sizeof(K.p));
  K.inv = inv;
  const int threads = 64;
  int blocks = (n + threads - 1) / threads;
  inv_bea_kernel<ND><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)a, (long long*)out, n, K);
  return (int)cudaGetLastError();
}

}  // namespace

// inv: -p^-1 mod 2^32.  Returns cudaGetLastError() of the launch, or -1 for
// a digit count that was not built.
extern "C" int gl_inv_bea(int nd, const void* a, void* out, int n,
                          const uint32_t* p_limbs, uint32_t inv,
                          void* stream) {
  if (n <= 0) return 0;
  switch (nd) {
    case 16: return launch<16>(a, out, n, p_limbs, inv, stream);
    case 19: return launch<19>(a, out, n, p_limbs, inv, stream);
    case 24: return launch<24>(a, out, n, p_limbs, inv, stream);
    case 48: return launch<48>(a, out, n, p_limbs, inv, stream);
    case 49: return launch<49>(a, out, n, p_limbs, inv, stream);
    default: return -1;
  }
}

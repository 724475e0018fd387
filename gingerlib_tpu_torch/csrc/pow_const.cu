// K3: a^e for one fixed exponent e, Montgomery form in and out, result
// canonical (< p):  r = 1;  for each bit of e, most significant first:
// r = r^2, and r = r * a where the bit is set.
//
// Replaces _pow_kernel / pow_const_pallas of gingerlib_tpu/ops/pallas_mont.py,
// which runs the ladder over a tile of 8 or 256 rows with the running power
// in the TPU's on-chip memory and the bits scalar-prefetched.  Here one
// thread runs the whole ladder for one element, in one launch for the whole
// batch: the running power and the base stay in thread-local storage, each
// step calls the non-inlined multiply of fp_limbs.cuh (the registers of one
// multiply), and the exponent travels with the launch as a packed bit array
// in the kernel-parameter constant bank (every thread reads the same bit:
// one broadcast, no divergence).
//
// What bounds it on an H100: the multiplies, bits(e) + popcount(e) of them an
// element at 2*L*L + L 32x32->64-bit multiply-adds each, against reading and
// writing one element.  Each thread's multiplies form one dependent chain,
// so a small batch (the field API's single elements) is latency: a 753-bit
// exponent is some 1130 multiplies in sequence.
#include <cuda_runtime.h>
#include <string.h>

#include "fp_limbs.cuh"

namespace {

constexpr int kMaxBits = 1024;  // above the 768 bits of the widest field built

// exponent bit k (MSB first) is bit k % 32 of w[k / 32]
struct PowBits {
  uint32_t w[kMaxBits / 32];
};

template <int ND>
__global__ void __launch_bounds__(64)
pow_const_kernel(const long long* __restrict__ a, long long* __restrict__ out,
                 int n, int nbits, const PowBits E,
                 const gl::CurveConst<ND / 2> K) {
  constexpr int L = ND / 2;
  __shared__ uint32_t C[3 * L];
  gl::stage_consts<L>(K, C);
  const uint32_t* P = C;
  const uint32_t* ONE = C + 2 * L;

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[L], r[L];
  gl::load_digits<L>(a + (size_t)i * ND, x);
  gl::copy_limbs<L>(ONE, r);
  for (int k = 0; k < nbits; k++) {
    gl::mont_mul_mem<L>(r, r, P, K.inv, r);
    if ((E.w[k >> 5] >> (k & 31)) & 1u) gl::mont_mul_mem<L>(r, x, P, K.inv, r);
  }
  gl::store_digits<L>(out + (size_t)i * ND, r);
}

template <int ND>
int launch(const void* a, void* out, int n, const PowBits& E, int nbits,
           const uint32_t* consts, uint32_t inv, void* stream) {
  const int threads = 64;
  int blocks = (n + threads - 1) / threads;
  pow_const_kernel<ND><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)a, (long long*)out, n, nbits, E,
      gl::make_curve_const<ND / 2>(consts, inv, 0));
  return (int)cudaGetLastError();
}

}  // namespace

// a, out: dense [n, nd] digits; bits: nbits host bytes, each 0 or 1, most
// significant first; consts: 3*nd/2 host limbs [p | a | one] (a is not
// read).  Returns cudaGetLastError() of the launch, -1 for a digit count that
// was not built, -2 for an exponent longer than kMaxBits.
extern "C" int gl_pow_const(int nd, const void* a, void* out, int n,
                            const unsigned char* bits, int nbits,
                            const uint32_t* consts, uint32_t inv,
                            void* stream) {
  if (n <= 0) return 0;
  if (nbits < 0 || nbits > kMaxBits) return -2;
  PowBits E;
  memset(&E, 0, sizeof(E));
  for (int k = 0; k < nbits; k++)
    if (bits[k]) E.w[k >> 5] |= 1u << (k & 31);
  switch (nd) {
    case 16: return launch<16>(a, out, n, E, nbits, consts, inv, stream);
    case 24: return launch<24>(a, out, n, E, nbits, consts, inv, stream);
    case 48: return launch<48>(a, out, n, E, nbits, consts, inv, stream);
    default: return -1;
  }
}

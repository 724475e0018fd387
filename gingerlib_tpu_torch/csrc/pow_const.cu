// K3: a^e for one fixed exponent e, Montgomery form in and out, result
// canonical (< p), by a fixed window of w bits:
//
//   table a^1 .. a^(2^w - 1) (2^w - 2 multiplies);
//   e's bits, padded on the left to a multiple of w, as digits d_0 d_1 ...
//   (most significant first); from the first non-zero digit d_k:
//   r = a^(d_k), then for each later digit w squarings and, where the
//   digit is not zero, one multiply by a^digit.
//
// An exponent without a set bit (or of no bits) gives one.  The launcher
// picks w from the exponent: the w in 1 .. 5 that takes the fewest
// multiplies, squarings + non-zero digits after the first + 2^w - 2 (ties:
// the smaller w), which is w = 5 for the Legendre and square-root
// exponents of MNT4-753's fields (927, 911, 923 and 892 multiplies, where
// the binary ladder of bits + popcount takes 1,127, 1,111, 1,124 and
// 1,093); ops and tests reproduce it as fields/fp.pow_window.  Above 5 the
// table would outgrow shared memory, and only exponents longer than the
// widest field's gain (an all-ones 1,024-bit exponent: 1,252 multiplies at
// w = 6, 1,254 at 5).
//
// Replaces _pow_kernel / pow_const_pallas of gingerlib_tpu/ops/pallas_mont.py,
// which runs the binary ladder over a tile of 8 or 256 rows with the
// running power in the TPU's on-chip memory and the bits scalar-prefetched.
// Here a group of G threads owns an element (fp_group.cuh; G = 8 at 48
// digits, 4 at 24 and 16), blocks of 128 threads, the whole chain in one
// launch: every square and multiply is the group's (grp_mont_mul), each
// thread holding L / G limbs of the running power in registers; the group
// keeps its element's table in shared memory, each thread its own limbs of
// each entry (no barrier between a group's stores and loads).  The digits
// travel with the launch in the kernel-parameter constant bank, as the
// bits did: every thread reads the same digit, so the branch on a zero
// digit is uniform.
//
// What bounds it on an H100: the chain of multiplies, 2 L^2 + L 32x32->64
// multiply-adds each, against reading and writing one element.  Each
// element's multiplies form one dependent chain, so a small batch (the
// field API's single elements) is latency, some 900 multiplies in
// sequence; the group shortens each multiply's chain about G-fold (plus
// two shuffles a row), the window takes a fifth of the chain away.
#include <cuda_runtime.h>
#include <string.h>

#include "fp_group.cuh"
#include "pow_window.h"

namespace {

constexpr int kMaxBits = 1024;  // above the 768 bits of the widest field built
constexpr int THREADS = 128;

// digit k (most significant first), each below 2^w
struct PowDigits {
  unsigned char d[kMaxBits];
};

template <int ND>
constexpr int group_size() { return ND == 48 ? 8 : 4; }

template <int ND, int G>
__global__ void __launch_bounds__(THREADS)
pow_const_kernel(const long long* __restrict__ a, long long* __restrict__ out,
                 int n, int ndig, int w, const PowDigits E,
                 const gl::CurveConst<ND / 2> K) {
  constexpr int L = ND / 2;
  using Grp = gl::Grp<L, G>;
  constexpr int M = Grp::M;
  __shared__ uint32_t C[3 * L];
  extern __shared__ uint32_t tables[];
  gl::stage_consts<L>(K, C);

  const int q = threadIdx.x / G;
  const long long i = (long long)blockIdx.x * (THREADS / G) + q;
  if (i >= n) return;  // the whole group: its threads share i
  const Grp g = Grp::of_thread();
  const int entries = (1 << w) - 1;
  uint32_t* tab = tables + q * entries * L;  // a^(e + 1) at value e
  uint32_t P[M], r[M];
  gl::grp_ld_sh<L, G>(g, C, 0, P);
  gl::grp_ld_sh<L, G>(g, C, 2, r);           // one

  int k = 0;
  while (k < ndig && E.d[k] == 0) k++;
  if (k < ndig) {
    uint32_t x[M], t[M];
    gl::grp_load<L, G>(g, a + i * ND, x);
    gl::grp_st_sh<L, G>(g, tab, 0, x);
    gl::part_copy<M>(x, t);
#pragma unroll 1
    for (int e = 1; e < entries; e++) {
      gl::grp_mont_mul<L, G>(g, t, x, P, K.inv, t);
      gl::grp_st_sh<L, G>(g, tab, e, t);
    }
    gl::grp_ld_sh<L, G>(g, tab, E.d[k] - 1, r);
#pragma unroll 1
    for (k++; k < ndig; k++) {
#pragma unroll 1
      for (int s = 0; s < w; s++)
        gl::grp_mont_mul<L, G>(g, r, r, P, K.inv, r);
      const int d = E.d[k];
      if (d) {
        gl::grp_ld_sh<L, G>(g, tab, d - 1, t);
        gl::grp_mont_mul<L, G>(g, r, t, P, K.inv, r);
      }
    }
  }
  gl::grp_store<L, G>(g, out + i * ND, r);
}

template <int ND>
int launch(const void* a, void* out, int n, const PowDigits& E, int ndig,
           int w, const uint32_t* consts, uint32_t inv, void* stream) {
  constexpr int G = group_size<ND>();
  constexpr int L = ND / 2;
  static int opened[gl::MAX_DEVICES];
  const int bytes = (THREADS / G) * ((1 << w) - 1) * L * (int)sizeof(uint32_t);
  cudaError_t e = gl::open_smem(pow_const_kernel<ND, G>, bytes, opened);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = ((long long)n * G + THREADS - 1) / THREADS;
  pow_const_kernel<ND, G><<<(unsigned)blocks, THREADS, bytes,
                            (cudaStream_t)stream>>>(
      (const long long*)a, (long long*)out, n, ndig, w, E,
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
  const int w = gl::pick_window(bits, nbits);
  PowDigits E;
  memset(&E, 0, sizeof(E));
  const int ndig = gl::window_digits(bits, nbits, w, E.d);
  switch (nd) {
    case 16: return launch<16>(a, out, n, E, ndig, w, consts, inv, stream);
    case 24: return launch<24>(a, out, n, E, ndig, w, consts, inv, stream);
    case 48: return launch<48>(a, out, n, E, ndig, w, consts, inv, stream);
    default: return -1;
  }
}

// The window the launcher takes for this exponent (bits as gl_pow_const's),
// and in *muls the multiplies of its chain; -2 for an exponent longer than
// kMaxBits.
extern "C" int gl_pow_const_window(const unsigned char* bits, int nbits,
                                   int* muls) {
  if (nbits < 0 || nbits > kMaxBits) return -2;
  const int w = gl::pick_window(bits, nbits);
  *muls = gl::window_muls(bits, nbits, w);
  return w;
}

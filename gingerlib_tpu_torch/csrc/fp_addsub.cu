// Elementwise modular add, subtract and negate on the digit layout.
//
// These have no TPU kernel of their own: in the JAX package XLA fuses the
// few dozen array operations of add_mod/sub_mod/neg_mod into its
// surroundings.  Eager PyTorch cannot, and an elliptic-curve addition holds
// about as many modular adds and subtracts as multiplies, so in plain form
// their launches, not the multiplies, would set the prover's time.  One
// thread owns one element: one carry chain, one conditional correction by p
// (the same code as the tail of the Montgomery multiply).  Bound by bytes:
// 3 * ND * 2 of information per element, moved as 3 * ND * 8 in the int64
// boundary layout; so it streams tiles through shared memory as mont_mul.cu
// does (fp_limbs.cuh, tile_loop): coalesced accesses, the next tile in
// flight while the current one is added.
//
// Row addressing as in mont_mul.cu: element i reads row i % x_rows of x,
// rows x_stride digits apart.  Built at 16, 19, 24, 48 and 49 digits (at
// an odd count the top limb is one digit; add and subtract need no R).
#include <cuda_runtime.h>
#include <string.h>

#include "fp_limbs.cuh"

namespace {

enum Op { OP_ADD = 0, OP_SUB = 1, OP_NEG = 2 };

constexpr int T = 128;  // threads a block = elements a tile

template <int ND, int OP>
__global__ void __launch_bounds__(T)
addsub_kernel(const long long* __restrict__ a, int a_rows, long long a_stride,
              const long long* __restrict__ b, int b_rows, long long b_stride,
              long long* __restrict__ out, int n,
              const gl::FpConst<gl::limbs_of<ND>> K) {
  constexpr int L = gl::limbs_of<ND>;
  extern __shared__ uint32_t smem[];
  gl::tile_loop<L, T, OP == OP_NEG ? 1 : 2, ND>(
      a, a_rows, a_stride, b, b_rows, b_stride, out, n, smem,
      [&](const uint32_t (&x)[L], const uint32_t (&y)[L], uint32_t (&r)[L]) {
        if constexpr (OP == OP_NEG) {
          // -x mod p: p - x, except 0 -> 0
          if (gl::is_zero<L>(x)) {
#pragma unroll
            for (int j = 0; j < L; j++) r[j] = 0;
          } else {
            gl::sub_limbs<L>(K.p, x, r);
          }
        } else if constexpr (OP == OP_ADD) {
          gl::add_mod<L>(x, y, K.p, r);
        } else {
          gl::sub_mod<L>(x, y, K.p, r);
        }
      });
}

template <int ND, int OP>
int launch_op(const long long* a, int a_rows, long long a_stride,
              const long long* b, int b_rows, long long b_stride,
              long long* out, int n, const gl::FpConst<gl::limbs_of<ND>>& K,
              cudaStream_t s) {
  static int resident[gl::MAX_DEVICES] = {};
  int blocks, bytes;
  cudaError_t e = gl::tile_loop_launch<gl::limbs_of<ND>, T,
                                       OP == OP_NEG ? 1 : 2>(
      addsub_kernel<ND, OP>, n, resident, blocks, bytes);
  if (e != cudaSuccess) return (int)e;
  addsub_kernel<ND, OP><<<blocks, T, bytes, s>>>(a, a_rows, a_stride, b,
                                                 b_rows, b_stride, out, n, K);
  return (int)cudaGetLastError();
}

template <int ND>
int launch(int op, const void* a, int a_rows, long long a_stride,
           const void* b, int b_rows, long long b_stride, void* out, int n,
           const uint32_t* p_limbs, void* stream) {
  gl::FpConst<gl::limbs_of<ND>> K;
  memcpy(K.p, p_limbs, sizeof(K.p));
  K.inv = 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* pa = (const long long*)a;
  const long long* pb = (const long long*)b;
  long long* po = (long long*)out;
  switch (op) {
    case OP_ADD:
      return launch_op<ND, OP_ADD>(pa, a_rows, a_stride, pb, b_rows, b_stride, po, n, K, s);
    case OP_SUB:
      return launch_op<ND, OP_SUB>(pa, a_rows, a_stride, pb, b_rows, b_stride, po, n, K, s);
    case OP_NEG:
      return launch_op<ND, OP_NEG>(pa, a_rows, a_stride, pa, a_rows, a_stride, po, n, K, s);
    default:
      return -2;
  }
}

}  // namespace

// op: 0 add, 1 sub, 2 neg (b ignored).  Returns the CUDA error of the launch
// or of its set-up (0: none), -1 for a digit count that was not built, -2
// for an unknown op.
extern "C" int gl_fp_addsub(int nd, int op, const void* a, int a_rows,
                            long long a_stride, const void* b, int b_rows,
                            long long b_stride, void* out, int n,
                            const uint32_t* p_limbs, void* stream) {
  if (n <= 0) return 0;
  switch (nd) {
    case 16: return launch<16>(op, a, a_rows, a_stride, b, b_rows, b_stride, out, n, p_limbs, stream);
    case 19: return launch<19>(op, a, a_rows, a_stride, b, b_rows, b_stride, out, n, p_limbs, stream);
    case 24: return launch<24>(op, a, a_rows, a_stride, b, b_rows, b_stride, out, n, p_limbs, stream);
    case 48: return launch<48>(op, a, a_rows, a_stride, b, b_rows, b_stride, out, n, p_limbs, stream);
    case 49: return launch<49>(op, a, a_rows, a_stride, b, b_rows, b_stride, out, n, p_limbs, stream);
    default: return -1;
  }
}

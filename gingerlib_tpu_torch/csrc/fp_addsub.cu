// Elementwise modular add, subtract and negate on the digit layout.
//
// These have no TPU kernel of their own: in the JAX package XLA fuses the
// few dozen array operations of add_mod/sub_mod/neg_mod into its
// surroundings.  Eager PyTorch cannot, and an elliptic-curve addition holds
// about as many modular adds and subtracts as multiplies, so in plain form
// their launches, not the multiplies, would set the prover's time.  One
// thread owns one element: pack the digits into limbs, one carry chain, one
// conditional correction by p (the same code as the tail of the Montgomery
// multiply), unpack.  Bound by bytes: 3 * ND * 2 of information per element,
// moved as 3 * ND * 8 in the int64 boundary layout.
//
// Row addressing as in mont_mul.cu: thread i reads row i % x_rows of x,
// rows x_stride digits apart.
#include <cuda_runtime.h>
#include <string.h>

#include "fp_limbs.cuh"

namespace {

enum Op { OP_ADD = 0, OP_SUB = 1, OP_NEG = 2 };

template <int ND, int OP>
__global__ void __launch_bounds__(128)
addsub_kernel(const long long* __restrict__ a, int a_rows, long long a_stride,
              const long long* __restrict__ b, int b_rows, long long b_stride,
              long long* __restrict__ out, int n,
              const gl::FpConst<ND / 2> K) {
  constexpr int L = ND / 2;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[L], y[L], r[L];
  gl::load_digits<L>(a + (size_t)(i % a_rows) * a_stride, x);
  if (OP == OP_NEG) {
    // -x mod p: p - x, except 0 -> 0
    if (gl::is_zero<L>(x)) {
#pragma unroll
      for (int j = 0; j < L; j++) r[j] = 0;
    } else {
      gl::sub_limbs<L>(K.p, x, r);
    }
  } else {
    gl::load_digits<L>(b + (size_t)(i % b_rows) * b_stride, y);
    if (OP == OP_ADD) gl::add_mod<L>(x, y, K.p, r);
    else gl::sub_mod<L>(x, y, K.p, r);
  }
  gl::store_digits<L>(out + (size_t)i * ND, r);
}

template <int ND>
int launch(int op, const void* a, int a_rows, long long a_stride,
           const void* b, int b_rows, long long b_stride, void* out, int n,
           const uint32_t* p_limbs, void* stream) {
  gl::FpConst<ND / 2> K;
  memcpy(K.p, p_limbs, sizeof(K.p));
  K.inv = 0;
  const int threads = 128;
  int blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* pa = (const long long*)a;
  const long long* pb = (const long long*)b;
  long long* po = (long long*)out;
  switch (op) {
    case OP_ADD:
      addsub_kernel<ND, OP_ADD><<<blocks, threads, 0, s>>>(pa, a_rows, a_stride, pb, b_rows, b_stride, po, n, K);
      break;
    case OP_SUB:
      addsub_kernel<ND, OP_SUB><<<blocks, threads, 0, s>>>(pa, a_rows, a_stride, pb, b_rows, b_stride, po, n, K);
      break;
    case OP_NEG:
      addsub_kernel<ND, OP_NEG><<<blocks, threads, 0, s>>>(pa, a_rows, a_stride, pa, a_rows, a_stride, po, n, K);
      break;
    default:
      return -2;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// op: 0 add, 1 sub, 2 neg (b ignored).  Returns cudaGetLastError() of the
// launch, -1 for a digit count that was not built, -2 for an unknown op.
extern "C" int gl_fp_addsub(int nd, int op, const void* a, int a_rows,
                            long long a_stride, const void* b, int b_rows,
                            long long b_stride, void* out, int n,
                            const uint32_t* p_limbs, void* stream) {
  if (n <= 0) return 0;
  switch (nd) {
    case 16: return launch<16>(op, a, a_rows, a_stride, b, b_rows, b_stride, out, n, p_limbs, stream);
    case 24: return launch<24>(op, a, a_rows, a_stride, b, b_rows, b_stride, out, n, p_limbs, stream);
    case 48: return launch<48>(op, a, a_rows, a_stride, b, b_rows, b_stride, out, n, p_limbs, stream);
    default: return -1;
  }
}

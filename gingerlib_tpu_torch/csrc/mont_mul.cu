// K1: batched Montgomery multiply  out = a * b * R^-1 mod p.
//
// Replaces the TPU kernels of gingerlib_tpu/ops/pallas_mont.py
// (mont_mul_pallas_t and its three layout siblings).  Those spread one
// multiply over 128 lanes and route the two constant products of the
// reduction through the matrix unit, because the TPU's vector unit has no
// wide multiply and no carry flag.  A CUDA thread has both, so here one
// thread owns one field element: 24 limbs of 32 bits in registers (for the
// 48-digit fields), a fully unrolled CIOS loop of 2*L*L + L 32x32->64
// multiply-adds, and a final conditional subtraction.
//
// What bounds it on an H100: the integer multiply-adds (2*L*L + L = 1176 per
// element at L = 24), not memory: the three 753-bit values of one multiply
// are 3 * ND * 2 bytes of information, and the time to move those at the
// card's memory rate is below the time of the multiply-adds at its integer
// rate.  chip_smoke.py computes both and PERF.md holds the measured time
// beside them.  The boundary layout keeps each 16-bit digit in an int64, so
// the kernel really moves 3 * ND * 8 bytes, four times the information; at a
// batch that fills the card that, not the arithmetic, is what holds it above
// its bound.  Each thread reads its own contiguous row with 16-byte loads;
// rows of neighbouring threads are ND*8 bytes apart, so loads are not
// coalesced across a warp.  That is left as it is: right first.
//
// Row addressing: operand x has x_rows rows, x_stride digits apart, and
// thread i reads row i % x_rows.  That covers a full operand (x_rows == n),
// one constant row (x_rows == 1: to_mont, FFT scale, vanishing-polynomial
// divide), a table repeated along the leading axes (FFT twiddles) and one
// component of an extension-field tensor (stride = components * ND) without
// materialising any of them.  The output is always dense.
#include <cuda_runtime.h>
#include <string.h>

#include "fp_limbs.cuh"

namespace {

template <int ND>
__global__ void __launch_bounds__(128)
mont_mul_kernel(const long long* __restrict__ a, int a_rows, long long a_stride,
                const long long* __restrict__ b, int b_rows, long long b_stride,
                long long* __restrict__ out, int n,
                const gl::FpConst<ND / 2> K) {
  constexpr int L = ND / 2;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[L], y[L], r[L];
  gl::load_digits<L>(a + (size_t)(i % a_rows) * a_stride, x);
  gl::load_digits<L>(b + (size_t)(i % b_rows) * b_stride, y);
  gl::mont_mul<L>(x, y, K.p, K.inv, r);
  gl::store_digits<L>(out + (size_t)i * ND, r);
}

template <int ND>
int launch(const void* a, int a_rows, long long a_stride, const void* b,
           int b_rows, long long b_stride, void* out, int n,
           const uint32_t* p_limbs, uint32_t inv, void* stream) {
  gl::FpConst<ND / 2> K;
  memcpy(K.p, p_limbs, sizeof(K.p));
  K.inv = inv;
  const int threads = 128;
  int blocks = (n + threads - 1) / threads;
  mont_mul_kernel<ND><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)a, a_rows, a_stride, (const long long*)b, b_rows,
      b_stride, (long long*)out, n, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() of the launch, or -1 for a digit count that was
// not built.
extern "C" int gl_mont_mul(int nd, const void* a, int a_rows,
                           long long a_stride, const void* b, int b_rows,
                           long long b_stride, void* out, int n,
                           const uint32_t* p_limbs, uint32_t inv,
                           void* stream) {
  if (n <= 0) return 0;
  switch (nd) {
    case 16: return launch<16>(a, a_rows, a_stride, b, b_rows, b_stride, out, n, p_limbs, inv, stream);
    case 24: return launch<24>(a, a_rows, a_stride, b, b_rows, b_stride, out, n, p_limbs, inv, stream);
    case 48: return launch<48>(a, a_rows, a_stride, b, b_rows, b_stride, out, n, p_limbs, inv, stream);
    default: return -1;
  }
}

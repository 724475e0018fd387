// K1: batched Montgomery multiply  out = a * b * R^-1 mod p.
//
// Replaces the TPU kernels of gingerlib_tpu/ops/pallas_mont.py
// (mont_mul_pallas_t and its three layout siblings).  Those spread one
// multiply over 128 lanes and route the two constant products of the
// reduction through the matrix unit, because the TPU's vector unit has no
// wide multiply and no carry flag.  A CUDA thread has both, so here one
// thread owns one field element: 24 limbs of 32 bits in registers (for the
// 48-digit fields), a fully unrolled CIOS loop of 2*L*L + L 32x32->64
// multiply-adds, and a final conditional subtraction.  At the odd digit
// counts (19 and 49: MNT6-298 and SW6) L = (ND + 1)/2 limbs, the top one
// half full, and the last row of the reduction divides by 2^16
// (fp_limbs.cuh), so R stays 2^(16 ND) at no extra multiply.
//
// What bounds it on an H100: the function's own bytes (3 * ND * 2 of
// information per element) take less time at the card's memory rate than
// its multiply-adds at the integer rate, so its bound is by operations;
// chip_smoke.py computes both.  The boundary layout keeps each 16-bit digit
// in an int64, so the kernel moves 3 * ND * 8 bytes, four times the
// information, and at a batch that fills the card those bytes are about as
// long as the multiply-adds.  So the design overlaps the two
// (fp_limbs.cuh, tile_loop): as many blocks of T threads as fit on the card
// each walk over tiles of T elements; a tile's operand rows come into shared
// memory by cp.async with coalesced accesses, while the block multiplies the
// previous tile in registers; results leave through shared memory with
// coalesced 16-byte stores.  (A block that loads, computes and stores one
// tile keeps its loads exposed: resident blocks start together and stay in
// step, all loading, then all multiplying.)
//
// Row addressing: operand x has x_rows rows, x_stride digits apart, and
// element i reads row i % x_rows.  That covers a full operand (x_rows == n),
// one constant row (x_rows == 1: to_mont, FFT scale, vanishing-polynomial
// divide; fetched once a tile), a table repeated along the leading axes
// (FFT twiddles) and one component of an extension-field tensor (stride =
// components * ND) without materialising any of them.  Each row's bytes are
// contiguous, so every form coalesces within a row.  The output is dense.
#include <cuda_runtime.h>
#include <string.h>

#include "fp_limbs.cuh"

namespace {

constexpr int T = 128;  // threads a block = elements a tile

template <int ND>
__global__ void __launch_bounds__(T)
mont_mul_kernel(const long long* __restrict__ a, int a_rows, long long a_stride,
                const long long* __restrict__ b, int b_rows, long long b_stride,
                long long* __restrict__ out, int n,
                const gl::FpConst<gl::limbs_of<ND>> K) {
  constexpr int L = gl::limbs_of<ND>;
  extern __shared__ uint32_t smem[];
  gl::tile_loop<L, T, 2, ND>(
      a, a_rows, a_stride, b, b_rows, b_stride, out, n, smem,
      [&](const uint32_t (&x)[L], const uint32_t (&y)[L], uint32_t (&r)[L]) {
        gl::mont_mul<L, ND>(x, y, K.p, K.inv, r);
      });
}

template <int ND>
int launch(const void* a, int a_rows, long long a_stride, const void* b,
           int b_rows, long long b_stride, void* out, int n,
           const uint32_t* p_limbs, uint32_t inv, void* stream) {
  gl::FpConst<gl::limbs_of<ND>> K;
  memcpy(K.p, p_limbs, sizeof(K.p));
  K.inv = inv;
  static int resident[gl::MAX_DEVICES] = {};
  int blocks, bytes;
  cudaError_t e = gl::tile_loop_launch<gl::limbs_of<ND>, T, 2>(
      mont_mul_kernel<ND>, n, resident, blocks, bytes);
  if (e != cudaSuccess) return (int)e;
  mont_mul_kernel<ND><<<blocks, T, bytes, (cudaStream_t)stream>>>(
      (const long long*)a, a_rows, a_stride, (const long long*)b, b_rows,
      b_stride, (long long*)out, n, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch or of its set-up (0: none), or -1 for
// a digit count that was not built.
extern "C" int gl_mont_mul(int nd, const void* a, int a_rows,
                           long long a_stride, const void* b, int b_rows,
                           long long b_stride, void* out, int n,
                           const uint32_t* p_limbs, uint32_t inv,
                           void* stream) {
  if (n <= 0) return 0;
  switch (nd) {
    case 16: return launch<16>(a, a_rows, a_stride, b, b_rows, b_stride, out, n, p_limbs, inv, stream);
    case 19: return launch<19>(a, a_rows, a_stride, b, b_rows, b_stride, out, n, p_limbs, inv, stream);
    case 24: return launch<24>(a, a_rows, a_stride, b, b_rows, b_stride, out, n, p_limbs, inv, stream);
    case 48: return launch<48>(a, a_rows, a_stride, b, b_rows, b_stride, out, n, p_limbs, inv, stream);
    case 49: return launch<49>(a, a_rows, a_stride, b, b_rows, b_stride, out, n, p_limbs, inv, stream);
    default: return -1;
  }
}

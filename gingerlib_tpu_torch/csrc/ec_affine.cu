// K5: batched affine short-Weierstrass addition around ONE shared inversion,
// as two kernels:
//
//   pre :  (x1, y1, inf1), (x2, y2, inf2)  ->  num, den, inf3
//          lambda's numerator and denominator: (y2 - y1, x2 - x1), or
//          (3 x1^2 + a, 2 y1) in a lane that holds the same point twice;
//          inf3 = (inf1 & inf2) | P == -Q | (P == Q & y1 == 0)
//   post:  num, 1/den, the operands and the three flags  ->  x3, y3
//          lambda = num/den, x3 = lambda^2 - x1 - x2,
//          y3 = lambda (x1 - x3) - y1; a lane with one operand at infinity
//          returns the other operand, a lane with inf3 returns (0, 0).
//
// Between the two, the denominators of the whole batch are inverted by the
// shared-inversion tree (inv_tree.cu).  Lanes whose result does not depend on
// lambda may carry a zero denominator; the tree passes zero through as zero.
//
// Replaces _ec_pre_kernel / _ec_post_kernel of gingerlib_tpu/ops/pallas_ec.py
// (entries batch_affine_add_fused, batch_affine_add_dm).  Those evaluate the
// doubling numerator in every lane of a [128, lanes] digit-major tile; here
// one thread owns one lane of the library's row-major [N, n_digits] int64
// layout (row strides per operand, flags as bool bytes with their own
// strides) and squares x1 only where the lane doubles, and multiplies in
// post only where lambda is used.  The values are those of the select form
// digit for digit, dead lanes included.
//
// What bounds them on an H100: pre moves six 753-bit values for at most one
// multiply, so it is bound by bytes; post does three multiplies on eight
// values and is bound by the multiply-adds (2*L*L + L each).  Field elements
// live in thread-local memory and each multiply is a call (fp_limbs.cuh).
#include <cuda_runtime.h>
#include <string.h>

#include "fp_limbs.cuh"

namespace {

struct Coords4 {
  const long long* ptr[4];  // x1 y1 x2 y2
  long long stride[4];      // digits between consecutive rows
};

struct Flags2 {
  const unsigned char* ptr[2];  // inf1 inf2, one byte a lane
  long long stride[2];
};

template <int ND>
__global__ void __launch_bounds__(128)
affine_pre_kernel(const Coords4 in, const Flags2 fl,
                  long long* __restrict__ num, long long* __restrict__ den,
                  unsigned char* __restrict__ inf3, int n,
                  const gl::CurveConst<ND / 2> K) {
  constexpr int L = ND / 2;
  __shared__ uint32_t C[3 * L];
  gl::stage_consts<L>(K, C);
  const uint32_t* P = C;
  const uint32_t* CA = C + L;

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  uint32_t x1[L], y1[L], x2[L], y2[L], dx[L], dy[L];
  gl::load_digits<L>(in.ptr[0] + (size_t)i * in.stride[0], x1);
  gl::load_digits<L>(in.ptr[1] + (size_t)i * in.stride[1], y1);
  gl::load_digits<L>(in.ptr[2] + (size_t)i * in.stride[2], x2);
  gl::load_digits<L>(in.ptr[3] + (size_t)i * in.stride[3], y2);
  bool i1 = fl.ptr[0][(size_t)i * fl.stride[0]] != 0;
  bool i2 = fl.ptr[1][(size_t)i * fl.stride[1]] != 0;

  gl::sub_mod_mem<L>(x2, x1, P, dx);
  gl::sub_mod_mem<L>(y2, y1, P, dy);
  bool same_x = gl::is_zero<L>(dx);
  bool same_y = gl::is_zero<L>(dy);
  bool ninf = !i1 && !i2;
  bool dbl = same_x && same_y && ninf;
  bool anti = same_x && !same_y && ninf;
  if (dbl) {
    // numerator 3 x1^2 + a, denominator 2 y1
    gl::mont_mul_mem<L>(x1, x1, P, K.inv, x2);
    gl::add_mod_mem<L>(x2, x2, P, dy);
    gl::add_mod_mem<L>(dy, x2, P, dy);
    gl::add_mod_mem<L>(dy, CA, P, dy);
    gl::add_mod_mem<L>(y1, y1, P, dx);
  }
  gl::store_digits<L>(num + (size_t)i * ND, dy);
  gl::store_digits<L>(den + (size_t)i * ND, dx);
  inf3[i] = ((i1 && i2) || anti || (dbl && gl::is_zero<L>(y1))) ? 1 : 0;
}

struct Flags3 {
  const unsigned char* ptr[3];  // inf1 inf2 inf3
  long long stride[3];
};

template <int ND>
__global__ void __launch_bounds__(128)
affine_post_kernel(const long long* __restrict__ num,
                   const long long* __restrict__ dinv, const Coords4 in,
                   const Flags3 fl, long long* __restrict__ x3,
                   long long* __restrict__ y3, int n,
                   const gl::CurveConst<ND / 2> K) {
  constexpr int L = ND / 2;
  __shared__ uint32_t C[3 * L];
  gl::stage_consts<L>(K, C);
  const uint32_t* P = C;

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  bool m1 = fl.ptr[0][(size_t)i * fl.stride[0]] != 0;
  bool m2 = fl.ptr[1][(size_t)i * fl.stride[1]] != 0;
  bool m3 = fl.ptr[2][(size_t)i * fl.stride[2]] != 0;

  uint32_t ox[L], oy[L];
  if (m3) {
    gl::zero_limbs<L>(ox);
    gl::zero_limbs<L>(oy);
  } else if (m1) {
    gl::load_digits<L>(in.ptr[2] + (size_t)i * in.stride[2], ox);
    gl::load_digits<L>(in.ptr[3] + (size_t)i * in.stride[3], oy);
  } else if (m2) {
    gl::load_digits<L>(in.ptr[0] + (size_t)i * in.stride[0], ox);
    gl::load_digits<L>(in.ptr[1] + (size_t)i * in.stride[1], oy);
  } else {
    uint32_t lam[L], t[L], x1[L];
    gl::load_digits<L>(num + (size_t)i * ND, lam);
    gl::load_digits<L>(dinv + (size_t)i * ND, t);
    gl::mont_mul_mem<L>(lam, t, P, K.inv, lam);
    gl::mont_mul_mem<L>(lam, lam, P, K.inv, ox);
    gl::load_digits<L>(in.ptr[0] + (size_t)i * in.stride[0], x1);
    gl::sub_mod_mem<L>(ox, x1, P, ox);
    gl::load_digits<L>(in.ptr[2] + (size_t)i * in.stride[2], t);
    gl::sub_mod_mem<L>(ox, t, P, ox);
    gl::sub_mod_mem<L>(x1, ox, P, t);
    gl::mont_mul_mem<L>(lam, t, P, K.inv, oy);
    gl::load_digits<L>(in.ptr[1] + (size_t)i * in.stride[1], t);
    gl::sub_mod_mem<L>(oy, t, P, oy);
  }
  gl::store_digits<L>(x3 + (size_t)i * ND, ox);
  gl::store_digits<L>(y3 + (size_t)i * ND, oy);
}

Coords4 make_coords(const void* const* in, const long long* in_stride) {
  Coords4 c;
  for (int k = 0; k < 4; k++) {
    c.ptr[k] = (const long long*)in[k];
    c.stride[k] = in_stride[k];
  }
  return c;
}

template <int ND>
int launch_pre(const void* const* in, const long long* in_stride,
               const void* const* flags, const long long* flag_stride,
               void* num, void* den, void* inf3, int n,
               const uint32_t* consts, uint32_t inv, void* stream) {
  Flags2 f;
  for (int k = 0; k < 2; k++) {
    f.ptr[k] = (const unsigned char*)flags[k];
    f.stride[k] = flag_stride[k];
  }
  const int threads = 128;
  int blocks = (n + threads - 1) / threads;
  affine_pre_kernel<ND><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      make_coords(in, in_stride), f, (long long*)num, (long long*)den,
      (unsigned char*)inf3, n, gl::make_curve_const<ND / 2>(consts, inv, 0));
  return (int)cudaGetLastError();
}

template <int ND>
int launch_post(const void* num, const void* dinv, const void* const* in,
                const long long* in_stride, const void* const* flags,
                const long long* flag_stride, void* x3, void* y3, int n,
                const uint32_t* consts, uint32_t inv, void* stream) {
  Flags3 f;
  for (int k = 0; k < 3; k++) {
    f.ptr[k] = (const unsigned char*)flags[k];
    f.stride[k] = flag_stride[k];
  }
  const int threads = 128;
  int blocks = (n + threads - 1) / threads;
  affine_post_kernel<ND><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)num, (const long long*)dinv,
      make_coords(in, in_stride), f, (long long*)x3, (long long*)y3, n,
      gl::make_curve_const<ND / 2>(consts, inv, 0));
  return (int)cudaGetLastError();
}

}  // namespace

// in: four row pointers x1 y1 x2 y2 with row strides in digits; flags: bool
// bytes inf1 inf2 with strides in bytes; num, den [n, nd] and inf3 [n] dense
// outputs; consts: 3*nd/2 limbs [p | a | one].  Returns cudaGetLastError()
// of the launch, or -1 for a digit count that was not built.
extern "C" int gl_ec_affine_pre(int nd, const void* const* in,
                                const long long* in_stride,
                                const void* const* flags,
                                const long long* flag_stride, void* num,
                                void* den, void* inf3, int n,
                                const uint32_t* consts, uint32_t inv,
                                void* stream) {
  if (n <= 0) return 0;
  switch (nd) {
    case 16: return launch_pre<16>(in, in_stride, flags, flag_stride, num, den, inf3, n, consts, inv, stream);
    case 24: return launch_pre<24>(in, in_stride, flags, flag_stride, num, den, inf3, n, consts, inv, stream);
    case 48: return launch_pre<48>(in, in_stride, flags, flag_stride, num, den, inf3, n, consts, inv, stream);
    default: return -1;
  }
}

// num, dinv: dense [n, nd]; in and flags as above, flags now inf1 inf2 inf3;
// x3, y3: dense [n, nd] outputs.
extern "C" int gl_ec_affine_post(int nd, const void* num, const void* dinv,
                                 const void* const* in,
                                 const long long* in_stride,
                                 const void* const* flags,
                                 const long long* flag_stride, void* x3,
                                 void* y3, int n, const uint32_t* consts,
                                 uint32_t inv, void* stream) {
  if (n <= 0) return 0;
  switch (nd) {
    case 16: return launch_post<16>(num, dinv, in, in_stride, flags, flag_stride, x3, y3, n, consts, inv, stream);
    case 24: return launch_post<24>(num, dinv, in, in_stride, flags, flag_stride, x3, y3, n, consts, inv, stream);
    case 48: return launch_post<48>(num, dinv, in, in_stride, flags, flag_stride, x3, y3, n, consts, inv, stream);
    default: return -1;
  }
}

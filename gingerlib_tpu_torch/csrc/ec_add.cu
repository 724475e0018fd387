// K4: unified projective short-Weierstrass addition, one launch for a whole
// batch:  (X3, Y3, Z3) = (X1, Y1, Z1) + (X2, Y2, Z2)  on  y^2 z = x^3 + a x z^2
// + b z^3  over a prime field, right for every input: distinct points
// (add-1998-cmo-2), equal points (dbl-2007-bl), opposite points and points
// at infinity on either side.  Infinity is (0, 1, 0) in Montgomery form.
//
// Replaces _ec_proj_add_kernel / proj_add_dm of gingerlib_tpu/ops/pallas_ec.py.
// The TPU kernel evaluates both formulas in every lane and picks per lane,
// because its lanes cannot branch, and keeps the digits in a [128, lanes]
// tile for its vector unit.  Here one thread owns one lane, reads its six
// operands as rows of the library's [N, n_digits] int64 layout (each with
// its own row stride, so the even/odd halves of a tree level and a
// broadcast row cost no copy), and branches: a lane with an operand at
// infinity does no multiply, a lane of opposite points five, and only a
// lane of equal points evaluates the doubling.  The values are those of the
// select form, digit for digit (every field operation returns the canonical
// residue), which is SWCurveOps.add of curves/sw.py.
//
// What bounds it on an H100: the multiply-adds of its 14 Montgomery
// multiplies (17 on the doubling path, 16 with a = 0), 2*L*L + L each; the
// nine 753-bit values it moves are far below that.  Fourteen inlined
// multiplies with six operands and eight temporaries of 24 limbs alive would
// need several times the 255 registers a thread can have, so the field
// elements live in thread-local memory and each multiply is a call
// (fp_limbs.cuh, memory-resident forms): the kernel needs the registers of
// one multiply.  chip_smoke.py holds it against the plain version and times
// it; PERF.md has the numbers, with registers and stack frame as ptxas
// reports them.
#include <cuda_runtime.h>
#include <string.h>

#include "fp_limbs.cuh"

namespace {

struct In6 {
  const long long* ptr[6];  // X1 Y1 Z1 X2 Y2 Z2
  long long stride[6];      // digits between consecutive rows (0: one row)
};

struct Out3 {
  long long* ptr[3];        // dense [n, ND]
};

template <int ND>
__global__ void __launch_bounds__(128)
proj_add_kernel(const In6 in, const Out3 out, int n,
                const gl::CurveConst<ND / 2> K) {
  constexpr int L = ND / 2;
  __shared__ uint32_t C[3 * L];
  gl::stage_consts<L>(K, C);
  const uint32_t* P = C;
  const uint32_t* CA = C + L;
  const uint32_t* ONE = C + 2 * L;
  const uint32_t inv = K.inv;

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  uint32_t X1[L], Y1[L], Z1[L], X2[L], Y2[L], Z2[L];
  uint32_t RX[L], RY[L], RZ[L];
  gl::load_digits<L>(in.ptr[2] + (size_t)i * in.stride[2], Z1);
  gl::load_digits<L>(in.ptr[5] + (size_t)i * in.stride[5], Z2);
  gl::load_digits<L>(in.ptr[3] + (size_t)i * in.stride[3], X2);
  gl::load_digits<L>(in.ptr[4] + (size_t)i * in.stride[4], Y2);

  if (gl::is_zero<L>(Z1)) {            // infinity + Q = Q
    gl::copy_limbs<L>(X2, RX);
    gl::copy_limbs<L>(Y2, RY);
    gl::copy_limbs<L>(Z2, RZ);
  } else {
    gl::load_digits<L>(in.ptr[0] + (size_t)i * in.stride[0], X1);
    gl::load_digits<L>(in.ptr[1] + (size_t)i * in.stride[1], Y1);
    if (gl::is_zero<L>(Z2)) {          // P + infinity = P
      gl::copy_limbs<L>(X1, RX);
      gl::copy_limbs<L>(Y1, RY);
      gl::copy_limbs<L>(Z1, RZ);
    } else {
      uint32_t Y1Z2[L], X1Z2[L], Z1Z2[L], u[L], v[L], t[L];
      gl::mont_mul_mem<L>(Y1, Z2, P, inv, Y1Z2);
      gl::mont_mul_mem<L>(X1, Z2, P, inv, X1Z2);
      gl::mont_mul_mem<L>(Z1, Z2, P, inv, Z1Z2);
      gl::mont_mul_mem<L>(Y2, Z1, P, inv, u);
      gl::sub_mod_mem<L>(u, Y1Z2, P, u);
      gl::mont_mul_mem<L>(X2, Z1, P, inv, v);
      gl::sub_mod_mem<L>(v, X1Z2, P, v);
      bool same_x = gl::is_zero<L>(v);
      bool same_y = gl::is_zero<L>(u);
      if (!same_x) {
        // add-1998-cmo-2; X2, Y2, Z2 are free from here on
        uint32_t* uu = X2;
        uint32_t* vv = Y2;
        uint32_t* vvv = Z2;
        uint32_t Rv[L], A[L];
        gl::mont_mul_mem<L>(u, u, P, inv, uu);
        gl::mont_mul_mem<L>(v, v, P, inv, vv);
        gl::mont_mul_mem<L>(v, vv, P, inv, vvv);
        gl::mont_mul_mem<L>(vv, X1Z2, P, inv, Rv);
        gl::mont_mul_mem<L>(uu, Z1Z2, P, inv, A);
        gl::sub_mod_mem<L>(A, vvv, P, A);
        gl::add_mod_mem<L>(Rv, Rv, P, t);
        gl::sub_mod_mem<L>(A, t, P, A);
        gl::mont_mul_mem<L>(v, A, P, inv, RX);
        gl::sub_mod_mem<L>(Rv, A, P, t);
        gl::mont_mul_mem<L>(u, t, P, inv, t);
        gl::mont_mul_mem<L>(vvv, Y1Z2, P, inv, uu);
        gl::sub_mod_mem<L>(t, uu, P, RY);
        gl::mont_mul_mem<L>(vvv, Z1Z2, P, inv, RZ);
      } else if (same_y && !gl::is_zero<L>(Y1)) {
        // dbl-2007-bl of P
        uint32_t* XX = X2;
        uint32_t* w = Y2;
        uint32_t* s = Z2;
        uint32_t* ss = Y1Z2;
        uint32_t* Rr = X1Z2;
        uint32_t* RR = Z1Z2;
        uint32_t* B = u;
        uint32_t* h = v;
        gl::mont_mul_mem<L>(X1, X1, P, inv, XX);
        gl::add_mod_mem<L>(XX, XX, P, w);
        gl::add_mod_mem<L>(w, XX, P, w);
        if (!K.a_is_zero) {
          gl::mont_mul_mem<L>(Z1, Z1, P, inv, t);
          gl::mont_mul_mem<L>(CA, t, P, inv, t);
          gl::add_mod_mem<L>(t, w, P, w);
        }
        gl::mont_mul_mem<L>(Y1, Z1, P, inv, s);
        gl::add_mod_mem<L>(s, s, P, s);
        gl::mont_mul_mem<L>(s, s, P, inv, ss);
        gl::mont_mul_mem<L>(s, ss, P, inv, RZ);
        gl::mont_mul_mem<L>(Y1, s, P, inv, Rr);
        gl::mont_mul_mem<L>(Rr, Rr, P, inv, RR);
        gl::add_mod_mem<L>(X1, Rr, P, t);
        gl::mont_mul_mem<L>(t, t, P, inv, B);
        gl::sub_mod_mem<L>(B, XX, P, B);
        gl::sub_mod_mem<L>(B, RR, P, B);
        gl::mont_mul_mem<L>(w, w, P, inv, h);
        gl::add_mod_mem<L>(B, B, P, t);
        gl::sub_mod_mem<L>(h, t, P, h);
        gl::mont_mul_mem<L>(h, s, P, inv, RX);
        gl::sub_mod_mem<L>(B, h, P, t);
        gl::mont_mul_mem<L>(w, t, P, inv, t);
        gl::add_mod_mem<L>(RR, RR, P, RR);
        gl::sub_mod_mem<L>(t, RR, P, RY);
      } else {
        // P + (-P), or the doubling of a point with Y = 0
        gl::zero_limbs<L>(RX);
        gl::copy_limbs<L>(ONE, RY);
        gl::zero_limbs<L>(RZ);
      }
    }
  }
  gl::store_digits<L>(out.ptr[0] + (size_t)i * ND, RX);
  gl::store_digits<L>(out.ptr[1] + (size_t)i * ND, RY);
  gl::store_digits<L>(out.ptr[2] + (size_t)i * ND, RZ);
}

template <int ND>
int launch(const void* const* in, const long long* in_stride,
           void* const* out, int n, const uint32_t* consts, uint32_t inv,
           int a_is_zero, void* stream) {
  In6 a;
  for (int k = 0; k < 6; k++) {
    a.ptr[k] = (const long long*)in[k];
    a.stride[k] = in_stride[k];
  }
  Out3 o;
  for (int k = 0; k < 3; k++) o.ptr[k] = (long long*)out[k];
  const int threads = 128;
  int blocks = (n + threads - 1) / threads;
  proj_add_kernel<ND><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      a, o, n, gl::make_curve_const<ND / 2>(consts, inv, a_is_zero));
  return (int)cudaGetLastError();
}

}  // namespace

// in: six row pointers X1 Y1 Z1 X2 Y2 Z2 with their row strides in digits;
// out: three dense [n, nd] results; consts: 3*nd/2 limbs [p | a | one].
// Returns cudaGetLastError() of the launch, or -1 for a digit count that was
// not built.
extern "C" int gl_ec_proj_add(int nd, const void* const* in,
                              const long long* in_stride, void* const* out,
                              int n, const uint32_t* consts, uint32_t inv,
                              int a_is_zero, void* stream) {
  if (n <= 0) return 0;
  switch (nd) {
    case 16: return launch<16>(in, in_stride, out, n, consts, inv, a_is_zero, stream);
    case 24: return launch<24>(in, in_stride, out, n, consts, inv, a_is_zero, stream);
    case 48: return launch<48>(in, in_stride, out, n, consts, inv, a_is_zero, stream);
    default: return -1;
  }
}

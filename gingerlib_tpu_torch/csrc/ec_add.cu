// K4: unified projective short-Weierstrass addition, one launch for a whole
// batch:  (X3, Y3, Z3) = (X1, Y1, Z1) + (X2, Y2, Z2)  on  y^2 z = x^3 + a x z^2
// + b z^3  over a prime field, right for every input: distinct points
// (add-1998-cmo-2), equal points (dbl-2007-bl), opposite points and points
// at infinity on either side.  Infinity is (0, 1, 0) in Montgomery form.
//
// Replaces _ec_proj_add_kernel / proj_add_dm of gingerlib_tpu/ops/pallas_ec.py.
// The TPU kernel evaluates both formulas in every lane and picks per lane,
// because its lanes cannot branch, and keeps the digits in a [128, lanes]
// tile for its vector unit.  Here a group of G threads owns one lane: each
// thread holds L/G consecutive limbs of every value in registers and the
// field operations run over the group (fp_group.cuh).  The lane reads its
// six operands as rows of the library's [N, n_digits] int64 layout, each
// with its own row stride (the even/odd halves of a tree level and a
// broadcast row cost no copy); the group's threads read neighbouring chunks
// of each row.  It branches, each branch decided by a ballot of the group so
// that its threads go together: a lane with an operand at infinity does no
// multiply, a lane of opposite points five, and only a lane of equal points
// evaluates the doubling.  The values are those of the select form, digit
// for digit (every field operation returns the canonical residue), which is
// SWCurveOps.add of curves/sw.py.
//
// What bounds it on an H100: the multiply-adds of its 14 Montgomery
// multiplies (17 on the doubling path, 16 with a = 0), 2*L*L + L each; the
// nine 753-bit values it moves are far below that.  In one thread a lane
// the multiplies' carry chains are serial, so the path's narrow launches
// (one lane in the window fold, 2^14 lanes in the Fenwick steps: one warp a
// scheduler) were bound by their latency.  A group shortens a multiply's
// dependent chain about G-fold (plus three shuffles a row) and gives a batch
// G times the warps.  G is 8 at 48 digits and 4 at 16 and 24 digits: at 48
// digits a group of 4 was slower at 1, 2^10 and 16,376 lanes (PERF.md).
// At the odd digit counts G is 8 at 49 (SW6: 25 limbs padded to 32, so
// four a thread) and 4 at 19 (MNT6-298: 10 limbs padded to 12); the padded
// limbs are zero in every value and in p (fp_group.cuh), the multiply's
// rows follow the digits, and the constants are staged padded.
// chip_smoke.py holds it against the plain version and times it; PERF.md
// has the numbers, with registers and stack frame as ptxas reports them.
#include <cuda_runtime.h>
#include <string.h>

#include "fp_group.cuh"

namespace {

constexpr int THREADS = 128;  // a block: THREADS / G lanes

template <int ND>
constexpr int group_size() { return ND >= 48 ? 8 : 4; }

struct In6 {
  const long long* ptr[6];  // X1 Y1 Z1 X2 Y2 Z2
  long long stride[6];      // digits between consecutive rows (0: one row)
};

struct Out3 {
  long long* ptr[3];        // dense [n, ND]
};

template <int ND, int G>
__global__ void __launch_bounds__(THREADS)
proj_add_kernel(const In6 in, const Out3 out, int n,
                const gl::CurveConst<gl::limbs_of<ND>> K) {
  constexpr int NL = gl::limbs_of<ND>;   // the element's limbs
  constexpr int L = gl::group_limbs<ND, G>;  // the group's, zero-padded
  using Grp = gl::Grp<L, G>;
  constexpr int M = Grp::M;
  // [p | a | one], L words each
  __shared__ uint32_t C[3 * L];
  for (int k = threadIdx.x; k < 3 * L; k += THREADS) {
    const int j = k % L;
    C[k] = j >= NL ? 0u : k < L ? K.p[j] : k < 2 * L ? K.a[j] : K.one[j];
  }
  __syncthreads();

  const int i = (int)(((long long)blockIdx.x * THREADS + threadIdx.x) / G);
  if (i >= n) return;  // the whole group: its threads share i
  const Grp g = Grp::of_thread();
  const int off = g.rank * M;
  uint32_t P[M];
#pragma unroll
  for (int j = 0; j < M; j++) P[j] = C[off + j];
  const uint32_t inv = K.inv;

  auto mul = [&](const uint32_t (&a)[M], const uint32_t (&b)[M],
                 uint32_t (&r)[M]) {
    gl::grp_mont_mul<L, G, ND>(g, a, b, P, inv, r);
  };
  auto add = [&](const uint32_t (&a)[M], const uint32_t (&b)[M],
                 uint32_t (&r)[M]) { gl::grp_add_mod<L, G>(g, a, b, P, r); };
  auto sub = [&](const uint32_t (&a)[M], const uint32_t (&b)[M],
                 uint32_t (&r)[M]) { gl::grp_sub_mod<L, G>(g, a, b, P, r); };
  auto zero = [&](const uint32_t (&a)[M]) {
    return gl::grp_is_zero<L, G>(g, a);
  };
  auto load = [&](int k, uint32_t (&x)[M]) {
    gl::grp_load<L, G, ND>(g, in.ptr[k] + (size_t)i * in.stride[k], x);
  };
  auto copy = [](const uint32_t (&a)[M], uint32_t (&r)[M]) {
#pragma unroll
    for (int j = 0; j < M; j++) r[j] = a[j];
  };

  uint32_t X1[M], Y1[M], Z1[M], X2[M], Y2[M], Z2[M];
  uint32_t RX[M], RY[M], RZ[M];
  load(2, Z1);
  load(5, Z2);
  load(3, X2);
  load(4, Y2);

  if (zero(Z1)) {                    // infinity + Q = Q
    copy(X2, RX);
    copy(Y2, RY);
    copy(Z2, RZ);
  } else {
    load(0, X1);
    load(1, Y1);
    if (zero(Z2)) {                  // P + infinity = P
      copy(X1, RX);
      copy(Y1, RY);
      copy(Z1, RZ);
    } else {
      uint32_t Y1Z2[M], X1Z2[M], Z1Z2[M], u[M], v[M], t[M];
      mul(Y1, Z2, Y1Z2);
      mul(X1, Z2, X1Z2);
      mul(Z1, Z2, Z1Z2);
      mul(Y2, Z1, u);
      sub(u, Y1Z2, u);
      mul(X2, Z1, v);
      sub(v, X1Z2, v);
      const bool same_x = zero(v);
      const bool same_y = zero(u);
      if (!same_x) {
        // add-1998-cmo-2; X2, Y2, Z2 are free from here on
        uint32_t (&uu)[M] = X2;
        uint32_t (&vv)[M] = Y2;
        uint32_t (&vvv)[M] = Z2;
        uint32_t Rv[M], A[M];
        mul(u, u, uu);
        mul(v, v, vv);
        mul(v, vv, vvv);
        mul(vv, X1Z2, Rv);
        mul(uu, Z1Z2, A);
        sub(A, vvv, A);
        add(Rv, Rv, t);
        sub(A, t, A);
        mul(v, A, RX);
        sub(Rv, A, t);
        mul(u, t, t);
        mul(vvv, Y1Z2, uu);
        sub(t, uu, RY);
        mul(vvv, Z1Z2, RZ);
      } else if (same_y && !zero(Y1)) {
        // dbl-2007-bl of P
        uint32_t (&XX)[M] = X2;
        uint32_t (&w)[M] = Y2;
        uint32_t (&s)[M] = Z2;
        uint32_t (&ss)[M] = Y1Z2;
        uint32_t (&Rr)[M] = X1Z2;
        uint32_t (&RR)[M] = Z1Z2;
        uint32_t (&B)[M] = u;
        uint32_t (&h)[M] = v;
        mul(X1, X1, XX);
        add(XX, XX, w);
        add(w, XX, w);
        if (!K.a_is_zero) {
          uint32_t CA[M];
#pragma unroll
          for (int j = 0; j < M; j++) CA[j] = C[L + off + j];
          mul(Z1, Z1, t);
          mul(CA, t, t);
          add(t, w, w);
        }
        mul(Y1, Z1, s);
        add(s, s, s);
        mul(s, s, ss);
        mul(s, ss, RZ);
        mul(Y1, s, Rr);
        mul(Rr, Rr, RR);
        add(X1, Rr, t);
        mul(t, t, B);
        sub(B, XX, B);
        sub(B, RR, B);
        mul(w, w, h);
        add(B, B, t);
        sub(h, t, h);
        mul(h, s, RX);
        sub(B, h, t);
        mul(w, t, t);
        add(RR, RR, RR);
        sub(t, RR, RY);
      } else {
        // P + (-P), or the doubling of a point with Y = 0
#pragma unroll
        for (int j = 0; j < M; j++) {
          RX[j] = 0;
          RY[j] = C[2 * L + off + j];
          RZ[j] = 0;
        }
      }
    }
  }
  gl::grp_store<L, G, ND>(g, out.ptr[0] + (size_t)i * ND, RX);
  gl::grp_store<L, G, ND>(g, out.ptr[1] + (size_t)i * ND, RY);
  gl::grp_store<L, G, ND>(g, out.ptr[2] + (size_t)i * ND, RZ);
}

template <int ND>
int launch(const void* const* in, const long long* in_stride,
           void* const* out, int n, const uint32_t* consts, uint32_t inv,
           int a_is_zero, void* stream) {
  constexpr int G = group_size<ND>();
  In6 a;
  for (int k = 0; k < 6; k++) {
    a.ptr[k] = (const long long*)in[k];
    a.stride[k] = in_stride[k];
  }
  Out3 o;
  for (int k = 0; k < 3; k++) o.ptr[k] = (long long*)out[k];
  long long blocks = ((long long)n * G + THREADS - 1) / THREADS;
  proj_add_kernel<ND, G><<<(unsigned)blocks, THREADS, 0,
                            (cudaStream_t)stream>>>(
      a, o, n, gl::make_curve_const<gl::limbs_of<ND>>(consts, inv, a_is_zero));
  return (int)cudaGetLastError();
}

}  // namespace

// in: six row pointers X1 Y1 Z1 X2 Y2 Z2 with their row strides in digits;
// out: three dense [n, nd] results; consts: 3 ceil(nd/2) limbs [p | a | one].
// Returns cudaGetLastError() of the launch, or -1 for a digit count that was
// not built.
extern "C" int gl_ec_proj_add(int nd, const void* const* in,
                              const long long* in_stride, void* const* out,
                              int n, const uint32_t* consts, uint32_t inv,
                              int a_is_zero, void* stream) {
  if (n <= 0) return 0;
  switch (nd) {
    case 16: return launch<16>(in, in_stride, out, n, consts, inv, a_is_zero, stream);
    case 19: return launch<19>(in, in_stride, out, n, consts, inv, a_is_zero, stream);
    case 24: return launch<24>(in, in_stride, out, n, consts, inv, a_is_zero, stream);
    case 48: return launch<48>(in, in_stride, out, n, consts, inv, a_is_zero, stream);
    case 49: return launch<49>(in, in_stride, out, n, consts, inv, a_is_zero, stream);
    default: return -1;
  }
}

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
// values and is bound by the multiply-adds (2*L*L + L each).  The int64
// boundary layout moves four times a value's bytes, so both kernels are
// first of all a matter of moving rows well.  Each block takes a tile of T
// = 64 lanes and stages its operand rows in shared memory, the block's
// threads on consecutive addresses of a row, each operand at its own row
// stride; each thread then reads its lane's rows from there as limbs,
// computes in registers (gl::mont_mul and the modular add/sub, inlined;
// post's three multiplies through one copy of the multiply in a loop:
// unrolled, a 48-digit multiply is some 56 KB of instructions, and three
// copies in turn do not stay in the instruction cache), and puts its
// results in shared memory, from where the block writes them out as
// 16-byte digit pairs, consecutive threads on consecutive chunks
// (unstage_rows of fp_limbs.cuh).  Flags are single bytes, read and
// written by each lane's thread.  One tile a block, so a block that
// multiplies overlaps the loads of the other blocks on its SM.
//
// Pre fetches its four rows as the elementwise kernels do (fetch_rows:
// cp.async brings the low word of each int64 digit, 2L + 1 words a row):
// 63 KB a block at 48 digits, three blocks an SM, enough for a kernel
// bound by bytes.  Post has six rows to hold and three multiplies to hide
// the loads behind, so it packs them as they arrive (16-byte digit pairs
// through registers, L + 1 words a row) and writes its results over the
// rows of num and dinv, which its thread has read by then: 38 KB a block,
// five blocks an SM.  Fetched rows would take 88 KB, two blocks an SM, and
// a first form that fetched them was the slower on an H100 (PERF.md).
#include <cuda_runtime.h>
#include <string.h>

#include "fp_limbs.cuh"

namespace {

constexpr int T = 64;  // threads a block = lanes a tile

struct Coords4 {
  const long long* ptr[4];  // x1 y1 x2 y2
  long long stride[4];      // digits between consecutive rows
};

struct Flags2 {
  const unsigned char* ptr[2];  // inf1 inf2, one byte a lane
  long long stride[2];
};

struct Flags3 {
  const unsigned char* ptr[3];  // inf1 inf2 inf3
  long long stride[3];
};

// Bytes of shared memory for a tile of min(n, T) lanes: pre's four
// fetched operand rows (2L + 1 words each) and two result rows (L + 1
// words) a lane; post's six packed operand rows (L + 1 words each), two of
// which take the results.
template <int L>
__host__ __device__ __forceinline__ int pre_bytes(int n) {
  return 4 * gl::tile_rows<T>(n) * (4 * (2 * L + 1) + 2 * (L + 1));
}

template <int L>
__host__ __device__ __forceinline__ int post_bytes(int n) {
  return 4 * gl::tile_rows<T>(n) * 6 * (L + 1);
}

// Batch rows base .. base+cnt-1 of x (rows `stride` digits apart) into s as
// packed limbs, row r at s + r*(L+1): the block's threads on consecutive
// 16-byte digit pairs (at an odd ND, on consecutive limbs, digit by
// digit), several loads in flight each.
template <int L, int ND>
__device__ __forceinline__ void load_rows(const long long* __restrict__ x,
                                          long long stride, int base, int cnt,
                                          uint32_t* s) {
#pragma unroll 8
  for (int k = threadIdx.x; k < cnt * L; k += T) {
    const int r = k / L, j = k - r * L;
    const long long* row = x + (size_t)(base + r) * stride;
    if constexpr (ND == 2 * L) {
      const longlong2 d = reinterpret_cast<const longlong2*>(row)[j];
      s[r * (L + 1) + j] = ((uint32_t)d.x & 0xFFFFu) | ((uint32_t)d.y << 16);
    } else {
      uint32_t w = (uint32_t)row[2 * j] & 0xFFFFu;
      if (2 * j + 1 < ND) w |= (uint32_t)row[2 * j + 1] << 16;
      s[r * (L + 1) + j] = w;
    }
  }
}

// The limbs of this thread's row of operand k, fetched (pre) or packed
// (post).
template <int L, int ND>
__device__ __forceinline__ void operand(const uint32_t* s, int k, int rows,
                                        uint32_t (&x)[L]) {
  gl::fetched_limbs<L, ND>(s + (k * rows + threadIdx.x) * (2 * L + 1), x);
}

template <int L>
__device__ __forceinline__ void packed(const uint32_t* s, int k, int rows,
                                       uint32_t (&x)[L]) {
  const uint32_t* row = s + (k * rows + threadIdx.x) * (L + 1);
#pragma unroll
  for (int j = 0; j < L; j++) x[j] = row[j];
}

template <int ND>
__global__ void __launch_bounds__(T)
affine_pre_kernel(const Coords4 in, const Flags2 fl,
                  long long* __restrict__ num, long long* __restrict__ den,
                  unsigned char* __restrict__ inf3, int n,
                  const gl::CurveConst<gl::limbs_of<ND>> K) {
  constexpr int L = gl::limbs_of<ND>;
  extern __shared__ uint32_t smem[];
  const int rows = gl::tile_rows<T>(n), t = threadIdx.x;
  const int base = blockIdx.x * T, cnt = min(T, n - base);
  for (int k = 0; k < 4; k++)
    gl::fetch_rows<L, T, ND>(in.ptr[k], n, in.stride[k], base, cnt,
                             smem + k * rows * (2 * L + 1));
  gl::cp_async_commit();
  uint32_t* out_num = smem + 4 * rows * (2 * L + 1);
  uint32_t* out_den = out_num + rows * (L + 1);
  bool i1 = false, i2 = false;
  if (t < cnt) {
    i1 = fl.ptr[0][(size_t)(base + t) * fl.stride[0]] != 0;
    i2 = fl.ptr[1][(size_t)(base + t) * fl.stride[1]] != 0;
  }
  gl::cp_async_wait_all();
  __syncthreads();
  if (t < cnt) {
    uint32_t a[L], b[L], dx[L], dy[L];
    operand<L, ND>(smem, 0, rows, a);
    operand<L, ND>(smem, 2, rows, b);
    gl::sub_mod<L>(b, a, K.p, dx);
    operand<L, ND>(smem, 1, rows, a);
    operand<L, ND>(smem, 3, rows, b);
    gl::sub_mod<L>(b, a, K.p, dy);
    const bool same_x = gl::is_zero<L>(dx), same_y = gl::is_zero<L>(dy);
    const bool ninf = !i1 && !i2;
    const bool dbl = same_x && same_y && ninf;
    const bool anti = same_x && !same_y && ninf;
    bool y_zero = false;
    if (dbl) {
      // numerator 3 x1^2 + a, denominator 2 y1
      y_zero = gl::is_zero<L>(a);
      gl::add_mod<L>(a, a, K.p, dx);
      operand<L, ND>(smem, 0, rows, a);
      gl::mont_mul<L, ND>(a, a, K.p, K.inv, b);
      gl::add_mod<L>(b, b, K.p, dy);
      gl::add_mod<L>(dy, b, K.p, dy);
      gl::add_mod<L>(dy, K.a, K.p, dy);
    }
#pragma unroll
    for (int j = 0; j < L; j++) {
      out_num[t * (L + 1) + j] = dy[j];
      out_den[t * (L + 1) + j] = dx[j];
    }
    inf3[base + t] = ((i1 && i2) || anti || y_zero) ? 1 : 0;
  }
  __syncthreads();
  gl::unstage_rows<L, T, ND>(out_num, num, base, cnt);
  gl::unstage_rows<L, T, ND>(out_den, den, base, cnt);
}

template <int ND>
__global__ void __launch_bounds__(T)
affine_post_kernel(const long long* __restrict__ num,
                   const long long* __restrict__ dinv, const Coords4 in,
                   const Flags3 fl, long long* __restrict__ x3,
                   long long* __restrict__ y3, int n,
                   const gl::CurveConst<gl::limbs_of<ND>> K) {
  constexpr int L = gl::limbs_of<ND>, RW = L + 1;
  extern __shared__ uint32_t smem[];
  const int rows = gl::tile_rows<T>(n), t = threadIdx.x;
  const int base = blockIdx.x * T, cnt = min(T, n - base);
  // rows 0-3: x1 y1 x2 y2; 4, 5: num and dinv, then x3 and y3 (a lane's
  // rows are its thread's alone until the block writes the results out)
  for (int k = 0; k < 4; k++)
    load_rows<L, ND>(in.ptr[k], in.stride[k], base, cnt, smem + k * rows * RW);
  load_rows<L, ND>(num, ND, base, cnt, smem + 4 * rows * RW);
  load_rows<L, ND>(dinv, ND, base, cnt, smem + 5 * rows * RW);
  bool m1 = false, m2 = false, m3 = false;
  if (t < cnt) {
    m1 = fl.ptr[0][(size_t)(base + t) * fl.stride[0]] != 0;
    m2 = fl.ptr[1][(size_t)(base + t) * fl.stride[1]] != 0;
    m3 = fl.ptr[2][(size_t)(base + t) * fl.stride[2]] != 0;
  }
  __syncthreads();
  uint32_t* out_x = smem + (4 * rows + t) * RW;
  uint32_t* out_y = smem + (5 * rows + t) * RW;
  if (t < cnt) {
    uint32_t a[L], b[L], u[L];
    if (m3 || m1 || m2) {
      // (0, 0), else the operand that is not at infinity
      const int k = m1 ? 2 : 0;
      packed<L>(smem, k, rows, a);
      packed<L>(smem, k + 1, rows, b);
#pragma unroll
      for (int j = 0; j < L; j++) {
        out_x[j] = m3 ? 0u : a[j];
        out_y[j] = m3 ? 0u : b[j];
      }
    } else {
      // lambda = num / den, x3 = lambda^2 - x1 - x2, y3 = lambda (x1 - x3)
      // - y1: three multiplies a * b -> u in turn, through one copy of the
      // multiply (see the note above), three values in registers
      packed<L>(smem, 4, rows, a);
      packed<L>(smem, 5, rows, b);
#pragma unroll 1
      for (int k = 0; k < 3; k++) {
        gl::mont_mul<L, ND>(a, b, K.p, K.inv, u);
        if (k == 0) {  // u = lambda: square it
#pragma unroll
          for (int j = 0; j < L; j++) a[j] = b[j] = u[j];
        } else if (k == 1) {  // u = lambda^2: x3, then lambda (x1 - x3)
          packed<L>(smem, 2, rows, b);
          gl::sub_mod<L>(u, b, K.p, u);
          packed<L>(smem, 0, rows, b);
          gl::sub_mod<L>(u, b, K.p, u);
#pragma unroll
          for (int j = 0; j < L; j++) out_x[j] = u[j];
          gl::sub_mod<L>(b, u, K.p, b);
        }
      }
      packed<L>(smem, 1, rows, b);
      gl::sub_mod<L>(u, b, K.p, u);
#pragma unroll
      for (int j = 0; j < L; j++) out_y[j] = u[j];
    }
  }
  __syncthreads();
  gl::unstage_rows<L, T, ND>(smem + 4 * rows * RW, x3, base, cnt);
  gl::unstage_rows<L, T, ND>(smem + 5 * rows * RW, y3, base, cnt);
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
  static int opened[gl::MAX_DEVICES] = {};
  Flags2 f;
  for (int k = 0; k < 2; k++) {
    f.ptr[k] = (const unsigned char*)flags[k];
    f.stride[k] = flag_stride[k];
  }
  const int bytes = pre_bytes<gl::limbs_of<ND>>(n);
  cudaError_t e = gl::open_smem(affine_pre_kernel<ND>, bytes, opened);
  if (e != cudaSuccess) return (int)e;
  affine_pre_kernel<ND><<<(n + T - 1) / T, T, bytes, (cudaStream_t)stream>>>(
      make_coords(in, in_stride), f, (long long*)num, (long long*)den,
      (unsigned char*)inf3, n,
      gl::make_curve_const<gl::limbs_of<ND>>(consts, inv, 0));
  return (int)cudaGetLastError();
}

template <int ND>
int launch_post(const void* num, const void* dinv, const void* const* in,
                const long long* in_stride, const void* const* flags,
                const long long* flag_stride, void* x3, void* y3, int n,
                const uint32_t* consts, uint32_t inv, void* stream) {
  static int opened[gl::MAX_DEVICES] = {};
  Flags3 f;
  for (int k = 0; k < 3; k++) {
    f.ptr[k] = (const unsigned char*)flags[k];
    f.stride[k] = flag_stride[k];
  }
  const int bytes = post_bytes<gl::limbs_of<ND>>(n);
  cudaError_t e = gl::open_smem(affine_post_kernel<ND>, bytes, opened);
  if (e != cudaSuccess) return (int)e;
  affine_post_kernel<ND><<<(n + T - 1) / T, T, bytes, (cudaStream_t)stream>>>(
      (const long long*)num, (const long long*)dinv,
      make_coords(in, in_stride), f, (long long*)x3, (long long*)y3, n,
      gl::make_curve_const<gl::limbs_of<ND>>(consts, inv, 0));
  return (int)cudaGetLastError();
}

}  // namespace

// in: four row pointers x1 y1 x2 y2 with row strides in digits; flags: bool
// bytes inf1 inf2 with strides in bytes; num, den [n, nd] and inf3 [n] dense
// outputs; consts: 3 ceil(nd/2) limbs [p | a | one].  Returns
// cudaGetLastError() of the launch, or -1 for a digit count that was not
// built.
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
    case 19: return launch_pre<19>(in, in_stride, flags, flag_stride, num, den, inf3, n, consts, inv, stream);
    case 24: return launch_pre<24>(in, in_stride, flags, flag_stride, num, den, inf3, n, consts, inv, stream);
    case 48: return launch_pre<48>(in, in_stride, flags, flag_stride, num, den, inf3, n, consts, inv, stream);
    case 49: return launch_pre<49>(in, in_stride, flags, flag_stride, num, den, inf3, n, consts, inv, stream);
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
    case 19: return launch_post<19>(num, dinv, in, in_stride, flags, flag_stride, x3, y3, n, consts, inv, stream);
    case 24: return launch_post<24>(num, dinv, in, in_stride, flags, flag_stride, x3, y3, n, consts, inv, stream);
    case 48: return launch_post<48>(num, dinv, in, in_stride, flags, flag_stride, x3, y3, n, consts, inv, stream);
    case 49: return launch_post<49>(num, dinv, in, in_stride, flags, flag_stride, x3, y3, n, consts, inv, stream);
    default: return -1;
  }
}

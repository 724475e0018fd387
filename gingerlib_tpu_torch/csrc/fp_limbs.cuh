// Prime-field arithmetic on 32-bit limbs held in registers, one field element
// per CUDA thread.  Shared by every kernel of the library: Montgomery
// multiply, modular add/sub/neg (register forms, first part), binary-Euclid
// inverse, curve additions, inversion trees, pow chains and Poseidon
// (memory-resident forms, second part).
//
// Boundary layout (see gingerlib_tpu_torch/fields/fp.py): an element is ND
// little-endian 16-bit digits, each stored in an int64, so R = 2^(16*ND).
// Two digits make one limb: L = ND/2 limbs of 32 bits share the same R, which
// is why only even ND is built.
#pragma once

#include <stdint.h>
#include <string.h>

namespace gl {

// Per-field constants, passed to kernels by value so that they sit in the
// kernel-parameter constant bank: fully unrolled loops index them with
// compile-time offsets and they cost no registers.
template <int L>
struct FpConst {
  uint32_t p[L];   // modulus, little-endian limbs
  uint32_t inv;    // -p^-1 mod 2^32
};

template <int L>
__device__ __forceinline__ void load_digits(const long long* __restrict__ src,
                                            uint32_t (&x)[L]) {
  const longlong2* s2 = reinterpret_cast<const longlong2*>(src);
#pragma unroll
  for (int i = 0; i < L; i++) {
    longlong2 d = s2[i];  // rows are 16-byte aligned: ND even, 8-byte digits
    x[i] = ((uint32_t)d.x & 0xFFFFu) | ((uint32_t)d.y << 16);
  }
}

template <int L>
__device__ __forceinline__ void store_digits(long long* __restrict__ dst,
                                             const uint32_t (&x)[L]) {
  longlong2* d2 = reinterpret_cast<longlong2*>(dst);
#pragma unroll
  for (int i = 0; i < L; i++) {
    longlong2 d;
    d.x = (long long)(x[i] & 0xFFFFu);
    d.y = (long long)(x[i] >> 16);
    d2[i] = d;
  }
}

// r = a + b, returns the carry out of the top limb.
template <int L>
__device__ __forceinline__ uint32_t add_limbs(const uint32_t (&a)[L],
                                              const uint32_t (&b)[L],
                                              uint32_t (&r)[L]) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < L; i++) {
    c += (uint64_t)a[i] + b[i];
    r[i] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// r = a - b, returns the borrow out of the top limb (1 where b > a).
template <int L>
__device__ __forceinline__ uint32_t sub_limbs(const uint32_t (&a)[L],
                                              const uint32_t (&b)[L],
                                              uint32_t (&r)[L]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < L; i++) {
    uint64_t d = (uint64_t)a[i] - b[i] - borrow;
    r[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return borrow;
}

// x in [0, 2p) given as L limbs plus a top bit -> x mod p.
template <int L>
__device__ __forceinline__ void cond_sub_p(uint32_t (&x)[L], uint32_t top,
                                           const uint32_t (&p)[L]) {
  uint32_t d[L];
  uint32_t borrow = sub_limbs<L>(x, p, d);
  // x >= p  <=>  the subtraction over L limbs plus the top bit does not
  // go negative
  bool ge = top >= borrow;
#pragma unroll
  for (int i = 0; i < L; i++) x[i] = ge ? d[i] : x[i];
}

template <int L>
__device__ __forceinline__ void add_mod(const uint32_t (&a)[L],
                                        const uint32_t (&b)[L],
                                        const uint32_t (&p)[L],
                                        uint32_t (&r)[L]) {
  uint32_t top = add_limbs<L>(a, b, r);
  cond_sub_p<L>(r, top, p);
}

template <int L>
__device__ __forceinline__ void sub_mod(const uint32_t (&a)[L],
                                        const uint32_t (&b)[L],
                                        const uint32_t (&p)[L],
                                        uint32_t (&r)[L]) {
  uint32_t borrow = sub_limbs<L>(a, b, r);
  uint32_t fixed[L];
  add_limbs<L>(r, p, fixed);  // wraps mod 2^(32L), as wanted
#pragma unroll
  for (int i = 0; i < L; i++) r[i] = borrow ? fixed[i] : r[i];
}

template <int L>
__device__ __forceinline__ bool is_zero(const uint32_t (&a)[L]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < L; i++) acc |= a[i];
  return acc == 0;
}

template <int L>
__device__ __forceinline__ bool is_one(const uint32_t (&a)[L]) {
  uint32_t acc = a[0] ^ 1u;
#pragma unroll
  for (int i = 1; i < L; i++) acc |= a[i];
  return acc == 0;
}

// Montgomery product a*b*R^-1 mod p, R = 2^(32L), by coarsely integrated
// operand scanning (CIOS): for each limb of b, one row of the product and
// one row of the reduction, carried in 64-bit accumulators.  The result is
// canonical (< p) whenever a*b < R*p, i.e. one operand may be any value
// below R as long as the other is below p.
template <int L>
__device__ __forceinline__ void mont_mul(const uint32_t (&a)[L],
                                         const uint32_t (&b)[L],
                                         const uint32_t (&p)[L], uint32_t inv,
                                         uint32_t (&r)[L]) {
  uint32_t t[L + 2];
#pragma unroll
  for (int i = 0; i < L + 2; i++) t[i] = 0;

#pragma unroll
  for (int i = 0; i < L; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < L; j++) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[L] + c;
    t[L] = (uint32_t)s;
    t[L + 1] = (uint32_t)(s >> 32);

    uint32_t m = t[0] * inv;
    s = (uint64_t)m * p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < L; j++) {
      s = (uint64_t)m * p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[L] + c;
    t[L - 1] = (uint32_t)s;
    t[L] = t[L + 1] + (uint32_t)(s >> 32);
  }

#pragma unroll
  for (int i = 0; i < L; i++) r[i] = t[i];
  cond_sub_p<L>(r, t[L], p);
}

// x >>= 1 with `top` shifted into the highest bit.
template <int L>
__device__ __forceinline__ void shr1(uint32_t (&x)[L], uint32_t top) {
#pragma unroll
  for (int i = 0; i < L - 1; i++) x[i] = (x[i] >> 1) | (x[i + 1] << 31);
  x[L - 1] = (x[L - 1] >> 1) | (top << 31);
}

// w/2 mod p for w < p: w/2 if even, (w+p)/2 if odd.
template <int L>
__device__ __forceinline__ void half_mod(uint32_t (&w)[L],
                                         const uint32_t (&p)[L]) {
  uint32_t top = 0;
  if (w[0] & 1u) {
    uint32_t s[L];
    top = add_limbs<L>(w, p, s);
#pragma unroll
    for (int i = 0; i < L; i++) w[i] = s[i];
  }
  shr1<L>(w, top);
}

// ---------------------------------------------------------------------------
// Memory-resident forms, for kernels that chain many field operations (curve
// additions, inversion trees).  Such a kernel keeps its field elements as
// L-limb arrays in thread-local memory and calls these functions, which are
// NOT inlined: each loads its operands into registers, runs the register
// form above and stores the result.  A curve addition then costs the
// registers of ONE multiply (not of a dozen inlined ones with all their
// operands alive), its code stays small, and the extra traffic -- 3L words
// of cached local memory per multiply against 2*L*L + L multiply-adds -- is
// a few percent.  The result may alias an operand.  ``p`` points to the
// modulus limbs (the kernels keep them in shared memory).
// ---------------------------------------------------------------------------

// Constants of one curve (or of one field: a = 0), passed to a kernel by
// value and copied by it into shared memory as [p | a | one].
template <int L>
struct CurveConst {
  uint32_t p[L];    // modulus
  uint32_t a[L];    // curve coefficient a, Montgomery form
  uint32_t one[L];  // R mod p, the Montgomery form of 1
  uint32_t inv;     // -p^-1 mod 2^32
  int a_is_zero;
};

// Host side: the struct from the wrapper's limb array [p | a | one].
template <int L>
inline CurveConst<L> make_curve_const(const uint32_t* consts, uint32_t inv,
                                      int a_is_zero) {
  CurveConst<L> K;
  memcpy(K.p, consts, sizeof(K.p));
  memcpy(K.a, consts + L, sizeof(K.a));
  memcpy(K.one, consts + 2 * L, sizeof(K.one));
  K.inv = inv;
  K.a_is_zero = a_is_zero;
  return K;
}

// To be called by every thread of a block with at least L threads, before
// any thread leaves the kernel: shared[0:L] = p, [L:2L] = a, [2L:3L] = one.
template <int L>
__device__ __forceinline__ void stage_consts(const CurveConst<L>& K,
                                             uint32_t* shared) {
  if (threadIdx.x < L) {
    shared[threadIdx.x] = K.p[threadIdx.x];
    shared[L + threadIdx.x] = K.a[threadIdx.x];
    shared[2 * L + threadIdx.x] = K.one[threadIdx.x];
  }
  __syncthreads();
}

template <int L>
__device__ __noinline__ void mont_mul_mem(const uint32_t* a, const uint32_t* b,
                                          const uint32_t* p, uint32_t inv,
                                          uint32_t* r) {
  uint32_t x[L], y[L], m[L], o[L];
#pragma unroll
  for (int i = 0; i < L; i++) {
    x[i] = a[i];
    y[i] = b[i];
    m[i] = p[i];
  }
  mont_mul<L>(x, y, m, inv, o);
#pragma unroll
  for (int i = 0; i < L; i++) r[i] = o[i];
}

template <int L>
__device__ __noinline__ void add_mod_mem(const uint32_t* a, const uint32_t* b,
                                         const uint32_t* p, uint32_t* r) {
  uint32_t x[L], y[L], m[L], o[L];
#pragma unroll
  for (int i = 0; i < L; i++) {
    x[i] = a[i];
    y[i] = b[i];
    m[i] = p[i];
  }
  add_mod<L>(x, y, m, o);
#pragma unroll
  for (int i = 0; i < L; i++) r[i] = o[i];
}

template <int L>
__device__ __noinline__ void sub_mod_mem(const uint32_t* a, const uint32_t* b,
                                         const uint32_t* p, uint32_t* r) {
  uint32_t x[L], y[L], m[L], o[L];
#pragma unroll
  for (int i = 0; i < L; i++) {
    x[i] = a[i];
    y[i] = b[i];
    m[i] = p[i];
  }
  sub_mod<L>(x, y, m, o);
#pragma unroll
  for (int i = 0; i < L; i++) r[i] = o[i];
}

// r = a^-1 mod p for a plain integer a < p by the binary extended Euclidean
// algorithm; 0 -> 0; r canonical.  The core of the inverse kernel
// (inv_bea.cu), also run per thread by the Poseidon kernel (poseidon.cu).
// Data-dependent: each outer pass halves u and v down to odd numbers
// (halving b or c mod p alongside) and subtracts the smaller from the
// larger, until u or v is 1.
template <int L>
__device__ __noinline__ void inv_bea_mem(const uint32_t* a, const uint32_t* p,
                                         uint32_t* r) {
  uint32_t u[L], v[L], b[L], c[L], t[L], m[L];
#pragma unroll
  for (int j = 0; j < L; j++) {
    u[j] = a[j];
    v[j] = m[j] = p[j];
    b[j] = 0;
    c[j] = 0;
  }
  b[0] = 1;

  if (!is_zero<L>(u)) {
    // every pass of the outer loop removes at least one bit from u or v,
    // so 2 * 32 * L + 2 passes suffice for any input coprime to p; the cap
    // only keeps a malformed input (a multiple of p) from spinning forever
    int guard = 64 * L + 2;
    while (!is_one<L>(u) && !is_one<L>(v) && guard-- > 0) {
      while ((u[0] & 1u) == 0 && !is_zero<L>(u)) {
        shr1<L>(u, 0);
        half_mod<L>(b, m);
      }
      while ((v[0] & 1u) == 0) {
        shr1<L>(v, 0);
        half_mod<L>(c, m);
      }
      uint32_t borrow = sub_limbs<L>(u, v, t);
      if (borrow == 0) {  // u >= v
#pragma unroll
        for (int j = 0; j < L; j++) u[j] = t[j];
        sub_mod<L>(b, c, m, t);
#pragma unroll
        for (int j = 0; j < L; j++) b[j] = t[j];
      } else {
        sub_limbs<L>(v, u, t);
#pragma unroll
        for (int j = 0; j < L; j++) v[j] = t[j];
        sub_mod<L>(c, b, m, t);
#pragma unroll
        for (int j = 0; j < L; j++) c[j] = t[j];
      }
    }
    bool take_b = is_one<L>(u);
#pragma unroll
    for (int j = 0; j < L; j++) t[j] = take_b ? b[j] : c[j];
  } else {
#pragma unroll
    for (int j = 0; j < L; j++) t[j] = 0;
  }
#pragma unroll
  for (int j = 0; j < L; j++) r[j] = t[j];
}

template <int L>
__device__ __forceinline__ void copy_limbs(const uint32_t* src, uint32_t* dst) {
#pragma unroll
  for (int i = 0; i < L; i++) dst[i] = src[i];
}

template <int L>
__device__ __forceinline__ void zero_limbs(uint32_t* dst) {
#pragma unroll
  for (int i = 0; i < L; i++) dst[i] = 0;
}

}  // namespace gl

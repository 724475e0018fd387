// The modular inverse of one field element by one thread, as batched
// divsteps: T. Pornin's optimized binary GCD ("Optimized Binary GCD for
// Modular Inversion", IACR ePrint 2020/972, Algorithm 2, 64-bit
// approximations, 31 divsteps a pass).  The inverse kernel (inv_bea.cu)
// runs it on its one element, the Poseidon kernel (poseidon.cu) on every
// sponge's S-box, and the RNS tree's root reaches it through the inverse
// kernel.
//
//   r = a^-1 mod p for a plain integer a < p (not Montgomery form);
//   0 -> 0; r canonical (< p).
//
// State: x, y (the values being reduced, first a and p) and u, v (their
// Bezout coefficients mod p: x = u a and y = v a mod p), L 32-bit limbs
// each, all in registers.  A pass
//   1. builds 64-bit approximations of x and y: at n = max(len x, len y),
//      the bits n-33 .. n-1 above the low 31 bits (exact where n <= 64);
//   2. runs 31 divsteps on them in registers -- odd x below y swaps the
//      two, odd x takes y away, x halves -- and keeps the 2x2 matrix
//      (f0 g0; f1 g1) that they make, |f| + |g| <= 2^31 in each row, as
//      32-bit words (a first form with 64-bit ones and a serial limb scan
//      took 1.28x as long on an H100);
//   3. sets (x, y) <- (f0 x + g0 y, f1 x + g1 y) / 2^31 over the full
//      width, 32x32->64 multiply-adds with a carried word, and negates a
//      row that comes out negative (step 4 then reads its matrix row
//      negated);
//   4. sets (u, v) by the same matrix, dividing by 2^31 mod p: the multiple
//      m p of p that clears the low 31 bits (m from -p^-1 mod 2^32) is added
//      in the same limb loop, and the result, in (-p, 2p), is brought into
//      [0, p).
// The low 31 bits of the approximations are exact, so every parity the
// divsteps test is the true one and the division in step 3 is exact; a
// comparison of inexact high parts may pick the wrong operand, which step 3
// repairs by the negation.  Each pass takes at least 31 bits off
// len x + len y, so ceil((2 bits(p) - 1) / 31) passes reach x = 0, y = 1
// (49 at 753 bits, 25 at 377, 17 at 253); v is then a^-1.
//
// How the loop ends: a pass starts only while x != 0, at most that bound
// of passes.  Random 753-bit inputs stop after 33-36 passes; inputs such as
// 2^k near the top of p take all 49 (tools/divsteps_model.py finds them,
// tests/test_torch_inv_divsteps.py runs them).  0 stops at once, with v = 0.
// Returns the passes run.
//
// Requires bits(p) <= 32 L - 2 (a row of step 4 is below 2^(32 L + 31) in
// magnitude) and p odd; every field of the library has both.
//
// Compiles with nvcc (a device function) and with a host C++ compiler
// (GL_HD empty), so that the host test can hold it to python's pow.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define GL_HD __device__
#define GL_INLINE __forceinline__
#define GL_NOINLINE __noinline__
#else
#define GL_HD
#define GL_INLINE inline
#define GL_NOINLINE __attribute__((noinline))
#endif

namespace gl {
namespace divsteps {

constexpr int K = 31;                    // divsteps a pass
constexpr uint32_t LOW = (1u << K) - 1;  // the exact low bits

GL_HD GL_INLINE int clz32(uint32_t w) {
#ifdef __CUDA_ARCH__
  return __clz(w);
#else
  return w ? __builtin_clz(w) : 32;
#endif
}

// Passes that suffice for any input below a modulus of `bits` bits.
GL_HD GL_INLINE int pass_bound(int bits) { return (2 * bits - 1 + K - 1) / K; }

// The divsteps keep f and g mod 2^32 (int32 bits, any wrap-around
// harmless): their values lie in [-2^31, 2^31], and the one pattern that two
// values share, 0x80000000, comes with g = 0 (|f| + |g| <= 2^31), where
// either reading gives the same row once the row's result is made
// non-negative -- so a row is read as the int32 bits, negated by a flag.
// One matrix row, as the limb loops take it: |f| and |g| (each <= 2^31)
// and masks that are all ones where f or g, negated by `neg`, is negative.
struct Row {
  uint32_t af, ag, mf, mg;
};

GL_HD GL_INLINE Row row_of(uint32_t f, uint32_t g, uint32_t neg) {
  Row r;
  r.mf = ((f >> 31) ^ neg) ? ~0u : 0u;
  r.mg = ((g >> 31) ^ neg) ? ~0u : 0u;
  r.af = (f >> 31) ? 0u - f : f;
  r.ag = (g >> 31) ? 0u - g : g;
  return r;
}

// f a + g b over limb i, with a and b negated through their masks:
// -a = ~a + 1, so the +1s enter once, as |f| and |g|, in the first carry.
// Every sum stays below 2^64: (2^32 - 1)(|f| + |g|) + the carry < 2^63 +
// 2^32.
GL_HD GL_INLINE uint64_t first_carry(const Row& w) {
  return (uint64_t)(w.af & w.mf) + (w.ag & w.mg);
}

GL_HD GL_INLINE uint64_t mac_row(uint64_t c, const Row& w, uint32_t a,
                                 uint32_t b) {
  c += (uint64_t)(a ^ w.mf) * w.af;
  c += (uint64_t)(b ^ w.mg) * w.ag;
  return c;
}

// The top word of a row: limb L of the two's complement sum (the operands'
// sign words are their masks), whose top bit is the row's sign.
GL_HD GL_INLINE uint32_t top_word(uint64_t c, const Row& w) {
  return (uint32_t)c + w.mf * w.af + w.mg * w.ag;
}

// 64-bit approximations of x and y (step 1).
template <int L>
GL_HD GL_INLINE void approximate(const uint32_t (&x)[L],
                                 const uint32_t (&y)[L], uint64_t& xa,
                                 uint64_t& ya) {
  // the top non-zero limb t of x | y and the one below it, found by an
  // unrolled scan upwards, the last non-zero limb winning (registers
  // cannot be indexed at run time)
  uint32_t xh = 0, xl = x[0], yh = 0, yl = y[0];
  bool wide = false;
#pragma unroll
  for (int j = 1; j < L; j++) {
    const bool nz = (x[j] | y[j]) != 0;
    xh = nz ? x[j] : xh;
    xl = nz ? x[j - 1] : xl;
    yh = nz ? y[j] : yh;
    yl = nz ? y[j - 1] : yl;
    wide = wide || (nz && j >= 2);
  }
  xa = ((uint64_t)xh << 32) | xl;
  ya = ((uint64_t)yh << 32) | yl;
  if (wide) {  // n = 32 t + 32 - s > 64: the top 33 bits and the low 31
    const int sh = K - clz32(xh | yh);
    xa = ((xa >> sh) << K) | (x[0] & LOW);
    ya = ((ya >> sh) << K) | (y[0] & LOW);
  }
}

// 31 divsteps on the approximations (step 2): odd x below y swaps the
// two (and the rows), odd x takes y away, x halves.
GL_HD GL_INLINE void run_divsteps(uint64_t xa, uint64_t ya, uint32_t& f0,
                                  uint32_t& g0, uint32_t& f1, uint32_t& g1) {
  f0 = 1;
  g0 = 0;
  f1 = 0;
  g1 = 1;
#pragma unroll
  for (int j = 0; j < K; j++) {
    const bool odd = xa & 1;
    const uint64_t d = xa - ya;
    const bool swap = odd && xa < ya;
    const uint64_t nx = swap ? 0 - d : (odd ? d : xa);
    ya = swap ? xa : ya;
    xa = nx >> 1;
    const uint32_t tf = f0, tg = g0;
    f0 = swap ? f1 - f0 : (odd ? f0 - f1 : f0);
    g0 = swap ? g1 - g0 : (odd ? g0 - g1 : g0);
    f1 = 2 * (swap ? tf : f1);
    g1 = 2 * (swap ? tg : g1);
  }
}

// x <- -x over L limbs (two's complement).
template <int L>
GL_HD GL_INLINE void negate(uint32_t (&x)[L]) {
  uint64_t c = 1;
#pragma unroll
  for (int i = 0; i < L; i++) {
    c += (uint32_t)~x[i];
    x[i] = (uint32_t)c;
    c >>= 32;
  }
}

// (x, y) <- (f0 x + g0 y, f1 x + g1 y) / 2^31 in place, each result made
// non-negative; neg0 and neg1 say which rows were negated (step 3).  Limb
// i of the results is written once limb i + 1 of the sums is known.
template <int L>
GL_HD GL_INLINE void update_xy(uint32_t (&x)[L], uint32_t (&y)[L],
                               uint32_t f0, uint32_t g0, uint32_t f1,
                               uint32_t g1, uint32_t& neg0, uint32_t& neg1) {
  const Row w0 = row_of(f0, g0, 0), w1 = row_of(f1, g1, 0);
  uint64_t c0 = first_carry(w0), c1 = first_carry(w1);
  uint32_t prev0 = 0, prev1 = 0;
#pragma unroll
  for (int i = 0; i < L; i++) {
    const uint32_t xi = x[i], yi = y[i];
    c0 = mac_row(c0, w0, xi, yi);
    c1 = mac_row(c1, w1, xi, yi);
    const uint32_t t0 = (uint32_t)c0, t1 = (uint32_t)c1;
    c0 >>= 32;
    c1 >>= 32;
    if (i > 0) {
      x[i - 1] = (prev0 >> K) | (t0 << (32 - K));
      y[i - 1] = (prev1 >> K) | (t1 << (32 - K));
    }
    prev0 = t0;
    prev1 = t1;
  }
  const uint32_t top0 = top_word(c0, w0), top1 = top_word(c1, w1);
  x[L - 1] = (prev0 >> K) | (top0 << (32 - K));
  y[L - 1] = (prev1 >> K) | (top1 << (32 - K));
  neg0 = top0 >> 31;
  neg1 = top1 >> 31;
  if (neg0) negate<L>(x);
  if (neg1) negate<L>(y);
}

// A row of step 4 after its shift, in (-p, 2p) as L limbs and a sign:
// -> [0, p).
template <int L>
GL_HD GL_INLINE void reduce_row(uint32_t (&r)[L], uint32_t negative,
                                const uint32_t* p) {
  uint32_t up[L], down[L];
  uint64_t c = 0;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < L; i++) {
    const uint32_t pi = p[i];
    c += (uint64_t)r[i] + pi;
    up[i] = (uint32_t)c;
    c >>= 32;
    const uint64_t d = (uint64_t)r[i] - pi - borrow;
    down[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  // negative: r + p (mod 2^(32 L)); else r - p where r >= p
#pragma unroll
  for (int i = 0; i < L; i++)
    r[i] = negative ? up[i] : (borrow ? r[i] : down[i]);
}

// (u, v) <- (f0 u + g0 v, f1 u + g1 v) / 2^31 mod p in place, rows
// negated as step 3 negated them (step 4).
template <int L>
GL_HD GL_INLINE void update_uv(uint32_t (&u)[L], uint32_t (&v)[L],
                               uint32_t f0, uint32_t g0, uint32_t f1,
                               uint32_t g1, uint32_t neg0, uint32_t neg1,
                               const uint32_t* p, uint32_t pinv) {
  const Row w0 = row_of(f0, g0, neg0), w1 = row_of(f1, g1, neg1);
  uint64_t c0 = first_carry(w0), c1 = first_carry(w1);
  uint32_t prev0 = 0, prev1 = 0, m0 = 0, m1 = 0;
#pragma unroll
  for (int i = 0; i < L; i++) {
    const uint32_t ui = u[i], vi = v[i], pi = p[i];
    c0 = mac_row(c0, w0, ui, vi);
    c1 = mac_row(c1, w1, ui, vi);
    if (i == 0) {  // m p clears the low 31 bits: m = -t p^-1 mod 2^31
      m0 = ((uint32_t)c0 * pinv) & LOW;
      m1 = ((uint32_t)c1 * pinv) & LOW;
    }
    c0 += (uint64_t)m0 * pi;  // below 2^64: + (2^31 - 1)(2^32 - 1)
    c1 += (uint64_t)m1 * pi;
    const uint32_t t0 = (uint32_t)c0, t1 = (uint32_t)c1;
    c0 >>= 32;
    c1 >>= 32;
    if (i > 0) {
      u[i - 1] = (prev0 >> K) | (t0 << (32 - K));
      v[i - 1] = (prev1 >> K) | (t1 << (32 - K));
    }
    prev0 = t0;
    prev1 = t1;
  }
  const uint32_t top0 = top_word(c0, w0), top1 = top_word(c1, w1);
  u[L - 1] = (prev0 >> K) | (top0 << (32 - K));
  v[L - 1] = (prev1 >> K) | (top1 << (32 - K));
  reduce_row<L>(u, top0 >> 31, p);
  reduce_row<L>(v, top1 >> 31, p);
}

template <int L>
GL_HD GL_INLINE bool limbs_zero(const uint32_t (&x)[L]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < L; i++) acc |= x[i];
  return acc == 0;
}

}  // namespace divsteps

// r = a^-1 mod p (0 -> 0), a < p plain; pinv = -p^-1 mod 2^32.  Reads a
// before it writes r (they may alias); p may be in any memory.  Returns
// the passes run.
template <int L>
GL_HD GL_NOINLINE int inv_divsteps(const uint32_t* a, const uint32_t* p,
                                   uint32_t pinv, uint32_t* r) {
  using namespace divsteps;
  uint32_t x[L], y[L], u[L], v[L];
#pragma unroll
  for (int i = 0; i < L; i++) {
    x[i] = a[i];
    y[i] = p[i];
    u[i] = 0;
    v[i] = 0;
  }
  u[0] = 1;
  const int passes = pass_bound(32 * L - clz32(p[L - 1]));
  int pass = 0;
  for (; pass < passes && !limbs_zero<L>(x); pass++) {
    uint64_t xa, ya;
    approximate<L>(x, y, xa, ya);
    uint32_t f0, g0, f1, g1, neg0, neg1;
    run_divsteps(xa, ya, f0, g0, f1, g1);
    update_xy<L>(x, y, f0, g0, f1, g1, neg0, neg1);
    update_uv<L>(u, v, f0, g0, f1, g1, neg0, neg1, p, pinv);
  }
#pragma unroll
  for (int i = 0; i < L; i++) r[i] = v[i];
  return pass;
}

}  // namespace gl

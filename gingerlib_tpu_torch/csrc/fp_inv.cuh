// The modular inverse of one field element by one thread, as batched
// divsteps: T. Pornin's optimized binary GCD ("Optimized Binary GCD for
// Modular Inversion", IACR ePrint 2020/972, Algorithm 2, 64-bit
// approximations, 31 divsteps a pass).  The inverse kernel (inv_bea.cu)
// runs it on its one element, the inversion tree's tail (inv_tree.cu) on
// its root, and the RNS tree's root reaches it through the inverse kernel;
// the Poseidon kernel runs the group form below.
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
//
// The second half of the file is the same algorithm over a group of G
// threads (inv_divsteps_grp), for the Poseidon kernel, whose groups each
// hold their field elements spread over G threads (fp_group.cuh).
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

// ---------------------------------------------------------------------------
// The inverse over a group of G threads (G a power of two dividing L): the
// thread of rank g holds limbs [g M, g M + M), M = L / G, of x, y, u and v.
// A pass of the per-thread form becomes, per rank:
//   1. the approximations: the low words from rank 0 by shuffle; the top
//      non-zero limb of x | y and the one below it from the highest rank
//      whose part is non-zero, found by a ballot (each rank first takes
//      the top limbs of the rank below, for a top limb at its part's
//      bottom);
//   2. the 31 divsteps, redundantly in every rank: the same inputs give
//      every rank the same matrix, with no exchange;
//   3. and 4. the matrix rows over the rank's own limbs, a 64-bit carry
//      chain from a zero carry-in (rank 0 adds the negations' +1s, and
//      forms m of step 4 and hands it to the others); each part's carry
//      word goes to the rank above (from_below), and the one-bit carries
//      left over are resolved by one lookahead (two ballots), as
//      grp_mont_mul of fp_group.cuh does; the top word (the row's sign)
//      is rank G-1's, by shuffle; the division by 2^31 takes the lowest
//      limb of the rank above (from_above).  Negations and the reduction
//      into [0, p) resolve their carries and borrows by lookahead too.
// The loop ends on a group-wide zero test of x, under the per-thread
// form's bound of passes: the pass counts and results are that form's on
// every input.
//
// The ranks talk only through a communicator `Comm`, so that one source
// serves the card and the host test:
//   Comm::N            slots of a per-rank value: 1 on the card (a thread
//                      is its own rank), G on the host (all ranks);
//   each(f)            f(rank) for every rank the caller runs;
//   shfl(v, src)       v of rank src, to every rank;
//   from_above(v)      v of rank + 1 (0 at rank G-1);
//   from_below(v)      v of rank - 1 (0 at rank 0);
//   bits(pred)         bit k: pred of rank k (the same in every rank).
// fp_group.cuh has the card's (GrpComm, over warp shuffles and ballots);
// tests/test_torch_inv_divsteps.py runs the ranks in a loop on the host.
// ---------------------------------------------------------------------------

// A value of each rank the caller runs (slot 0 on the card).
template <class T, int N>
struct Lanes {
  T v[N];
  GL_HD GL_INLINE T& operator[](int r) { return v[N == 1 ? 0 : r]; }
  GL_HD GL_INLINE const T& operator[](int r) const {
    return v[N == 1 ? 0 : r];
  }
};

// M limbs of one value: a rank's part.
template <int M>
struct Part {
  uint32_t w[M];
};

namespace divsteps_grp {

using divsteps::K;
using divsteps::LOW;
using divsteps::Row;

template <int M>
GL_HD GL_INLINE bool zero(const uint32_t (&x)[M]) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < M; j++) acc |= x[j];
  return acc == 0;
}

template <int M>
GL_HD GL_INLINE bool ones(const uint32_t (&x)[M]) {
  uint32_t acc = 0xFFFFFFFFu;
#pragma unroll
  for (int j = 0; j < M; j++) acc &= x[j];
  return acc == 0xFFFFFFFFu;
}

// x += w at the part's lowest limb; returns the carry out (0 or 1).
template <int M>
GL_HD GL_INLINE uint32_t add_word(uint32_t (&x)[M], uint32_t w) {
  uint64_t c = w;
#pragma unroll
  for (int j = 0; j < M; j++) {
    c += x[j];
    x[j] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// x -= b (b <= 1); returns the borrow out.
template <int M>
GL_HD GL_INLINE uint32_t sub_bit(uint32_t (&x)[M], uint32_t b) {
#pragma unroll
  for (int j = 0; j < M; j++) {
    const uint64_t d = (uint64_t)x[j] - b;
    x[j] = (uint32_t)d;
    b = (uint32_t)(d >> 63);
  }
  return b;
}

// One-bit carries across the ranks for NL sums at once: gen[k], part k
// carries out by itself; prop[k], it passes a carry-in on (never both).
// Sets each rank's carry-in cin[k] and top[k], the carry out of rank G-1
// (as Grp::lookahead).  All ballots go first, so that their latencies
// overlap.
template <int G, int NL, class Comm>
GL_HD GL_INLINE void lookahead(const Comm& c,
                               const Lanes<bool, Comm::N> (&gen)[NL],
                               const Lanes<bool, Comm::N> (&prop)[NL],
                               Lanes<uint32_t, Comm::N> (&cin)[NL],
                               uint32_t (&top)[NL]) {
  uint64_t gm[NL], pm[NL];
#pragma unroll
  for (int k = 0; k < NL; k++) {
    gm[k] = c.bits(gen[k]);
    pm[k] = c.bits(prop[k]);
  }
#pragma unroll
  for (int k = 0; k < NL; k++) {
    const uint64_t s = ((gm[k] | pm[k]) + gm[k]) ^ pm[k];
    top[k] = (uint32_t)(s >> G) & 1u;
    c.each([&](int r) { cin[k][r] = (uint32_t)(s >> r) & 1u; });
  }
}

// x <- -x over the group (two's complement over L limbs).
template <int M, int G, class Comm>
GL_HD GL_INLINE void negate(const Comm& c, Lanes<Part<M>, Comm::N>& x) {
  Lanes<bool, Comm::N> gen[1], prop[1];
  c.each([&](int r) {
#pragma unroll
    for (int j = 0; j < M; j++) x[r].w[j] = ~x[r].w[j];
    gen[0][r] = add_word<M>(x[r].w, r == 0 ? 1u : 0u) != 0;
    prop[0][r] = ones<M>(x[r].w);
  });
  Lanes<uint32_t, Comm::N> cin[1];
  uint32_t top[1];
  lookahead<G>(c, gen, prop, cin, top);
  c.each([&](int r) { add_word<M>(x[r].w, cin[0][r]); });
}

// Two rows' sums s = (f a + g b) [+ m p] over each rank's limbs, with each
// part's carry word, carried across the ranks, then divided by 2^31:
// s <- the row / 2^31 over L limbs; top gets each row's top word (limb L
// of the sum, its sign in bit 31), the same in every rank.  The two rows'
// exchanges go out together.
template <int M, int G, class Comm>
GL_HD GL_INLINE void finish_rows(const Comm& c, Lanes<Part<M>, Comm::N>& s0,
                                 Lanes<Part<M>, Comm::N>& s1,
                                 const Lanes<uint32_t, Comm::N>& k0,
                                 const Lanes<uint32_t, Comm::N>& k1,
                                 const Row& w0, const Row& w1,
                                 uint32_t (&top)[2]) {
  const Lanes<uint32_t, Comm::N> b0 = c.from_below(k0);
  const Lanes<uint32_t, Comm::N> b1 = c.from_below(k1);
  Lanes<bool, Comm::N> gen[2], prop[2];
  c.each([&](int r) {
    gen[0][r] = add_word<M>(s0[r].w, b0[r]) != 0;
    prop[0][r] = ones<M>(s0[r].w);
    gen[1][r] = add_word<M>(s1[r].w, b1[r]) != 0;
    prop[1][r] = ones<M>(s1[r].w);
  });
  Lanes<uint32_t, Comm::N> cin[2];
  uint32_t out[2];
  lookahead<G>(c, gen, prop, cin, out);
  Lanes<uint32_t, Comm::N> t0, t1, l0, l1;
  c.each([&](int r) {
    add_word<M>(s0[r].w, cin[0][r]);
    add_word<M>(s1[r].w, cin[1][r]);
    // limb L: rank G-1's carry word and the carry out of the lookahead,
    // and the operands' sign words (their masks) times |f| and |g|
    t0[r] = k0[r] + out[0] + w0.mf * w0.af + w0.mg * w0.ag;
    t1[r] = k1[r] + out[1] + w1.mf * w1.af + w1.mg * w1.ag;
    l0[r] = s0[r].w[0];
    l1[r] = s1[r].w[0];
  });
  top[0] = c.shfl(t0, G - 1)[0];
  top[1] = c.shfl(t1, G - 1)[0];
  const Lanes<uint32_t, Comm::N> a0 = c.from_above(l0);
  const Lanes<uint32_t, Comm::N> a1 = c.from_above(l1);
  c.each([&](int r) {
    const uint32_t n0 = r == G - 1 ? top[0] : a0[r];
    const uint32_t n1 = r == G - 1 ? top[1] : a1[r];
#pragma unroll
    for (int j = 0; j < M - 1; j++) {
      s0[r].w[j] = (s0[r].w[j] >> K) | (s0[r].w[j + 1] << (32 - K));
      s1[r].w[j] = (s1[r].w[j] >> K) | (s1[r].w[j + 1] << (32 - K));
    }
    s0[r].w[M - 1] = (s0[r].w[M - 1] >> K) | (n0 << (32 - K));
    s1[r].w[M - 1] = (s1[r].w[M - 1] >> K) | (n1 << (32 - K));
  });
}

// (x, y) <- (f0 x + g0 y, f1 x + g1 y) / 2^31, each made non-negative;
// neg0 and neg1 say which rows were negated (step 3).
template <int M, int G, class Comm>
GL_HD GL_INLINE void update_xy(const Comm& c, Lanes<Part<M>, Comm::N>& x,
                               Lanes<Part<M>, Comm::N>& y, uint32_t f0,
                               uint32_t g0, uint32_t f1, uint32_t g1,
                               uint32_t& neg0, uint32_t& neg1) {
  using namespace divsteps;
  const Row w0 = row_of(f0, g0, 0), w1 = row_of(f1, g1, 0);
  Lanes<uint32_t, Comm::N> k0, k1;
  c.each([&](int r) {
    uint64_t c0 = r == 0 ? first_carry(w0) : 0;
    uint64_t c1 = r == 0 ? first_carry(w1) : 0;
#pragma unroll
    for (int j = 0; j < M; j++) {
      const uint32_t xj = x[r].w[j], yj = y[r].w[j];
      c0 = mac_row(c0, w0, xj, yj);
      c1 = mac_row(c1, w1, xj, yj);
      x[r].w[j] = (uint32_t)c0;
      y[r].w[j] = (uint32_t)c1;
      c0 >>= 32;
      c1 >>= 32;
    }
    k0[r] = (uint32_t)c0;
    k1[r] = (uint32_t)c1;
  });
  uint32_t top[2];
  finish_rows<M, G>(c, x, y, k0, k1, w0, w1, top);
  neg0 = top[0] >> 31;
  neg1 = top[1] >> 31;
  if (neg0) negate<M, G>(c, x);
  if (neg1) negate<M, G>(c, y);
}

// Two rows of step 4 after their shift, each in (-p, 2p) (negative[k]:
// the row's sign): -> [0, p).
template <int M, int G, class Comm>
GL_HD GL_INLINE void reduce_rows(const Comm& c, Lanes<Part<M>, Comm::N>& x0,
                                 Lanes<Part<M>, Comm::N>& x1,
                                 const uint32_t (&negative)[2],
                                 const Lanes<Part<M>, Comm::N>& p) {
  // per row k: x + p (sums 2k) and x - p (sums 2k + 1)
  Lanes<Part<M>, Comm::N> t[4];
  Lanes<bool, Comm::N> gen[4], prop[4];
  c.each([&](int r) {
#pragma unroll
    for (int k = 0; k < 2; k++) {
      const Part<M>& x = k == 0 ? x0[r] : x1[r];
      uint64_t s = 0;
      uint32_t borrow = 0;
#pragma unroll
      for (int j = 0; j < M; j++) {
        s += (uint64_t)x.w[j] + p[r].w[j];
        t[2 * k][r].w[j] = (uint32_t)s;
        s >>= 32;
        const uint64_t d = (uint64_t)x.w[j] - p[r].w[j] - borrow;
        t[2 * k + 1][r].w[j] = (uint32_t)d;
        borrow = (uint32_t)(d >> 63);
      }
      gen[2 * k][r] = s != 0;
      prop[2 * k][r] = ones<M>(t[2 * k][r].w);
      gen[2 * k + 1][r] = borrow != 0;
      prop[2 * k + 1][r] = zero<M>(t[2 * k + 1][r].w);
    }
  });
  Lanes<uint32_t, Comm::N> cin[4];
  uint32_t out[4];
  lookahead<G>(c, gen, prop, cin, out);
  // negative: x + p (mod 2^(32 L)); else x - p where x >= p (no borrow
  // out of the top)
  c.each([&](int r) {
#pragma unroll
    for (int k = 0; k < 2; k++) {
      Part<M>& x = k == 0 ? x0[r] : x1[r];
      add_word<M>(t[2 * k][r].w, cin[2 * k][r]);
      sub_bit<M>(t[2 * k + 1][r].w, cin[2 * k + 1][r]);
      const bool below_p = out[2 * k + 1] != 0;
#pragma unroll
      for (int j = 0; j < M; j++)
        x.w[j] = negative[k] ? t[2 * k][r].w[j]
                             : (below_p ? x.w[j] : t[2 * k + 1][r].w[j]);
    }
  });
}

// (u, v) <- (f0 u + g0 v, f1 u + g1 v) / 2^31 mod p, rows negated as step
// 3 negated them (step 4).
template <int M, int G, class Comm>
GL_HD GL_INLINE void update_uv(const Comm& c, Lanes<Part<M>, Comm::N>& u,
                               Lanes<Part<M>, Comm::N>& v, uint32_t f0,
                               uint32_t g0, uint32_t f1, uint32_t g1,
                               uint32_t neg0, uint32_t neg1,
                               const Lanes<Part<M>, Comm::N>& p,
                               uint32_t pinv) {
  using namespace divsteps;
  const Row w0 = row_of(f0, g0, neg0), w1 = row_of(f1, g1, neg1);
  // m p clears the low 31 bits: m = -t p^-1 mod 2^31, t the sum's lowest
  // word, which rank 0 alone holds
  Lanes<uint32_t, Comm::N> t0, t1;
  c.each([&](int r) {
    const uint64_t a = mac_row(first_carry(w0), w0, u[r].w[0], v[r].w[0]);
    const uint64_t b = mac_row(first_carry(w1), w1, u[r].w[0], v[r].w[0]);
    t0[r] = ((uint32_t)a * pinv) & LOW;
    t1[r] = ((uint32_t)b * pinv) & LOW;
  });
  const uint32_t m0 = c.shfl(t0, 0)[0], m1 = c.shfl(t1, 0)[0];
  Lanes<uint32_t, Comm::N> k0, k1;
  c.each([&](int r) {
    uint64_t c0 = r == 0 ? first_carry(w0) : 0;
    uint64_t c1 = r == 0 ? first_carry(w1) : 0;
#pragma unroll
    for (int j = 0; j < M; j++) {
      const uint32_t uj = u[r].w[j], vj = v[r].w[j], pj = p[r].w[j];
      c0 = mac_row(c0, w0, uj, vj);
      c1 = mac_row(c1, w1, uj, vj);
      c0 += (uint64_t)m0 * pj;
      c1 += (uint64_t)m1 * pj;
      u[r].w[j] = (uint32_t)c0;
      v[r].w[j] = (uint32_t)c1;
      c0 >>= 32;
      c1 >>= 32;
    }
    k0[r] = (uint32_t)c0;
    k1[r] = (uint32_t)c1;
  });
  uint32_t top[2];
  finish_rows<M, G>(c, u, v, k0, k1, w0, w1, top);
  const uint32_t negative[2] = {top[0] >> 31, top[1] >> 31};
  reduce_rows<M, G>(c, u, v, negative, p);
}

// One pass's exchanges before the divsteps, sent together: the group-wide
// zero test of x (returned), and the 64-bit approximations of x and y
// (step 1), the same in every rank.
template <int M, int G, class Comm>
GL_HD GL_INLINE bool approximate(const Comm& c,
                                 const Lanes<Part<M>, Comm::N>& x,
                                 const Lanes<Part<M>, Comm::N>& y,
                                 uint64_t& xa, uint64_t& ya) {
  Lanes<uint32_t, Comm::N> xt, yt, x0, y0;
  Lanes<bool, Comm::N> zx, nz;
  c.each([&](int r) {
    xt[r] = x[r].w[M - 1];
    yt[r] = y[r].w[M - 1];
    x0[r] = x[r].w[0];
    y0[r] = y[r].w[0];
    zx[r] = zero<M>(x[r].w);
    nz[r] = !(zx[r] && zero<M>(y[r].w));
  });
  const uint32_t xzero = c.bits(zx), ranks = c.bits(nz);
  const Lanes<uint32_t, Comm::N> xb = c.from_below(xt), yb = c.from_below(yt);
  const uint32_t lowx = c.shfl(x0, 0)[0], lowy = c.shfl(y0, 0)[0];
  if (xzero == (G == 32 ? 0xFFFFFFFFu : (1u << G) - 1u)) return true;
  const int h = ranks ? 31 - divsteps::clz32(ranks) : 0;
  // each rank's candidate: its top non-zero limb (the last one found
  // scanning upwards), the limb below it, and the top limb's index
  Lanes<uint32_t, Comm::N> xh, xl, yh, yl, top;
  c.each([&](int r) {
    uint32_t a = x[r].w[0], b = xb[r], d = y[r].w[0], e = yb[r];
    int t = 0;
#pragma unroll
    for (int j = 1; j < M; j++) {
      const bool here = (x[r].w[j] | y[r].w[j]) != 0;
      a = here ? x[r].w[j] : a;
      b = here ? x[r].w[j - 1] : b;
      d = here ? y[r].w[j] : d;
      e = here ? y[r].w[j - 1] : e;
      t = here ? j : t;
    }
    t += r * M;
    // limb 0 is the top: no limb below it, and the approximation is the
    // low limb itself (as the per-thread scan leaves it)
    xh[r] = t == 0 ? 0u : a;
    xl[r] = t == 0 ? a : b;
    yh[r] = t == 0 ? 0u : d;
    yl[r] = t == 0 ? d : e;
    top[r] = (uint32_t)t;
  });
  const uint32_t hx = c.shfl(xh, h)[0], lx = c.shfl(xl, h)[0];
  const uint32_t hy = c.shfl(yh, h)[0], ly = c.shfl(yl, h)[0];
  const uint32_t t = c.shfl(top, h)[0];
  xa = ((uint64_t)hx << 32) | lx;
  ya = ((uint64_t)hy << 32) | ly;
  if (t >= 2) {  // n > 64: the top 33 bits and the low 31
    const int sh = K - divsteps::clz32(hx | hy);
    xa = ((xa >> sh) << K) | (lowx & LOW);
    ya = ((ya >> sh) << K) | (lowy & LOW);
  }
  return false;
}

}  // namespace divsteps_grp

// r = a^-1 mod p (0 -> 0) over a group: a, p and r are the ranks' parts
// (a < p plain; pinv = -p^-1 mod 2^32); called by every rank of the group
// together.  Returns the passes run (the same in every rank, and equal to
// inv_divsteps's on the same input).
template <int L, int G, class Comm>
GL_HD GL_INLINE int inv_divsteps_grp(
    const Comm& c, const Lanes<Part<L / G>, Comm::N>& a,
    const Lanes<Part<L / G>, Comm::N>& p, uint32_t pinv,
    Lanes<Part<L / G>, Comm::N>& r) {
  static_assert(G >= 1 && L % G == 0, "a group divides the limbs");
  using namespace divsteps_grp;
  constexpr int M = L / G;
  Lanes<Part<M>, Comm::N> x, y, u, v;
  Lanes<uint32_t, Comm::N> ptop;
  c.each([&](int k) {
#pragma unroll
    for (int j = 0; j < M; j++) {
      x[k].w[j] = a[k].w[j];
      y[k].w[j] = p[k].w[j];
      u[k].w[j] = 0;
      v[k].w[j] = 0;
    }
    if (k == 0) u[k].w[0] = 1;
    ptop[k] = p[k].w[M - 1];
  });
  const uint32_t pt = c.shfl(ptop, G - 1)[0];
  const int passes = divsteps::pass_bound(32 * L - divsteps::clz32(pt));
  int pass = 0;
  for (; pass < passes; pass++) {
    uint64_t xa, ya;
    if (approximate<M, G>(c, x, y, xa, ya)) break;  // x = 0
    uint32_t f0, g0, f1, g1, neg0, neg1;
    divsteps::run_divsteps(xa, ya, f0, g0, f1, g1);
    update_xy<M, G>(c, x, y, f0, g0, f1, g1, neg0, neg1);
    update_uv<M, G>(c, u, v, f0, g0, f1, g1, neg0, neg1, p, pinv);
  }
  c.each([&](int k) {
#pragma unroll
    for (int j = 0; j < M; j++) r[k].w[j] = v[k].w[j];
  });
  return pass;
}

}  // namespace gl

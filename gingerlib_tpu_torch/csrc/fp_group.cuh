// Prime-field arithmetic with one field element spread over a group of G
// threads of a warp (G a power of two, G | L): the thread of rank g holds
// limbs [g*M, g*M + M), M = L / G, of every value, in registers.  Used by
// the projective addition (ec_add.cu), whose one-thread form was bound by
// the latency of its serial carry chains: a lane's dependent chain of
// multiply-adds is about 2L/G long a Montgomery row here instead of 2L, and
// a batch has G times as many threads to hide latency with.
//
// Every function is called by all G threads of a group together and
// returns the same value to each (results are distributed like operands).
// Values cross threads only through warp shuffles and ballots restricted to
// the group's lanes, so the groups of a warp may take different branches.
// Carries between the threads' parts are resolved by lookahead: a thread's
// part generates a carry, or propagates one (all ones; for a borrow, all
// zeros), and one ballot of each gives every thread its carry-in (lookahead
// below), also across a run of all-ones parts.
//
// The results equal those of the one-thread forms in fp_limbs.cuh digit for
// digit on every input (the same integer steps; only their placement
// differs).  The inverse over a group is fp_inv.cuh's inv_divsteps_grp,
// with GrpComm below as its communicator.
#pragma once

#include <stdint.h>

#include "fp_inv.cuh"
#include "fp_limbs.cuh"

namespace gl {

template <int L, int G>
struct Grp {
  static_assert(G >= 2 && G <= 32 && (G & (G - 1)) == 0 && L % G == 0,
                "a group is a power of two of threads dividing L");
  static constexpr int M = L / G;                 // limbs a thread
  static constexpr uint32_t ALL = G == 32 ? 0xFFFFFFFFu : (1u << G) - 1u;
  unsigned mask;  // the group's lanes in its warp
  int rank;       // 0 .. G-1: the thread holds limbs rank*M ..
  int lane0;      // the group's lowest lane

  __device__ __forceinline__ static Grp of_thread() {
    Grp g;
    int lane = threadIdx.x & 31;
    g.rank = lane & (G - 1);
    g.lane0 = lane - g.rank;
    g.mask = ALL << g.lane0;
    return g;
  }
  // v of the thread of rank src
  __device__ __forceinline__ uint32_t shfl(uint32_t v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
  // v of rank + 1 (rank G-1: 0)
  __device__ __forceinline__ uint32_t from_above(uint32_t v) const {
    uint32_t w = __shfl_down_sync(mask, v, 1, G);
    return rank == G - 1 ? 0u : w;
  }
  // v of rank - 1 (rank 0: 0)
  __device__ __forceinline__ uint32_t from_below(uint32_t v) const {
    uint32_t w = __shfl_up_sync(mask, v, 1, G);
    return rank == 0 ? 0u : w;
  }
  // bit k: pred of rank k
  __device__ __forceinline__ uint32_t bits(bool pred) const {
    return (__ballot_sync(mask, pred) >> lane0) & ALL;
  }
  __device__ __forceinline__ bool all(bool pred) const {
    return bits(pred) == ALL;
  }
  // One-bit carries across the group.  gen: this thread's part carries out
  // by itself; prop: it passes a carry-in on (never both).  Returns this
  // thread's carry-in; `top` gets the carry out of rank G-1.  The carry into
  // rank k is bit k of ((gen | prop) + gen) ^ prop over the group's bits:
  // the carries of the sum of two numbers whose bits generate and propagate
  // as the parts do.
  __device__ __forceinline__ uint32_t lookahead(bool gen, bool prop,
                                                uint32_t& top) const {
    uint64_t gm = bits(gen), pm = bits(prop);
    uint64_t c = ((gm | pm) + gm) ^ pm;
    top = (uint32_t)(c >> G) & 1u;
    return (uint32_t)(c >> rank) & 1u;
  }
};

// --- a thread's part: M limbs ----------------------------------------------

template <int M>
__device__ __forceinline__ bool part_zero(const uint32_t (&x)[M]) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < M; j++) acc |= x[j];
  return acc == 0;
}

template <int M>
__device__ __forceinline__ bool part_ones(const uint32_t (&x)[M]) {
  uint32_t acc = 0xFFFFFFFFu;
#pragma unroll
  for (int j = 0; j < M; j++) acc &= x[j];
  return acc == 0xFFFFFFFFu;
}

// x += w (one word at the part's lowest limb); returns the carry out.
template <int M>
__device__ __forceinline__ uint32_t part_add_word(uint32_t (&x)[M],
                                                  uint32_t w) {
  uint64_t c = w;
#pragma unroll
  for (int j = 0; j < M; j++) {
    c += x[j];
    x[j] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// x -= w (w <= 1); returns the borrow out.
template <int M>
__device__ __forceinline__ uint32_t part_sub_bit(uint32_t (&x)[M],
                                                 uint32_t w) {
  uint32_t borrow = w;
#pragma unroll
  for (int j = 0; j < M; j++) {
    uint64_t d = (uint64_t)x[j] - borrow;
    x[j] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return borrow;
}

// --- field operations over a group -----------------------------------------

// x in [0, 2p) given as the group's limbs plus a top bit (the same in every
// thread) -> x mod p.
template <int L, int G>
__device__ __forceinline__ void grp_cond_sub_p(
    const Grp<L, G>& g, uint32_t (&x)[Grp<L, G>::M], uint32_t top,
    const uint32_t (&p)[Grp<L, G>::M]) {
  constexpr int M = Grp<L, G>::M;
  uint32_t d[M];
  uint32_t out;
  uint32_t own = sub_limbs<M>(x, p, d);
  part_sub_bit<M>(d, g.lookahead(own != 0, part_zero<M>(d), out));
  bool ge = top >= out;
#pragma unroll
  for (int j = 0; j < M; j++) x[j] = ge ? d[j] : x[j];
}

template <int L, int G>
__device__ __forceinline__ void grp_add_mod(
    const Grp<L, G>& g, const uint32_t (&a)[Grp<L, G>::M],
    const uint32_t (&b)[Grp<L, G>::M], const uint32_t (&p)[Grp<L, G>::M],
    uint32_t (&r)[Grp<L, G>::M]) {
  constexpr int M = Grp<L, G>::M;
  uint32_t top;
  uint32_t own = add_limbs<M>(a, b, r);
  part_add_word<M>(r, g.lookahead(own != 0, part_ones<M>(r), top));
  grp_cond_sub_p<L, G>(g, r, top, p);
}

template <int L, int G>
__device__ __forceinline__ void grp_sub_mod(
    const Grp<L, G>& g, const uint32_t (&a)[Grp<L, G>::M],
    const uint32_t (&b)[Grp<L, G>::M], const uint32_t (&p)[Grp<L, G>::M],
    uint32_t (&r)[Grp<L, G>::M]) {
  constexpr int M = Grp<L, G>::M;
  uint32_t borrow, unused;
  uint32_t own = sub_limbs<M>(a, b, r);
  part_sub_bit<M>(r, g.lookahead(own != 0, part_zero<M>(r), borrow));
  if (borrow) {  // the same in every thread of the group
    uint32_t f[M];
    own = add_limbs<M>(r, p, f);  // wraps mod 2^(32L), as wanted
    part_add_word<M>(f, g.lookahead(own != 0, part_ones<M>(f), unused));
#pragma unroll
    for (int j = 0; j < M; j++) r[j] = f[j];
  }
}

template <int L, int G>
__device__ __forceinline__ bool grp_is_zero(const Grp<L, G>& g,
                                            const uint32_t (&x)[Grp<L, G>::M]) {
  return g.all(part_zero<Grp<L, G>::M>(x));
}

// Montgomery product a*b*R^-1 mod p by CIOS over the group: for each limb
// b_i (broadcast by its owner) every thread adds a_j*b_i over its part; the
// lowest thread forms m = t_0 * inv and broadcasts it; every thread adds
// m*p_j; the shift by one limb takes the lowest word of the thread above.
// Each thread keeps the carry out of its part as a deferred word C at the
// position of the next part (C <= 3 after every row), and folds it into its
// own top limb at the shift.  After the last row each part adds the C of
// the part below, and the lookahead resolves the one-bit carries left.  The
// result is canonical whenever a*b < R*p, and equal to mont_mul's of
// fp_limbs.cuh on every input.
template <int L, int G>
__device__ __forceinline__ void grp_mont_mul(
    const Grp<L, G>& g, const uint32_t (&a)[Grp<L, G>::M],
    const uint32_t (&b)[Grp<L, G>::M], const uint32_t (&p)[Grp<L, G>::M],
    uint32_t inv, uint32_t (&r)[Grp<L, G>::M]) {
  constexpr int M = Grp<L, G>::M;
  uint32_t t[M];
#pragma unroll
  for (int j = 0; j < M; j++) t[j] = 0;
  uint32_t C = 0;

#pragma unroll
  for (int i = 0; i < L; i++) {
    const uint32_t bi = g.shfl(b[i % M], i / M);
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < M; j++) {
      uint64_t s = (uint64_t)a[j] * bi + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t top = c + C;
    const uint32_t m = g.shfl(t[0] * inv, 0);
    c = 0;
#pragma unroll
    for (int j = 0; j < M; j++) {
      uint64_t s = (uint64_t)m * p[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    top += c;
    // rank 0's lowest word is now 0; every other lowest word moves down
    const uint32_t below = g.from_above(t[0]);
#pragma unroll
    for (int j = 0; j < M - 1; j++) t[j] = t[j + 1];
    top += below;
    t[M - 1] = (uint32_t)top;
    C = (uint32_t)(top >> 32);
  }

  // the deferred carries: C of rank g sits at limb (g + 1) * M, rank G-1's
  // is the top word.  Adding C of the rank below leaves one-bit carries e;
  // a part that carries holds less than 4, so it passes no carry-in on.
  const uint32_t top_c = g.shfl(C, G - 1);
  const uint32_t e = part_add_word<M>(t, g.from_below(C));
  uint32_t out;
  part_add_word<M>(t, g.lookahead(e != 0, part_ones<M>(t), out));
  const uint32_t top = top_c + out;
#pragma unroll
  for (int j = 0; j < M; j++) r[j] = t[j];
  grp_cond_sub_p<L, G>(g, r, top, p);
}

// r = (a0 b0 + a1 b1 + a2 b2) R^-1 mod p: three products and ONE
// Montgomery reduction, by the same CIOS rows as grp_mont_mul with the
// three products' limbs added in each row (a dot product of three, as the
// Poseidon mix takes it).  Every operand below p and 3p < R, so the sum of
// the products is below 3 p^2 < R p and the result, below 2p before the
// last subtraction, is canonical: the residue the three multiplies and two
// additions give.  The deferred carry C stays below 6.
template <int L, int G>
__device__ __forceinline__ void grp_mont_sum3(
    const Grp<L, G>& g, const uint32_t (&a0)[Grp<L, G>::M],
    const uint32_t (&b0)[Grp<L, G>::M], const uint32_t (&a1)[Grp<L, G>::M],
    const uint32_t (&b1)[Grp<L, G>::M], const uint32_t (&a2)[Grp<L, G>::M],
    const uint32_t (&b2)[Grp<L, G>::M], const uint32_t (&p)[Grp<L, G>::M],
    uint32_t inv, uint32_t (&r)[Grp<L, G>::M]) {
  constexpr int M = Grp<L, G>::M;
  uint32_t t[M];
#pragma unroll
  for (int j = 0; j < M; j++) t[j] = 0;
  uint32_t C = 0;

#pragma unroll
  for (int i = 0; i < L; i++) {
    const uint32_t x0 = g.shfl(b0[i % M], i / M);
    const uint32_t x1 = g.shfl(b1[i % M], i / M);
    const uint32_t x2 = g.shfl(b2[i % M], i / M);
    uint64_t top = C;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < M; j++) {
      uint64_t s = (uint64_t)a0[j] * x0 + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    top += c;
    c = 0;
#pragma unroll
    for (int j = 0; j < M; j++) {
      uint64_t s = (uint64_t)a1[j] * x1 + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    top += c;
    c = 0;
#pragma unroll
    for (int j = 0; j < M; j++) {
      uint64_t s = (uint64_t)a2[j] * x2 + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    top += c;
    const uint32_t m = g.shfl(t[0] * inv, 0);
    c = 0;
#pragma unroll
    for (int j = 0; j < M; j++) {
      uint64_t s = (uint64_t)m * p[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    top += c;
    const uint32_t below = g.from_above(t[0]);
#pragma unroll
    for (int j = 0; j < M - 1; j++) t[j] = t[j + 1];
    top += below;
    t[M - 1] = (uint32_t)top;
    C = (uint32_t)(top >> 32);
  }

  // the deferred carries, as grp_mont_mul resolves them (a part that
  // carries after adding C of the rank below holds less than 6)
  const uint32_t top_c = g.shfl(C, G - 1);
  const uint32_t e = part_add_word<M>(t, g.from_below(C));
  uint32_t out;
  part_add_word<M>(t, g.lookahead(e != 0, part_ones<M>(t), out));
  const uint32_t top = top_c + out;
#pragma unroll
  for (int j = 0; j < M; j++) r[j] = t[j];
  grp_cond_sub_p<L, G>(g, r, top, p);
}

// Rows of the boundary layout: the thread of rank g reads and writes the
// digits of its own limbs, a contiguous 16*M bytes; the group covers the row.
template <int L, int G>
__device__ __forceinline__ void grp_load(const Grp<L, G>& g,
                                         const long long* __restrict__ row,
                                         uint32_t (&x)[Grp<L, G>::M]) {
  load_digits<Grp<L, G>::M>(row + 2 * Grp<L, G>::M * g.rank, x);
}

template <int L, int G>
__device__ __forceinline__ void grp_store(const Grp<L, G>& g,
                                          long long* __restrict__ row,
                                          const uint32_t (&x)[Grp<L, G>::M]) {
  store_digits<Grp<L, G>::M>(row + 2 * Grp<L, G>::M * g.rank, x);
}

// Parts in shared memory: value e of an array of L-limb values at word
// offset `base` of `sh`, the thread's own limbs only (so a group needs no
// barrier between its own store and load of a value).
template <int L, int G>
__device__ __forceinline__ void grp_ld_sh(const Grp<L, G>& g,
                                          const uint32_t* sh, int e,
                                          uint32_t (&x)[Grp<L, G>::M]) {
  constexpr int M = Grp<L, G>::M;
  const uint32_t* s = sh + e * L + g.rank * M;
#pragma unroll
  for (int j = 0; j < M; j++) x[j] = s[j];
}

template <int L, int G>
__device__ __forceinline__ void grp_st_sh(const Grp<L, G>& g, uint32_t* sh,
                                          int e,
                                          const uint32_t (&x)[Grp<L, G>::M]) {
  constexpr int M = Grp<L, G>::M;
  uint32_t* s = sh + e * L + g.rank * M;
#pragma unroll
  for (int j = 0; j < M; j++) s[j] = x[j];
}

template <int M>
__device__ __forceinline__ void part_copy(const uint32_t (&a)[M],
                                          uint32_t (&r)[M]) {
#pragma unroll
  for (int j = 0; j < M; j++) r[j] = a[j];
}

// r = c ? a : b, limb by limb
template <int M>
__device__ __forceinline__ void part_select(bool c, const uint32_t (&a)[M],
                                            const uint32_t (&b)[M],
                                            uint32_t (&r)[M]) {
#pragma unroll
  for (int j = 0; j < M; j++) r[j] = c ? a[j] : b[j];
}

// The communicator of fp_inv.cuh's inv_divsteps_grp on the card: each
// thread is its own rank (one slot), over the group's shuffles and ballots.
template <int L, int G>
struct GrpComm {
  static constexpr int N = 1;
  Grp<L, G> g;

  template <class F>
  __device__ __forceinline__ void each(F f) const {
    f(g.rank);
  }
  __device__ __forceinline__ Lanes<uint32_t, 1> shfl(
      const Lanes<uint32_t, 1>& v, int src) const {
    Lanes<uint32_t, 1> o;
    o.v[0] = g.shfl(v.v[0], src);
    return o;
  }
  __device__ __forceinline__ Lanes<uint32_t, 1> from_above(
      const Lanes<uint32_t, 1>& v) const {
    Lanes<uint32_t, 1> o;
    o.v[0] = g.from_above(v.v[0]);
    return o;
  }
  __device__ __forceinline__ Lanes<uint32_t, 1> from_below(
      const Lanes<uint32_t, 1>& v) const {
    Lanes<uint32_t, 1> o;
    o.v[0] = g.from_below(v.v[0]);
    return o;
  }
  __device__ __forceinline__ uint32_t bits(const Lanes<bool, 1>& p) const {
    return g.bits(p.v[0]);
  }
};

// r = a^-1 mod p (0 -> 0) for a plain a < p, over the group: parts in
// registers, pinv = -p^-1 mod 2^32.  Returns the passes run.
template <int L, int G>
__device__ __forceinline__ int grp_inv(const Grp<L, G>& g,
                                       const uint32_t (&a)[Grp<L, G>::M],
                                       const uint32_t (&p)[Grp<L, G>::M],
                                       uint32_t pinv,
                                       uint32_t (&r)[Grp<L, G>::M]) {
  constexpr int M = Grp<L, G>::M;
  GrpComm<L, G> c{g};
  Lanes<Part<M>, 1> la, lp, lr;
  part_copy<M>(a, la.v[0].w);
  part_copy<M>(p, lp.v[0].w);
  const int passes = inv_divsteps_grp<L, G>(c, la, lp, pinv, lr);
  part_copy<M>(lr.v[0].w, r);
  return passes;
}

}  // namespace gl

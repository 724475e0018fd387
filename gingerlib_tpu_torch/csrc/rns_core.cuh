// Double-base RNS Montgomery arithmetic, one field element per WARP.
// Shared by the RNS multiply (rns_mont.cu, K7) and the RNS batched affine
// addition (ec_rns.cu, K8).  The scheme, its bounds and the alpha estimate
// are those of gingerlib_tpu_torch/ops/rns.py (and of the JAX package's
// ops/rns.py); the functions here compute the same residues.
//
// Packed layout: an element is a row of 128 32-bit words, base-A channel i
// in word i, base-B channel j in word 64 + j (k <= 64 channels a base),
// every other word zero.  A warp owns one element: lane t holds the words
// t and t + 32 of base A and 64 + t and 96 + t of base B (struct Elem), so
// all channelwise steps are two operations a thread on each base, and loads
// and stores of a row are four coalesced 128-byte transactions.
//
// Constants (one block of 32-bit words, copied into shared memory):
//   rows [N_ROWS][128]: moduli m, mu = floor(2^32 / m), Kawamura sigma
//     factors, alpha weights w, -p^-1 (A words), p and M_A^-1 (B words),
//     |M_A|_{m'} (B words), |M_B|_m (A words), 2^32 mod m.  Words outside
//     the channels hold m = 1, mu = 2^32 - 1 and zeros, so that every step
//     leaves them 0 without a test.
//   EXT_AB [k][64]: |M_A/m_i|_{m'_j} for source channel i, destination j;
//   EXT_BA [k][64]: |M_B/m'_j|_{m_i} for source j, destination i.
//
// Channel reduction: for any 32-bit v, q = umulhi(v, mu) is floor(v/m) or
// one less (mu = floor(2^32/m) errs by less than one part in 2^32 of v), so
// one conditional subtract gives v mod m: exact, whatever v, unlike the
// TPU's Barrett form, which needed v < 2^29.5 and four subtracts.
//
// Base extension: the sigmas of the source base go to a 64-word scratch row
// of the warp in shared memory; each lane accumulates the inner products of
// its two destination channels over the k sigmas in 64 bits (k terms below
// 2^28 each: < 2^34), reads the constant matrix row by row (conflict-free:
// lane t reads words t and t + 32 of a row), and reduces once.  alpha is a
// warp sum of sigma * w (< 2^31, see rns.py MAX_K).  The TPU split these
// products into 7-bit bf16 halves for its matrix unit; that was the
// hardware's need, not the function's, and is not carried over.
#pragma once

#include <stdint.h>

namespace rns {

constexpr int LANES = 128;           // words of a packed element
constexpr int B_ROW = 64;            // first word of base B
constexpr int W_BITS = 25;
constexpr uint32_t ALPHA_OFF = 1u << 20;
constexpr unsigned FULL = 0xFFFFFFFFu;

enum Row { M, MU, SIG, W, NEGPINV, PB, MAINV, CORR_AB, CORR_BA, P32, N_ROWS };

// 32-bit words of the constant block for k channels a base
__host__ __device__ constexpr int const_words(int k) {
  return N_ROWS * LANES + 2 * k * B_ROW;
}

struct Consts {                      // views into shared memory
  const uint32_t* row;               // [N_ROWS][LANES]
  const uint32_t* ext_ab;            // [k][64]
  const uint32_t* ext_ba;            // [k][64]
  int k;
};

__device__ __forceinline__ Consts consts_at(const uint32_t* sm, int k) {
  Consts K;
  K.row = sm;
  K.ext_ab = sm + N_ROWS * LANES;
  K.ext_ba = K.ext_ab + k * B_ROW;
  K.k = k;
  return K;
}

// Copies `words` words into shared memory with the whole block (no barrier).
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src,
                                      int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
}

struct Elem {
  uint32_t a[2];   // words lane, lane + 32
  uint32_t b[2];   // words 64 + lane, 96 + lane
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int col_a(int q) { return q * 32 + lane_id(); }
__device__ __forceinline__ int col_b(int q) {
  return B_ROW + q * 32 + lane_id();
}

__device__ __forceinline__ uint32_t rowv(const Consts& K, int r, int c) {
  return K.row[r * LANES + c];
}

// v mod m for any 32-bit v
__device__ __forceinline__ uint32_t mod_m(uint32_t v, uint32_t m,
                                          uint32_t mu) {
  uint32_t r = v - __umulhi(v, mu) * m;
  return r >= m ? r - m : r;
}

__device__ __forceinline__ uint32_t mod_c(const Consts& K, uint32_t v,
                                          int c) {
  return mod_m(v, rowv(K, M, c), rowv(K, MU, c));
}

// v mod m for v < 2^50
__device__ __forceinline__ uint32_t mod_c64(const Consts& K, uint64_t v,
                                            int c) {
  uint32_t lo = mod_c(K, (uint32_t)v, c);
  return mod_c(K, lo + (uint32_t)(v >> 32) * rowv(K, P32, c), c);
}

__device__ __forceinline__ uint32_t mulmod(const Consts& K, uint32_t a,
                                           uint32_t b, int c) {
  return mod_c(K, a * b, c);         // residues < 2^14: a * b < 2^28
}

// the extension's destination residue: (acc - alpha * |M_src|) mod m
__device__ __forceinline__ uint32_t ext_finish(const Consts& K, uint64_t acc,
                                               uint32_t alpha, int corr_row,
                                               int c) {
  uint32_t r = mod_c64(K, acc, c);
  uint32_t s = mod_c(K, alpha * rowv(K, corr_row, c), c);
  return r >= s ? r - s : r + rowv(K, M, c) - s;
}

// inner products of the warp's scratch sigmas with the two destination
// columns of this lane (destination channel lane and lane + 32)
__device__ __forceinline__ void ext_dot(const uint32_t* sig,
                                        const uint32_t* mat, int k,
                                        uint64_t (&acc)[2]) {
  const int t = lane_id();
  acc[0] = acc[1] = 0;
  for (int i = 0; i < k; i++) {
    uint32_t s = sig[i];
    acc[0] += (uint64_t)s * mat[i * B_ROW + t];
    acc[1] += (uint64_t)s * mat[i * B_ROW + 32 + t];
  }
}

// out = x * y * M_A^-1 (mod p); out < 3p when x * y < 2^10 p^2 (rns.py).
// `sig` is the warp's 64-word scratch row.  Every lane of the warp calls it.
__device__ __noinline__ void mont(const Consts& K, uint32_t* sig,
                                  const Elem& x, const Elem& y, Elem& out) {
  uint32_t sb[2], part = 0;
  // q = s * (-p^-1) on base A, its sigmas into the scratch row
#pragma unroll
  for (int q = 0; q < 2; q++) {
    int c = col_a(q);
    uint32_t s = mulmod(K, x.a[q], y.a[q], c);
    uint32_t qa = mulmod(K, s, rowv(K, NEGPINV, c), c);
    uint32_t sg = mulmod(K, qa, rowv(K, SIG, c), c);
    sig[c] = sg;
    part += sg * rowv(K, W, c);
    sb[q] = mulmod(K, x.b[q], y.b[q], col_b(q));
  }
  // q-extension A -> B, alpha without offset: never an overestimate
  uint32_t alpha = __reduce_add_sync(FULL, part) >> W_BITS;
  __syncwarp();
  uint64_t acc[2];
  ext_dot(sig, K.ext_ab, K.k, acc);
  __syncwarp();
  part = 0;
#pragma unroll
  for (int q = 0; q < 2; q++) {
    int c = col_b(q);
    uint32_t qb = ext_finish(K, acc[q], alpha, CORR_AB, c);
    uint32_t qp = mulmod(K, qb, rowv(K, PB, c), c);
    uint32_t tb = mulmod(K, mod_c(K, sb[q] + qp, c), rowv(K, MAINV, c), c);
    out.b[q] = tb;
    uint32_t sg = mulmod(K, tb, rowv(K, SIG, c), c);
    sig[q * 32 + lane_id()] = sg;
    part += sg * rowv(K, W, c);
  }
  // t-extension B -> A, alpha with offset: exact (t < 3p << M_B)
  alpha = (__reduce_add_sync(FULL, part) + ALPHA_OFF) >> W_BITS;
  __syncwarp();
  ext_dot(sig, K.ext_ba, K.k, acc);
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 2; q++)
    out.a[q] = ext_finish(K, acc[q], alpha, CORR_BA, col_a(q));
}

__device__ __forceinline__ void load_elem(const int* __restrict__ src,
                                          Elem& e) {
  const int t = lane_id();
  e.a[0] = (uint32_t)src[t];
  e.a[1] = (uint32_t)src[32 + t];
  e.b[0] = (uint32_t)src[B_ROW + t];
  e.b[1] = (uint32_t)src[B_ROW + 32 + t];
}

__device__ __forceinline__ void store_elem(int* __restrict__ dst,
                                           const Elem& e) {
  const int t = lane_id();
  dst[t] = (int)e.a[0];
  dst[32 + t] = (int)e.a[1];
  dst[B_ROW + t] = (int)e.b[0];
  dst[B_ROW + 32 + t] = (int)e.b[1];
}

// a constant row of 128 words (shared memory) as an element
__device__ __forceinline__ void row_elem(const uint32_t* row, Elem& e) {
  const int t = lane_id();
  e.a[0] = row[t];
  e.a[1] = row[32 + t];
  e.b[0] = row[B_ROW + t];
  e.b[1] = row[B_ROW + 32 + t];
}

__device__ __forceinline__ void add(const Consts& K, const Elem& x,
                                    const Elem& y, Elem& out) {
#pragma unroll
  for (int q = 0; q < 2; q++) {
    out.a[q] = mod_c(K, x.a[q] + y.a[q], col_a(q));
    out.b[q] = mod_c(K, x.b[q] + y.b[q], col_b(q));
  }
}

// x + (off - y), off the residues of c p >= value(y): the value stays
// non-negative, and grows by c p
__device__ __forceinline__ void sub_off(const Consts& K, const Elem& x,
                                        const Elem& off, const Elem& y,
                                        Elem& out) {
#pragma unroll
  for (int q = 0; q < 2; q++) {
    int ca = col_a(q), cb = col_b(q);
    uint32_t ta = mod_c(K, off.a[q] + rowv(K, M, ca) - y.a[q], ca);
    uint32_t tb = mod_c(K, off.b[q] + rowv(K, M, cb) - y.b[q], cb);
    out.a[q] = mod_c(K, x.a[q] + ta, ca);
    out.b[q] = mod_c(K, x.b[q] + tb, cb);
  }
}

// positional digits (nd 16-bit digits in the warp's scratch `dig`) ->
// residues: sum_j d_j |2^16j|_m with the table p2 [nd][128]
__device__ __forceinline__ void to_rns(const Consts& K, const uint32_t* dig,
                                       const uint32_t* p2, int nd, Elem& e) {
  uint64_t acc[4] = {0, 0, 0, 0};
  const int t = lane_id();
  for (int j = 0; j < nd; j++) {
    uint64_t d = dig[j];
    const uint32_t* r = p2 + j * LANES;
    acc[0] += d * r[t];
    acc[1] += d * r[32 + t];
    acc[2] += d * r[B_ROW + t];
    acc[3] += d * r[B_ROW + 32 + t];
  }
  e.a[0] = mod_c64(K, acc[0], col_a(0));
  e.a[1] = mod_c64(K, acc[1], col_a(1));
  e.b[0] = mod_c64(K, acc[2], col_b(0));
  e.b[1] = mod_c64(K, acc[3], col_b(1));
}

// residues of a value below 4p -> its canonical digits mod p (nd of them)
// in the warp's scratch `dig`.  CRT from base A: digit columns
// sum_i sigma_i D[i][j] - alpha MD[j] (d [k][64]: digits of M_A/m_i; md:
// digits of M_A; wdt columns), exact alpha (offset), then lane 0 resolves
// the carries and subtracts p (pd: its digits) while the value is >= p.
// `col` is the warp's 64-entry 64-bit scratch row.
__device__ __noinline__ void from_rns(const Consts& K, uint32_t* sig,
                                      long long* col, uint32_t* dig,
                                      const Elem& v, const uint32_t* d,
                                      const uint32_t* md,
                                      const uint32_t* pd, int wdt, int nd) {
  const int t = lane_id();
  uint32_t part = 0;
#pragma unroll
  for (int q = 0; q < 2; q++) {
    int c = col_a(q);
    uint32_t sg = mulmod(K, v.a[q], rowv(K, SIG, c), c);
    sig[c] = sg;
    part += sg * rowv(K, W, c);
  }
  uint32_t alpha = (__reduce_add_sync(FULL, part) + ALPHA_OFF) >> W_BITS;
  __syncwarp();
  uint64_t acc[2];
  ext_dot(sig, d, K.k, acc);
#pragma unroll
  for (int q = 0; q < 2; q++) {
    int j = q * 32 + t;
    if (j < wdt) col[j] = (long long)acc[q] - (long long)alpha * md[j];
  }
  __syncwarp();
  if (t == 0) {
    long long carry = 0;
    for (int j = 0; j < wdt; j++) {   // the value: < 4p, so < 2^(16(nd+1))
      long long s = col[j] + carry;
      carry = s >> 16;                // arithmetic: a column may be negative
      if (j <= nd) dig[j] = (uint32_t)(s & 0xFFFF);
    }
    for (int round = 0; round < 3; round++) {
      // value >= p?  compare from the top digit (digit nd of p is 0)
      int ge = 1;
      for (int j = nd; j >= 0; j--) {
        uint32_t pj = j < nd ? pd[j] : 0;
        if (dig[j] != pj) {
          ge = dig[j] > pj;
          break;
        }
      }
      if (!ge) break;
      int borrow = 0;
      for (int j = 0; j <= nd; j++) {
        int s = (int)dig[j] - (int)(j < nd ? pd[j] : 0) - borrow;
        borrow = s < 0;
        dig[j] = (uint32_t)(s + (borrow << 16));
      }
    }
  }
  __syncwarp();
}

}  // namespace rns

// Double-base RNS Montgomery arithmetic on tiles of 16 elements, the inner
// products on the integer tensor cores.  Shared by the RNS multiply
// (rns_mont.cu, K7) and the RNS batched affine addition (ec_rns.cu, K8).
// The scheme, its bounds and the alpha estimates are those of
// gingerlib_tpu_torch/ops/rns.py (and of the JAX package's ops/rns.py); the
// functions here compute the same residues.
//
// Packed layout: an element is a row of 128 32-bit words, base-A channel i
// in word i, base-B channel j in word 64 + j (k <= 64 channels a base),
// every other word zero.
//
// A block of 128 threads (4 warps) owns a tile of 16 elements, the M of
// mma.m16n8k32.  Thread (warp w, group g = lane / 4, t = lane % 4) holds
// rows g and g + 8 of the tile and, in each base, the four channels
// 16 w + 8 h + 2 t + b (h, b in {0, 1}): exactly the entries of the
// accumulator fragments of the n-tiles 2 w and 2 w + 1 (struct Elem).  So
// the channelwise steps run one thread an (element, channel word) set, on
// what the tensor cores leave in that thread, and an element's words move
// to and from memory as 8-byte pairs, 32 bytes of a row a quad.
//
// Inner products.  Every base extension and conversion is a product of a
// [16, K] operand (sigmas or digits of the tile's rows, K <= 64) with a
// constant [K, N] matrix.  Both hold values below 2^16, so each is split
// into bytes, x = 2^8 x_hi + x_lo, and the product is four u8 x u8 -> s32
// products, recombined as 2^16 hh + 2^8 (hl + lh) + ll in 64 bits.  A
// partial sum has at most 64 terms of at most 255 * 255, so it stays below
// 64 * 65025 < 2^22 (the merged hl + lh below 2^23): exact in s32.  The
// recombined sum is below 64 * 2^30 = 2^36, reduced by red64.
//   A operand: two byte planes [16][PLANE_STRIDE] in shared memory, written
//     by the threads that computed the values (stride 80 bytes: fragment
//     loads hit 32 distinct banks).
//   B operand: in the constant block, pre-split by the host into fragment
//     order, [K/32][N/8][plane][lane][2 words] (ops/rns_kernels.py,
//     mma_fragments), so a lane loads its fragment as one 8-byte word.
// The TPU ran the same products as bf16 matrix products over 7-bit splits
// (pallas_rns.py _base_extend_k:113, _to_rns_k:289, _from_rns_k:315).
//
// Channel reduction: for any 32-bit v, q = umulhi(v, mu) (mu = floor(2^32 /
// m)) is floor(v/m) or one less, so one conditional subtract gives v mod m;
// a value that only feeds a product or another reduction skips it (redl).
// Words outside the channels hold m = 1, mu = 2^32 - 1 and zeros, so every
// step leaves them 0 without a test.  alpha is the row sum of sigma * w
// (< 2^31, rns.py MAX_K): a quad shuffle, then the four warps' partial sums
// through shared memory.
//
// Phases: each product writes its A planes and alpha parts, waits at one
// barrier and reads them.  Consecutive products alternate between two
// buffers (Core::buf, the same in every thread), so the barrier of the next
// product also orders the reads of this one before the writes of the one
// after: one barrier a product.  Every thread of the block calls every
// function below, in the same order.
//
// Constant block (words): rows [N_ROWS][128] -- moduli, mu, Kawamura sigma
// factors, alpha weights w, -p^-1 sigma (A words), p, M_A^-1 and M_A^-1
// sigma (B words), -|M_A|_{m'} (B words), -|M_B|_m (A words), 2^32 mod m --
// then the two extension matrices |M_A/m_i|_{m'_j} and |M_B/m'_j|_{m_i} as
// fragments of [64, 64] each (zero beyond k).  The folded products save a
// reduction where the multiply needs only the sigma of q or of t, and the
// negated corrections let an extension end in one 64-bit reduction.
#pragma once

#include <stdint.h>

namespace rns {

constexpr int LANES = 128;            // words of a packed element
constexpr int B_ROW = 64;             // first word of base B
constexpr int W_BITS = 25;
constexpr uint32_t ALPHA_OFF = 1u << 20;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int TILE = 16;              // elements a tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KMAX = 64;              // the K of every product, padded
constexpr int STAGE_WORDS = LANES + 8;   // a staged row: conflict-free pairs
constexpr int PLANE_STRIDE = KMAX + 16;  // bytes between rows of a plane

enum Row { M, MU, SIG, W, QSIG, PB, MAINV, TSIG, NCORR_AB, NCORR_BA, P32,
           N_ROWS };

// words of a [k, n] B operand in fragment order
__host__ __device__ constexpr int frag_words(int k, int n) {
  return k / 32 * (n / 8) * 2 * 64;
}
constexpr int EXT_WORDS = frag_words(KMAX, B_ROW);
constexpr int CONST_WORDS = N_ROWS * LANES + 2 * EXT_WORDS;
// shared workspace of the core: planes [2 buffers][2 planes][TILE][stride]
// bytes, then alpha parts [2 buffers][WARPS][TILE] words
constexpr int PLANES_WORDS = 2 * 2 * TILE * PLANE_STRIDE / 4;
constexpr int WORK_WORDS = PLANES_WORDS + 2 * WARPS * TILE;

struct Core {                // shared-memory addresses (32-bit) and roles
  uint32_t row;              // [N_ROWS][LANES] words
  uint32_t ext_ab, ext_ba;   // fragments
  uint32_t planes;           // [2 buffers][2 planes][TILE][PLANE_STRIDE]
  uint32_t apart;            // [2 buffers][WARPS][TILE] words
  int ks;                    // k-steps of an extension: ceil(k / 32)
  int buf;                   // the buffer of the next product
  int w, g, t, lane;         // warp, row group, thread in group, lane
};

struct Elem {               // rows g and g + 8, slots q = 2 h + b
  uint32_t a[2][4];
  uint32_t b[2][4];
};

struct AFrag {              // A fragments of both planes, two k-steps
  uint32_t lo[2][4];
  uint32_t hi[2][4];
};

// ---------------------------------------------------------------------------
// PTX: shared memory by address, the tensor-core product, asynchronous copy
// ---------------------------------------------------------------------------
// Shared memory is addressed by 32-bit shared-window addresses through
// ld/st.shared, so that no access goes through a generic pointer (which a
// function that is not inlined could not tell from local memory).

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t lds(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ uint2 lds2(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void sts(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ void sts16(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(a), "h"((uint16_t)v)
               : "memory");
}

// d += a * b, a 16 x 32 u8 (row), b 32 x 8 u8 (col), d 16 x 8 s32
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// 16 bytes global -> shared; zeros where `ok` is false (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Asks for `words` words (a multiple of 4, 16-byte aligned at both ends)
// to be copied into shared memory by the whole block, all in flight at
// once; the caller commits and waits.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src,
                                      int words) {
  for (int i = 4 * threadIdx.x; i < words; i += 4 * blockDim.x)
    cp_async16(dst + i, src + i, true);
}

__device__ __forceinline__ Core core_at(const uint32_t* consts_sm,
                                        uint32_t* work, int k) {
  Core C;
  C.row = smem(consts_sm);
  C.ext_ab = C.row + 4 * N_ROWS * LANES;
  C.ext_ba = C.ext_ab + 4 * EXT_WORDS;
  C.planes = smem(work);
  C.apart = C.planes + 4 * PLANES_WORDS;
  C.ks = (k + 31) / 32;
  C.buf = 0;
  C.w = threadIdx.x >> 5;
  C.lane = threadIdx.x & 31;
  C.g = C.lane >> 2;
  C.t = C.lane & 3;
  return C;
}

// the channel word (0..63 of a base) of slot q of this thread
__device__ __forceinline__ int chan(const Core& C, int q) {
  return 16 * C.w + 8 * (q >> 1) + 2 * C.t + (q & 1);
}

__device__ __forceinline__ uint32_t rowv(const Core& C, int r, int c) {
  return lds(C.row + 4 * (r * LANES + c));
}

// ---------------------------------------------------------------------------
// channel arithmetic, on constants held in registers
// ---------------------------------------------------------------------------

struct Mod {                 // a channel's modulus, floor(2^32 / m), 2^32 mod m
  uint32_t m, mu, p32;
};

__device__ __forceinline__ Mod mod_at(const Core& C, int c) {
  return Mod{rowv(C, M, c), rowv(C, MU, c), rowv(C, P32, c)};
}

// v mod m up to one m, in [0, 2m), for any 32-bit v: enough for a value
// that only feeds a product (below 2m times below m: < 2^29) or another
// reduction
__device__ __forceinline__ uint32_t redl(uint32_t v, const Mod& m) {
  return v - __umulhi(v, m.mu) * m.m;
}

// v mod m for any 32-bit v
__device__ __forceinline__ uint32_t red(uint32_t v, const Mod& m) {
  const uint32_t r = redl(v, m);
  return r >= m.m ? r - m.m : r;
}

// v mod m up to one m, for v < 2^46 (here always below 2^37)
__device__ __forceinline__ uint32_t red64l(uint64_t v, const Mod& m) {
  return redl(redl((uint32_t)v, m) + (uint32_t)(v >> 32) * m.p32, m);
}

__device__ __forceinline__ uint32_t red64(uint64_t v, const Mod& m) {
  const uint32_t r = red64l(v, m);
  return r >= m.m ? r - m.m : r;
}

__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b,
                                           const Mod& m) {
  return red(a * b, m);               // below 2m times below m: < 2^29
}

// The extension's sum before its reduction: acc - alpha |M_src| as acc +
// alpha ncorr, ncorr = -|M_src| mod m (acc < 2^36, alpha < 2^7: the sum
// is below 2^37); red64 of it is the destination residue.
__device__ __forceinline__ uint64_t ext_sum(uint64_t acc, uint32_t alpha,
                                            uint32_t ncorr) {
  return acc + (uint64_t)(alpha * ncorr);
}

// ---------------------------------------------------------------------------
// products on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t plane(const Core& C, int buf, int pl) {
  return C.planes + (buf * 2 + pl) * TILE * PLANE_STRIDE;
}

// the thread's values v[row][slot] (< 2^16) into the byte planes of the
// current buffer, at their channel columns
__device__ __forceinline__ void put_planes(const Core& C,
                                           const uint32_t (&v)[2][4]) {
  const uint32_t lo = plane(C, C.buf, 0), hi = plane(C, C.buf, 1);
#pragma unroll
  for (int r = 0; r < 2; r++)
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const uint32_t o = (C.g + 8 * r) * PLANE_STRIDE + chan(C, 2 * h);
      const uint32_t v0 = v[r][2 * h], v1 = v[r][2 * h + 1];
      sts16(lo + o, (v0 & 0xFF) | (v1 & 0xFF) << 8);
      sts16(hi + o, (v0 >> 8) | (v1 >> 8) << 8);
    }
}

// the A fragments of the current buffer's planes, ks k-steps
__device__ __forceinline__ void load_a(const Core& C, int ks, AFrag& A) {
  const uint32_t lo = plane(C, C.buf, 0), hi = plane(C, C.buf, 1);
#pragma unroll
  for (int s = 0; s < 2; s++) {
    if (s < ks) {
      const uint32_t o0 = C.g * PLANE_STRIDE + 32 * s + 4 * C.t,
                     o1 = o0 + 8 * PLANE_STRIDE;
      A.lo[s][0] = lds(lo + o0);
      A.lo[s][1] = lds(lo + o1);
      A.lo[s][2] = lds(lo + o0 + 16);
      A.lo[s][3] = lds(lo + o1 + 16);
      A.hi[s][0] = lds(hi + o0);
      A.hi[s][1] = lds(hi + o1);
      A.hi[s][2] = lds(hi + o0 + 16);
      A.hi[s][3] = lds(hi + o1 + 16);
    }
  }
}

// n-tile j of the product of A with the fragment-ordered B at shared
// address `frag` (ntiles n-tiles in all): out[i] at row g + 8 (i / 2),
// column 8 j + 2 t + i % 2
__device__ __forceinline__ void product(const Core& C, const AFrag& A,
                                        uint32_t frag, int ntiles, int j,
                                        int ks, uint64_t (&out)[4]) {
  int ll[4] = {0, 0, 0, 0}, mid[4] = {0, 0, 0, 0}, hh[4] = {0, 0, 0, 0};
#pragma unroll
  for (int s = 0; s < 2; s++) {
    if (s < ks) {
      const uint32_t f = frag + 8 * ((s * ntiles + j) * 64 + C.lane);
      const uint2 bl = lds2(f), bh = lds2(f + 8 * 32);
      mma_u8(ll, A.lo[s], bl);
      mma_u8(mid, A.lo[s], bh);
      mma_u8(mid, A.hi[s], bl);
      mma_u8(hh, A.hi[s], bh);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; i++)
    out[i] = ((uint64_t)(uint32_t)hh[i] << 16) +
             ((uint64_t)(uint32_t)mid[i] << 8) + (uint32_t)ll[i];
}

// the warp's partial alpha sums of its rows (one a row, summed over the
// quad) into the current buffer
__device__ __forceinline__ void put_alpha(const Core& C, uint32_t (&part)[2]) {
#pragma unroll
  for (int r = 0; r < 2; r++) {
    part[r] += __shfl_xor_sync(FULL, part[r], 1);
    part[r] += __shfl_xor_sync(FULL, part[r], 2);
  }
  if (C.t == 0) {
    const uint32_t a = C.apart + 4 * ((C.buf * WARPS + C.w) * TILE + C.g);
    sts(a, part[0]);
    sts(a + 4 * 8, part[1]);
  }
}

__device__ __forceinline__ void get_alpha(const Core& C, uint32_t off,
                                          uint32_t (&al)[2]) {
#pragma unroll
  for (int r = 0; r < 2; r++) {
    uint32_t s = off;
#pragma unroll
    for (int w = 0; w < WARPS; w++)
      s += lds(C.apart + 4 * ((C.buf * WARPS + w) * TILE + C.g + 8 * r));
    al[r] = s >> W_BITS;
  }
}

// One extension: the sigmas sg (and their alpha parts) in, then for each
// of the thread's slots fin(q, sum of row g, sum of row g + 8, alpha of
// row g, alpha of row g + 8) with the inner products of the rows' sigmas
// with column chan(q) of the matrix `frag` (64 x 64).
template <class Fin>
__device__ __forceinline__ void extend(Core& C, const uint32_t (&sg)[2][4],
                                       uint32_t (&part)[2], uint32_t off,
                                       uint32_t frag, Fin&& fin) {
  put_planes(C, sg);
  put_alpha(C, part);
  __syncthreads();
  uint32_t al[2];
  get_alpha(C, off, al);
  AFrag A;
  load_a(C, C.ks, A);
#pragma unroll
  for (int h = 0; h < 2; h++) {
    uint64_t o[4];
    product(C, A, frag, B_ROW / 8, 2 * C.w + h, C.ks, o);
    fin(2 * h, o[0], o[2], al[0], al[1]);
    fin(2 * h + 1, o[1], o[3], al[0], al[1]);
  }
  C.buf ^= 1;
}

// out = x * y * M_A^-1 (mod p) for the tile's rows; out < 3p when x * y <
// 2^10 p^2 (rns.py).  Uses both buffers, leaves C.buf as it found it.
__device__ __forceinline__ void mont_inline(Core C, const Elem& x,
                                            const Elem& y, Elem& out) {
  uint32_t sb[2][4], sg[2][4], part[2] = {0, 0};
  // s = x y on both bases; the sigmas of q = s (-p^-1) on base A
#pragma unroll
  for (int q = 0; q < 4; q++) {
    const int ca = chan(C, q), cb = B_ROW + ca;
    const Mod ma = mod_at(C, ca), mb = mod_at(C, cb);
    const uint32_t qsig = rowv(C, QSIG, ca), w = rowv(C, W, ca);
#pragma unroll
    for (int r = 0; r < 2; r++) {
      sg[r][q] = mulmod(redl(x.a[r][q] * y.a[r][q], ma), qsig, ma);
      part[r] += sg[r][q] * w;
      sb[r][q] = redl(x.b[r][q] * y.b[r][q], mb);      // up to one m
    }
  }
  // q-extension A -> B, alpha without offset: never an overestimate; then
  // t = (s + q p) M_A^-1 on base B and its sigmas
  uint32_t tg[2][4], tpart[2] = {0, 0}, tb[2][4];
  extend(C, sg, part, 0, C.ext_ab,
         [&](int q, uint64_t acc0, uint64_t acc1, uint32_t al0,
             uint32_t al1) {
           const int cb = B_ROW + chan(C, q);
           const Mod mb = mod_at(C, cb);
           const uint32_t ncorr = rowv(C, NCORR_AB, cb), pb = rowv(C, PB, cb),
                          mainv = rowv(C, MAINV, cb),
                          tsig = rowv(C, TSIG, cb), w = rowv(C, W, cb);
#pragma unroll
           for (int r = 0; r < 2; r++) {
             const uint32_t qb =
                 red64l(ext_sum(r ? acc1 : acc0, r ? al1 : al0, ncorr), mb);
             const uint32_t u = redl(sb[r][q] + qb * pb, mb);  // < 2^30 in
             tb[r][q] = mulmod(u, mainv, mb);
             tg[r][q] = mulmod(u, tsig, mb);
             tpart[r] += tg[r][q] * w;
           }
         });
  // t-extension B -> A, alpha with offset: exact (t < 3p << M_B)
  uint32_t ta[2][4];
  extend(C, tg, tpart, ALPHA_OFF, C.ext_ba,
         [&](int q, uint64_t acc0, uint64_t acc1, uint32_t al0,
             uint32_t al1) {
           const int ca = chan(C, q);
           const Mod ma = mod_at(C, ca);
           const uint32_t ncorr = rowv(C, NCORR_BA, ca);
           ta[0][q] = red64(ext_sum(acc0, al0, ncorr), ma);
           ta[1][q] = red64(ext_sum(acc1, al1, ncorr), ma);
         });
#pragma unroll
  for (int r = 0; r < 2; r++)
#pragma unroll
    for (int q = 0; q < 4; q++) {
      out.a[r][q] = ta[r][q];
      out.b[r][q] = tb[r][q];
    }
}

// The same as one function that is not inlined, for kernels that call it
// from several places (ec_rns.cu).
__device__ __noinline__ void mont(Core C, const Elem& x, const Elem& y,
                                  Elem& out) {
  mont_inline(C, x, y, out);
}

// ---------------------------------------------------------------------------
// elements in and out, channelwise helpers
// ---------------------------------------------------------------------------

// the thread's words of a staged tile at shared address `tile` (rows
// STAGE_WORDS words apart)
__device__ __forceinline__ void load_staged(const Core& C, uint32_t tile,
                                            Elem& e) {
#pragma unroll
  for (int r = 0; r < 2; r++)
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const uint32_t p =
          tile + 4 * ((C.g + 8 * r) * STAGE_WORDS + chan(C, 2 * h));
      const uint2 va = lds2(p), vb = lds2(p + 4 * B_ROW);
      e.a[r][2 * h] = va.x;
      e.a[r][2 * h + 1] = va.y;
      e.b[r][2 * h] = vb.x;
      e.b[r][2 * h + 1] = vb.y;
    }
}

// Rows base .. base + 15 of a dense [n, 128] array: the thread's words,
// straight from global memory (a quad reads 32 contiguous bytes of a row);
// rows at or beyond n read as zeros.
__device__ __forceinline__ void load_rows(const Core& C,
                                          const int* __restrict__ src,
                                          int base, int n, Elem& e) {
#pragma unroll
  for (int r = 0; r < 2; r++) {
    const int row = base + C.g + 8 * r;
#pragma unroll
    for (int h = 0; h < 2; h++) {
      uint2 va = make_uint2(0, 0), vb = make_uint2(0, 0);
      if (row < n) {
        const int* p = src + (size_t)row * LANES + chan(C, 2 * h);
        va = *reinterpret_cast<const uint2*>(p);
        vb = *reinterpret_cast<const uint2*>(p + B_ROW);
      }
      e.a[r][2 * h] = va.x;
      e.a[r][2 * h + 1] = va.y;
      e.b[r][2 * h] = vb.x;
      e.b[r][2 * h + 1] = vb.y;
    }
  }
}

// the tile's rows below n into a dense [n, 128] array, as 8-byte pairs
__device__ __forceinline__ void store_rows(const Core& C,
                                           int* __restrict__ dst, int base,
                                           int n, const Elem& e) {
#pragma unroll
  for (int r = 0; r < 2; r++) {
    const int row = base + C.g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; h++) {
      int* p = dst + (size_t)row * LANES + chan(C, 2 * h);
      *reinterpret_cast<uint2*>(p) =
          make_uint2(e.a[r][2 * h], e.a[r][2 * h + 1]);
      *reinterpret_cast<uint2*>(p + B_ROW) =
          make_uint2(e.b[r][2 * h], e.b[r][2 * h + 1]);
    }
  }
}

// a constant row of 128 words at shared address `row` as an element
__device__ __forceinline__ void row_elem(const Core& C, uint32_t row,
                                         Elem& e) {
#pragma unroll
  for (int q = 0; q < 4; q++) {
    const uint32_t a = lds(row + 4 * chan(C, q)),
                   b = lds(row + 4 * (B_ROW + chan(C, q)));
#pragma unroll
    for (int r = 0; r < 2; r++) {
      e.a[r][q] = a;
      e.b[r][q] = b;
    }
  }
}

__device__ __forceinline__ void add(const Core& C, const Elem& x,
                                    const Elem& y, Elem& out) {
#pragma unroll
  for (int q = 0; q < 4; q++) {
    const Mod ma = mod_at(C, chan(C, q)), mb = mod_at(C, B_ROW + chan(C, q));
#pragma unroll
    for (int r = 0; r < 2; r++) {
      out.a[r][q] = red(x.a[r][q] + y.a[r][q], ma);
      out.b[r][q] = red(x.b[r][q] + y.b[r][q], mb);
    }
  }
}

// x + (off - y), off the residues of c p >= value(y): the value stays
// non-negative, and grows by c p
__device__ __forceinline__ void sub_off(const Core& C, const Elem& x,
                                        const Elem& off, const Elem& y,
                                        Elem& out) {
#pragma unroll
  for (int q = 0; q < 4; q++) {
    const Mod ma = mod_at(C, chan(C, q)), mb = mod_at(C, B_ROW + chan(C, q));
#pragma unroll
    for (int r = 0; r < 2; r++) {
      const uint32_t ta = red(off.a[r][q] + ma.m - y.a[r][q], ma);
      const uint32_t tb = red(off.b[r][q] + mb.m - y.b[r][q], mb);
      out.a[r][q] = red(x.a[r][q] + ta, ma);
      out.b[r][q] = red(x.b[r][q] + tb, mb);
    }
  }
}

// per row: keep a where take[r] is false, b where it is true
__device__ __forceinline__ void select(const bool (&take)[2], const Elem& a,
                                       const Elem& b, Elem& out) {
#pragma unroll
  for (int r = 0; r < 2; r++)
#pragma unroll
    for (int q = 0; q < 4; q++) {
      out.a[r][q] = take[r] ? b.a[r][q] : a.a[r][q];
      out.b[r][q] = take[r] ? b.b[r][q] : a.b[r][q];
    }
}

}  // namespace rns

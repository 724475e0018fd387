// K9: the Poseidon permutation with the x^-1 S-box over a state of T = 3
// field elements (Montgomery form in and out, canonical), for a batch of
// independent sponges, the whole permutation in one launch:
//
//   R_F full rounds | R_P partial rounds | R_F - 1 full rounds | one last
//   full round without the MDS mix,
//
// each round: add the round's constants to all three elements; S-box x^-1
// (0 -> 0) on all three (full) or on the first (partial); new_i =
// sum_j MDS[i][j] * s_j.  This is the schedule of PoseidonHash.permute in
// gingerlib_tpu/primitives/poseidon.py (the code's, not doc/Poseidon.md's).
//
// Replaces _round_kernel (full, partial, last), _entry_kernel and
// _exit_kernel behind permute_fused of gingerlib_tpu/ops/pallas_poseidon.py.
// That kernel is the TPU's mapping: one launch a round, the state in a
// double-base RNS so that multiplies run on the matrix unit, a zero test
// against {0, p, ..., 9p}, and one inversion shared by the 128 lanes of a
// tile through a halving product tree.  Its sharing carries over, the rest
// does not:
//
// * A group of G threads owns a sponge (fp_group.cuh; G = 8 at 48 digits,
//   4 at 24 and 16, as in the projective addition): each thread holds
//   L / G limbs of the three elements in registers for all rounds, and
//   every multiply is the group's (grp_mont_mul), its dependent chain
//   about G times shorter than one thread's.  The mix takes three products
//   and one reduction a row (grp_mont_sum3): 3 reductions a round, not 9
//   (2^15: 17.45 ms, 21.67 with three multiplies and two additions a row).
// * A block holds S sponges and shares ONE inversion a round among them:
//   the round's S-box inputs (3 S in a full round, S in a partial one;
//   zeros enter as one and leave as zero) go into a product tree in
//   shared memory, level by level (pairs multiplied, an odd last element
//   passed up), each level's nodes spread over the block's groups; group
//   0 inverts the root (gl::inv_divsteps_grp of fp_inv.cuh, the divsteps
//   inverse over the group) and multiplies it by R^3 to return to
//   Montgomery form, as fp.inv_mod does; the down-sweep gives each node its
//   inverse, its parent's times its sibling's product, one node a group
//   (the products and the inverses in two arrays, so a level needs one
//   barrier).  The round constants, the MDS matrix, p, 1 and R^3 sit in
//   shared memory (read from global memory through L1 instead, they timed
//   within 4%).
// * S comes from the batch, in the launcher (block_sponges): the largest
//   power of two up to 64 whose blocks still give every SM one
//   (kMinBlocksPerSM), 1 where even S = 2 would not (below 2^9 sponges on
//   132 SMs).  Timed side by side by tools/poseidon_variants.py on an H100
//   80GB HBM3 at 700 W (PERF.md): a rule of 4 blocks an SM took 5.88 ms
//   at 2^10 sponges, 17.69 at 2^13 and 27.51 at 2^15 against 5.00, 6.94
//   and 17.45; S at most 32 took 13.82 ms at 2^14 and 27.67 at 2^15
//   against 8.74 and 17.45: the inversions a block shares pay more than
//   the blocks left to hide the latency.  At S = 1 a sponge takes three
//   groups, one a row of the mix (3.64 ms at one sponge, 3.85 with one
//   group); at S = 64 the kernel is compiled for 64 registers a thread, so
//   that two blocks of 512 threads fit an SM (2^15: 17.45 ms, 24.70
//   without; ~100 bytes of spills at 48 digits), and below it not (64
//   registers at every S: 7.26 ms at 2^13 against 6.94, 3.97 at one sponge
//   against 3.64).
//
// An inverse is unique and every step returns the canonical residue, so
// the digits are those of the array path (one inversion shared across the
// whole batch), whatever S.
//
// What bounds it on an H100: at narrow batches (the Merkle tree's upper
// levels, 1 to 2^8 sponges) the latency of the rounds, of which the
// inversion (33-49 passes, each 31 divsteps in every thread of the group
// and ~16 rounds of shuffles and ballots) is nearly nine tenths; the group
// form shortens its chains (~49 us an inversion against ~85 us in one
// thread).
// At wide batches a block's round is its serial tree (one or two multiplies
// a level, a barrier each) and its one inverting group, with 2 blocks an
// SM to overlap them, and the multiplies' integer work, 2 L^2 + L
// multiply-adds each; the inversions are one a block a round, 1/S of a
// sponge's.  chip_smoke.py and tools/kernel_ab.py time it beside its
// bound; PERF.md has the numbers.
#include <cuda_runtime.h>

#include "fp_group.cuh"

namespace {

constexpr int T = 3;
// constants in shared memory, L limbs each: p, one, R^3, then the MDS
// matrix row-major, then the round constants round by round
constexpr int kHead = 3 + T * T;
constexpr int kMaxSponges = 64;     // S at most: 192 leaves, 384 tree nodes
constexpr int kMinBlocksPerSM = 1;
constexpr int kWideSponges = 64;    // from this S on, 64 registers
constexpr int kWideBlocks = 128 / kMaxSponges;  // blocks of 8 S threads

template <int ND>
constexpr int group_size() { return ND == 48 ? 8 : 4; }

// Nodes of a tree over n leaves: n + ceil(n/2) + ... + 1.
__host__ __device__ __forceinline__ int tree_nodes(int n) {
  int t = n;
  while (n > 1) {
    n = (n + 1) >> 1;
    t += n;
  }
  return t;
}

// The n leaves' inverses: X[0 .. n) holds the leaves (values of L limbs,
// non-zero), Y[0 .. n) gets their inverses.  Called by every thread of the
// block: `q` is the thread's group of the block's nq.  Level l + 1 follows
// level l in X (products) and in Y (inverses); each level's nodes are
// spread over the groups, one node a group at a time; group 0 inverts the
// root.
template <int L, int G>
__device__ __forceinline__ void tree_inverse(
    const gl::Grp<L, G>& g, uint32_t* X, uint32_t* Y, int n, int nq, int q,
    const uint32_t (&P)[gl::Grp<L, G>::M],
    const uint32_t (&R3)[gl::Grp<L, G>::M], uint32_t inv) {
  constexpr int M = gl::Grp<L, G>::M;
  int off = 0, cnt = n;
#pragma unroll 1
  while (cnt > 1) {                 // up: products of pairs
    const int up = (cnt + 1) >> 1;
#pragma unroll 1
    for (int e = q; e < up; e += nq) {
      uint32_t a[M], b[M];
      gl::grp_ld_sh<L, G>(g, X, off + 2 * e, a);
      if (2 * e + 1 < cnt) {
        gl::grp_ld_sh<L, G>(g, X, off + 2 * e + 1, b);
        gl::grp_mont_mul<L, G>(g, a, b, P, inv, a);
      }
      gl::grp_st_sh<L, G>(g, X, off + cnt + e, a);
    }
    off += cnt;
    cnt = up;
    __syncthreads();
  }
  if (q == 0) {                     // the root: plain (a R)^-1, then R^3
    uint32_t a[M];
    gl::grp_ld_sh<L, G>(g, X, off, a);
    gl::grp_inv<L, G>(g, a, P, inv, a);
    gl::grp_mont_mul<L, G>(g, a, R3, P, inv, a);
    gl::grp_st_sh<L, G>(g, Y, off, a);
  }
  __syncthreads();
#pragma unroll 1
  while (off > 0) {                 // down: parent's inverse x sibling
    int coff = 0, ccnt = n;         // the level below the one at off
    while (coff + ccnt < off) {
      coff += ccnt;
      ccnt = (ccnt + 1) >> 1;
    }
#pragma unroll 1
    for (int e = q; e < ccnt; e += nq) {
      uint32_t a[M], b[M];
      gl::grp_ld_sh<L, G>(g, Y, off + (e >> 1), a);
      if ((e ^ 1) < ccnt) {
        gl::grp_ld_sh<L, G>(g, X, coff + (e ^ 1), b);
        gl::grp_mont_mul<L, G>(g, a, b, P, inv, a);
      }
      gl::grp_st_sh<L, G>(g, Y, coff + e, a);
    }
    off = coff;
    __syncthreads();
  }
}

// H groups a sponge: 1, or T at S = 1, where each group then computes one
// row of the mix (a round's latency there is the inversion and the mix's
// chain of multiplies).  BLOCKS: the blocks an SM the registers must leave
// room for (1: as many registers as the kernel wants).
template <int ND, int G, int H, int BLOCKS>
__global__ void __launch_bounds__(kMaxSponges * 8, BLOCKS)
poseidon_kernel(const long long* __restrict__ in, long long* __restrict__ out,
                int n, const uint32_t* __restrict__ consts, int words,
                int r_f, int r_p, uint32_t inv, int S) {
  constexpr int L = ND / 2;
  using Grp = gl::Grp<L, G>;
  constexpr int M = Grp::M;
  extern __shared__ uint32_t C[];
  for (int k = threadIdx.x; k < words; k += blockDim.x) C[k] = consts[k];
  const int nodes = tree_nodes(T * S);
  uint32_t* X = C + words;          // the tree's products
  uint32_t* Y = X + nodes * L;      // and inverses
  uint32_t* W = Y + nodes * L;      // the mix's rows (H > 1)
  __syncthreads();

  const Grp g = Grp::of_thread();
  const int q = threadIdx.x / G;    // the block's group
  const int sp = q / H, h = q - sp * H;  // its sponge, its share of it
  const long long i = (long long)blockIdx.x * S + sp;
  // a sponge past the batch runs the rounds on a zero state (its leaves
  // share the tree) and stores nothing
  const bool live = i < n;
  uint32_t P[M], ONE[M], R3[M], ZERO[M];
  gl::grp_ld_sh<L, G>(g, C, 0, P);
  gl::grp_ld_sh<L, G>(g, C, 1, ONE);
  gl::grp_ld_sh<L, G>(g, C, 2, R3);
  uint32_t s[T][M];
#pragma unroll
  for (int j = 0; j < M; j++) ZERO[j] = 0;
#pragma unroll
  for (int t = 0; t < T; t++) {
    if (live)
      gl::grp_load<L, G>(g, in + (i * T + t) * ND, s[t]);
    else
      gl::part_copy<M>(ZERO, s[t]);
  }

  const int rounds = 2 * r_f + r_p;
#pragma unroll 1
  for (int r = 0; r < rounds; r++) {
    uint32_t a[M];
#pragma unroll
    for (int t = 0; t < T; t++) {
      gl::grp_ld_sh<L, G>(g, C, kHead + r * T + t, a);
      gl::grp_add_mod<L, G>(g, s[t], a, P, s[t]);
    }
    // S-box: leaves sp k .. sp k + k - 1 of the block's tree
    const int k = r >= r_f && r < r_f + r_p ? 1 : T;
    bool z[T];
#pragma unroll
    for (int t = 0; t < T; t++) {
      z[t] = false;
      if (t < k) {
        z[t] = gl::grp_is_zero<L, G>(g, s[t]);
        if (h == 0) {
          gl::part_select<M>(z[t], ONE, s[t], a);
          gl::grp_st_sh<L, G>(g, X, sp * k + t, a);
        }
      }
    }
    __syncthreads();
    tree_inverse<L, G>(g, X, Y, k * S, S * H, q, P, R3, inv);
#pragma unroll
    for (int t = 0; t < T; t++) {
      if (t < k) {
        gl::grp_ld_sh<L, G>(g, Y, sp * k + t, a);
        gl::part_select<M>(z[t], ZERO, a, s[t]);
      }
    }

    if (r < rounds - 1) {           // the last round has no MDS mix
      // new_kk = sum_j MDS[kk][j] s_j: three products and one reduction a
      // row (grp_mont_sum3), one copy of its code; all T rows (H = 1), or
      // row h (H = T)
      uint32_t n0[M], n1[M], n2[M];
#pragma unroll 1
      for (int kk = H == 1 ? 0 : h; kk < (H == 1 ? T : h + 1); kk++) {
        uint32_t m0[M], m1[M], m2[M], acc[M];
        gl::grp_ld_sh<L, G>(g, C, 3 + kk * T, m0);
        gl::grp_ld_sh<L, G>(g, C, 3 + kk * T + 1, m1);
        gl::grp_ld_sh<L, G>(g, C, 3 + kk * T + 2, m2);
        gl::grp_mont_sum3<L, G>(g, m0, s[0], m1, s[1], m2, s[2], P, inv,
                                acc);
        gl::part_select<M>(kk == 0, acc, n0, n0);
        gl::part_select<M>(kk == 1, acc, n1, n1);
        gl::part_select<M>(kk == 2, acc, n2, n2);
      }
      if (H == 1) {
        gl::part_copy<M>(n0, s[0]);
        gl::part_copy<M>(n1, s[1]);
        gl::part_copy<M>(n2, s[2]);
      } else {
        gl::part_select<M>(h == 0, n0, h == 1 ? n1 : n2, a);
        gl::grp_st_sh<L, G>(g, W, sp * T + h, a);
        __syncthreads();
#pragma unroll
        for (int t = 0; t < T; t++) gl::grp_ld_sh<L, G>(g, W, sp * T + t, s[t]);
      }
    }
  }

  if (live && h == 0) {
#pragma unroll
    for (int t = 0; t < T; t++)
      gl::grp_store<L, G>(g, out + (i * T + t) * ND, s[t]);
  }
}

// Sponges a block for a batch of n on a card of `sms` SMs: the largest
// power of two S <= kMaxSponges whose ceil(n / S) blocks give every SM at
// least kMinBlocksPerSM; 1 where none above 1 does.
int block_sponges(long long n, int sms) {
  int s = kMaxSponges;
  while (s > 1 && (n + s - 1) / s < (long long)kMinBlocksPerSM * sms)
    s >>= 1;
  return s;
}

int sm_count(int& sms) {
  static int cache[gl::MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= gl::MAX_DEVICES) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && cache[dev] == 0)
    e = cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount,
                               dev);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller returns it
    return (int)e;
  }
  sms = cache[dev];
  return 0;
}

template <int ND, int H, int BLOCKS>
int launch_h(const void* in, void* out, int n, const void* consts, int words,
             int r_f, int r_p, uint32_t inv, int S, void* stream) {
  constexpr int G = group_size<ND>();
  constexpr int L = ND / 2;
  static int opened[gl::MAX_DEVICES];
  const int bytes = (words + 2 * tree_nodes(T * S) * L +
                     (H > 1 ? T * S * L : 0)) * (int)sizeof(uint32_t);
  cudaError_t e =
      gl::open_smem(poseidon_kernel<ND, G, H, BLOCKS>, bytes, opened);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = ((long long)n + S - 1) / S;
  poseidon_kernel<ND, G, H, BLOCKS><<<(unsigned)blocks, S * H * G, bytes,
                                      (cudaStream_t)stream>>>(
      (const long long*)in, (long long*)out, n, (const uint32_t*)consts,
      words, r_f, r_p, inv, S);
  return (int)cudaGetLastError();
}

// S = 1: three groups a sponge; S = kWideSponges: 64 registers a thread
// (2 blocks of 512 threads an SM); between: one group a sponge, as many
// registers as the kernel wants.
template <int ND>
int launch(const void* in, void* out, int n, const void* consts, int words,
           int r_f, int r_p, uint32_t inv, void* stream) {
  int sms = 0;
  const int rc = sm_count(sms);
  if (rc != 0) return rc;
  const int S = block_sponges(n, sms);
  if (S == 1)
    return launch_h<ND, T, 1>(in, out, n, consts, words, r_f, r_p, inv, S,
                              stream);
  if (S >= kWideSponges)
    return launch_h<ND, 1, kWideBlocks>(in, out, n, consts, words, r_f, r_p,
                                        inv, S, stream);
  return launch_h<ND, 1, 1>(in, out, n, consts, words, r_f, r_p, inv, S,
                            stream);
}

}  // namespace

// in, out: dense [n, 3, nd] digits; consts: device buffer of `words` 32-bit
// limbs laid out as above, (12 + 3 * (2 r_f + r_p)) * nd / 2 of them.
// Returns cudaGetLastError() of the launch, -1 for a digit
// count that was not built, -2 for round counts it cannot take (r_f < 1 or
// r_p < 0), -3 for a constant buffer of the wrong size.
extern "C" int gl_poseidon_permute(int nd, const void* in, void* out, int n,
                                   const void* consts, int words, int r_f,
                                   int r_p, uint32_t inv, void* stream) {
  if (n <= 0) return 0;
  if (r_f < 1 || r_p < 0) return -2;
  if (words != (kHead + T * (2 * r_f + r_p)) * (nd / 2)) return -3;
  switch (nd) {
    case 16: return launch<16>(in, out, n, consts, words, r_f, r_p, inv, stream);
    case 24: return launch<24>(in, out, n, consts, words, r_f, r_p, inv, stream);
    case 48: return launch<48>(in, out, n, consts, words, r_f, r_p, inv, stream);
    default: return -1;
  }
}

// The S the launcher takes for a batch of n on the current device (the
// same rule as ops/poseidon_kernels.block_sponges), or the negated CUDA
// error of the device query.
extern "C" int gl_poseidon_block_sponges(int n) {
  int sms = 0;
  const int rc = sm_count(sms);
  return rc != 0 ? -rc : block_sponges(n, sms);
}

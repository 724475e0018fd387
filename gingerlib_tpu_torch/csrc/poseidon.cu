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
// tile through a halving product tree.  None of it carries over.  Here one
// thread owns one sponge for all rounds: its three elements stay in
// thread-local storage as canonical 32-bit limbs (so zero is zero), the
// round constants, the MDS matrix, p, 1 and R^3 sit in shared memory, and
// every field operation is a non-inlined call of fp_limbs.cuh (the registers
// of one multiply).  A full round inverts the thread's three elements by
// Montgomery's trick with ONE binary-Euclid inversion (zeros enter as one and
// leave as zero) and one multiply by R^3 to return to Montgomery form, as
// fp.inv_mod does; a partial round inverts one element the same way.  An
// inverse is unique and every step returns the canonical residue, so the
// digits are those of the array path, which shares one inversion across the
// whole batch instead.
//
// What bounds it on an H100: the binary-Euclid inversions, one a round per
// sponge and about 1,800 data-dependent halvings and subtractions of L limbs
// each, and beside them 16 multiplies a full round and 10 a partial one; the
// state is 3 elements in and out.  The inversions are serial within a thread
// and their branches diverge within a warp, so one sponge is latency (its 65
// rounds run back to back) and a large batch is bound by the divergent
// instruction stream, not by the integer rate.  The function itself needs
// only one inversion a round for the whole batch (the array path's shared
// tree), so the kernel's own inversions are work of this design, well above
// the function's bound.
#include <cuda_runtime.h>

#include "fp_limbs.cuh"

namespace {

constexpr int T = 3;
// constants in shared memory, L limbs each: p, one, R^3, then the MDS
// matrix row-major, then the round constants round by round
constexpr int kHead = 3 + T * T;

template <int ND>
__global__ void __launch_bounds__(64)
poseidon_kernel(const long long* __restrict__ in, long long* __restrict__ out,
                int n, const uint32_t* __restrict__ consts, int words,
                int r_f, int r_p, uint32_t inv) {
  constexpr int L = ND / 2;
  extern __shared__ uint32_t C[];
  for (int k = threadIdx.x; k < words; k += blockDim.x) C[k] = consts[k];
  __syncthreads();
  const uint32_t* P = C;
  const uint32_t* ONE = C + L;
  const uint32_t* R3 = C + 2 * L;
  const uint32_t* MDS = C + 3 * L;
  const uint32_t* RC = C + kHead * L;

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t s[T][L], a[T][L], o[T][L], y[L];
#pragma unroll
  for (int j = 0; j < T; j++)
    gl::load_digits<L>(in + ((size_t)i * T + j) * ND, s[j]);

  const int rounds = 2 * r_f + r_p;
  for (int r = 0; r < rounds; r++) {
    const uint32_t* rc = RC + r * T * L;
#pragma unroll
    for (int j = 0; j < T; j++) gl::add_mod_mem<L>(s[j], rc + j * L, P, s[j]);

    if (r >= r_f && r < r_f + r_p) {  // partial round: s0 <- s0^-1
      gl::inv_bea_mem<L>(s[0], P, y);
      gl::mont_mul_mem<L>(y, R3, P, inv, s[0]);
    } else {                          // full round: all three, one inversion
      bool z[T];
#pragma unroll
      for (int j = 0; j < T; j++) {
        z[j] = gl::is_zero<L>(s[j]);
        gl::copy_limbs<L>(z[j] ? ONE : s[j], a[j]);
      }
      gl::mont_mul_mem<L>(a[0], a[1], P, inv, o[0]);  // a0 a1
      gl::mont_mul_mem<L>(o[0], a[2], P, inv, o[1]);  // a0 a1 a2
      gl::inv_bea_mem<L>(o[1], P, y);                 // plain (a0 a1 a2 R)^-1
      gl::mont_mul_mem<L>(y, R3, P, inv, y);          // (a0 a1 a2)^-1
      gl::mont_mul_mem<L>(y, o[0], P, inv, s[2]);     // a2^-1
      gl::mont_mul_mem<L>(y, a[2], P, inv, y);        // (a0 a1)^-1
      gl::mont_mul_mem<L>(y, a[1], P, inv, s[0]);     // a0^-1
      gl::mont_mul_mem<L>(y, a[0], P, inv, s[1]);     // a1^-1
#pragma unroll
      for (int j = 0; j < T; j++)
        if (z[j]) gl::zero_limbs<L>(s[j]);
    }

    if (r < rounds - 1) {             // the last round has no MDS mix
#pragma unroll
      for (int k = 0; k < T; k++) {
        const uint32_t* row = MDS + k * T * L;
        gl::mont_mul_mem<L>(row, s[0], P, inv, o[k]);
#pragma unroll
        for (int j = 1; j < T; j++) {
          gl::mont_mul_mem<L>(row + j * L, s[j], P, inv, y);
          gl::add_mod_mem<L>(o[k], y, P, o[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < T; k++) gl::copy_limbs<L>(o[k], s[k]);
    }
  }

#pragma unroll
  for (int j = 0; j < T; j++)
    gl::store_digits<L>(out + ((size_t)i * T + j) * ND, s[j]);
}

template <int ND>
int launch(const void* in, void* out, int n, const void* consts, int words,
           int r_f, int r_p, uint32_t inv, void* stream) {
  size_t smem = (size_t)words * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        poseidon_kernel<ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = 64;
  int blocks = (n + threads - 1) / threads;
  poseidon_kernel<ND><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const long long*)in, (long long*)out, n, (const uint32_t*)consts,
      words, r_f, r_p, inv);
  return (int)cudaGetLastError();
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

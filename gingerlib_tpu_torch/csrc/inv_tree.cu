// K6: shared inversion of a batch of field elements (Montgomery's trick):
// all N inverses for about 3 multiplies an element and ONE field inversion.
//
//   up  :  every thread walks a run of `run` consecutive elements, keeps the
//          running product, stores it after each element (prefix products,
//          as packed 32-bit limbs) and leaves the run's product in `roots`;
//   ...    the wrapper inverts `roots` -- by the same two kernels while more
//          than one is left, by the binary-Euclid kernel (inv_bea.cu) for
//          the last one;
//   down:  every thread walks its run backwards with the inverse r of the
//          run's product:  1/x_j = r * prefix_{j-1},  r <- r * x_j.
//
// A zero element counts as one on the way up and comes out as zero.
//
// Replaces _inv_up_kernel / _inv_down_kernel of gingerlib_tpu/ops/pallas_ec.py
// (entries _inv_tree_rec, _batch_inverse_dm).  Those fold a 1024-column tile
// in halves, log2(1024) levels held in the TPU's large on-chip memory, and
// recurse over the tile roots.  An inverse mod p is unique and every product
// here is the canonical residue, so any grouping gives the same digits; the
// grouping that suits this card is a short serial run per thread: no level
// storage in shared memory (a block has 227 KB), no synchronisation inside a
// block, any N, and the recursion over run products keeps the tree's log
// depth (run 8: 2^18 elements take 6 levels).
//
// What bounds it on an H100: 3 (run - 1) / run multiplies an element of
// 2*L*L + L multiply-adds each; against that, reading the element twice and
// writing the inverse and the prefix product is little.  Each thread's
// multiplies form one dependent chain (run - 1 up, 2 (run - 1) down), so the
// small top levels are latency, not throughput.
#include <cuda_runtime.h>
#include <string.h>

#include "fp_limbs.cuh"

namespace {

template <int ND>
__global__ void __launch_bounds__(64)
inv_up_kernel(const long long* __restrict__ x, uint32_t* __restrict__ pre,
              long long* __restrict__ roots, int n, int run,
              const gl::CurveConst<ND / 2> K) {
  constexpr int L = ND / 2;
  __shared__ uint32_t C[3 * L];
  gl::stage_consts<L>(K, C);
  const uint32_t* P = C;
  const uint32_t* ONE = C + 2 * L;

  int t = blockIdx.x * blockDim.x + threadIdx.x;
  long long first = (long long)t * run;
  if (first >= n) return;
  long long last = first + run < n ? first + run : n;

  uint32_t acc[L], e[L];
  gl::load_digits<L>(x + (size_t)first * ND, acc);
  if (gl::is_zero<L>(acc)) gl::copy_limbs<L>(ONE, acc);
  gl::copy_limbs<L>(acc, pre + (size_t)first * L);
  for (long long j = first + 1; j < last; j++) {
    gl::load_digits<L>(x + (size_t)j * ND, e);
    if (!gl::is_zero<L>(e)) gl::mont_mul_mem<L>(acc, e, P, K.inv, acc);
    gl::copy_limbs<L>(acc, pre + (size_t)j * L);
  }
  gl::store_digits<L>(roots + (size_t)t * ND, acc);
}

template <int ND>
__global__ void __launch_bounds__(64)
inv_down_kernel(const long long* __restrict__ x,
                const uint32_t* __restrict__ pre,
                const long long* __restrict__ rinv,
                long long* __restrict__ out, int n, int run,
                const gl::CurveConst<ND / 2> K) {
  constexpr int L = ND / 2;
  __shared__ uint32_t C[3 * L];
  gl::stage_consts<L>(K, C);
  const uint32_t* P = C;

  int t = blockIdx.x * blockDim.x + threadIdx.x;
  long long first = (long long)t * run;
  if (first >= n) return;
  long long last = first + run < n ? first + run : n;

  uint32_t r[L], e[L], w[L];
  gl::load_digits<L>(rinv + (size_t)t * ND, r);
  for (long long j = last - 1; j > first; j--) {
    gl::load_digits<L>(x + (size_t)j * ND, e);
    if (gl::is_zero<L>(e)) {
      gl::zero_limbs<L>(w);
    } else {
      gl::copy_limbs<L>(pre + (size_t)(j - 1) * L, w);
      gl::mont_mul_mem<L>(r, w, P, K.inv, w);
      gl::mont_mul_mem<L>(r, e, P, K.inv, r);
    }
    gl::store_digits<L>(out + (size_t)j * ND, w);
  }
  gl::load_digits<L>(x + (size_t)first * ND, e);
  if (gl::is_zero<L>(e)) gl::zero_limbs<L>(r);
  gl::store_digits<L>(out + (size_t)first * ND, r);
}

template <int ND>
int launch_up(const void* x, void* pre, void* roots, int n, int run,
              const uint32_t* consts, uint32_t inv, void* stream) {
  const int threads = 64;
  int runs = (n + run - 1) / run;
  int blocks = (runs + threads - 1) / threads;
  inv_up_kernel<ND><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)x, (uint32_t*)pre, (long long*)roots, n, run,
      gl::make_curve_const<ND / 2>(consts, inv, 0));
  return (int)cudaGetLastError();
}

template <int ND>
int launch_down(const void* x, const void* pre, const void* rinv, void* out,
                int n, int run, const uint32_t* consts, uint32_t inv,
                void* stream) {
  const int threads = 64;
  int runs = (n + run - 1) / run;
  int blocks = (runs + threads - 1) / threads;
  inv_down_kernel<ND><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)x, (const uint32_t*)pre, (const long long*)rinv,
      (long long*)out, n, run, gl::make_curve_const<ND / 2>(consts, inv, 0));
  return (int)cudaGetLastError();
}

}  // namespace

// x: dense [n, nd] digits; pre: scratch of n * nd/2 32-bit words; roots:
// dense [ceil(n / run), nd] output; consts: 3*nd/2 limbs [p | a | one] (a is
// not read).  Returns cudaGetLastError() of the launch, -1 for a digit count
// that was not built, -2 for a run below 1.
extern "C" int gl_inv_tree_up(int nd, const void* x, void* pre, void* roots,
                              int n, int run, const uint32_t* consts,
                              uint32_t inv, void* stream) {
  if (n <= 0) return 0;
  if (run < 1) return -2;
  switch (nd) {
    case 16: return launch_up<16>(x, pre, roots, n, run, consts, inv, stream);
    case 24: return launch_up<24>(x, pre, roots, n, run, consts, inv, stream);
    case 48: return launch_up<48>(x, pre, roots, n, run, consts, inv, stream);
    default: return -1;
  }
}

// rinv: dense [ceil(n / run), nd], the inverses of `roots`; out: dense
// [n, nd] output, the inverses of x (zero where x is zero).
extern "C" int gl_inv_tree_down(int nd, const void* x, const void* pre,
                                const void* rinv, void* out, int n, int run,
                                const uint32_t* consts, uint32_t inv,
                                void* stream) {
  if (n <= 0) return 0;
  if (run < 1) return -2;
  switch (nd) {
    case 16: return launch_down<16>(x, pre, rinv, out, n, run, consts, inv, stream);
    case 24: return launch_down<24>(x, pre, rinv, out, n, run, consts, inv, stream);
    case 48: return launch_down<48>(x, pre, rinv, out, n, run, consts, inv, stream);
    default: return -1;
  }
}

// K7: batched double-base RNS Montgomery multiply  out = x * y * M_A^-1
// (mod p), residues in the packed [n, 128] int32 layout of
// gingerlib_tpu_torch/ops/rns_kernels.py (base A in words 0..k-1, base B in
// 64..63+k).  Values below 3p out for products below 2^10 p^2 in.
//
// Replaces _rns_mont_kernel behind mont_mul_rns_pallas of
// gingerlib_tpu/ops/pallas_rns.py (pallas_rns.py:171-207; its core
// _rns_mont_core:148 is also the tree kernel of pallas_ec_rns.py).  The TPU
// kernel lays an element down a 128-row column and runs the two base
// extensions as [128, 128] x [128, N] bf16 matrix products on 7-bit splits
// (so that the matrix unit stays exact), with Barrett reductions on the
// vector unit.  Here one WARP owns one element (rns_core.cuh): each lane
// keeps four of its 128 words in registers, and each extension is a 64-bit
// integer inner product of the k source sigmas (a shared-memory row of the
// warp) with the constant matrix (shared memory, 2 k^2 words), two
// destination channels a lane.  The block stages the constants once and then
// walks over elements, eight warps at a time.
//
// What bounds it on an H100: the integer multiply-adds.  A multiply is two
// k x k extensions (2 k^2 = 6,962 multiply-adds at k = 59) plus about 10 k
// channel products and their reductions, against 128 words x 3 of traffic;
// chip_smoke.py computes both bounds and PERF.md holds the time beside
// them.  The extensions run on the CUDA cores; the integer tensor cores
// (int8 mma over 7-bit splits, as the TPU split them) are the known lever.
#include <cuda_runtime.h>

#include "rns_core.cuh"

namespace {

constexpr int WARPS = 8;   // elements in flight a block

__global__ void __launch_bounds__(WARPS * 32)
rns_mont_kernel(const int* __restrict__ x, long long x_stride,
                const int* __restrict__ y, long long y_stride,
                int* __restrict__ out, int n,
                const uint32_t* __restrict__ consts, int k) {
  extern __shared__ uint32_t sm[];
  const int words = rns::const_words(k);
  rns::stage(sm, consts, words);
  uint32_t* sig = sm + words + (threadIdx.x / 32) * rns::B_ROW;
  __syncthreads();
  const rns::Consts K = rns::consts_at(sm, k);
  // the element index is the same in all lanes of a warp: no divergence
  for (int e = blockIdx.x * WARPS + threadIdx.x / 32; e < n;
       e += gridDim.x * WARPS) {
    rns::Elem a, b, r;
    rns::load_elem(x + (size_t)e * x_stride, a);
    rns::load_elem(y + (size_t)e * y_stride, b);
    rns::mont(K, sig, a, b, r);
    rns::store_elem(out + (size_t)e * rns::LANES, r);
  }
}

}  // namespace

// x, y: rows of 128 int32 words, x_stride / y_stride words apart (0: one
// row for all); out: dense [n, 128]; consts: device block of
// const_words(k) words (rns_core.cuh).  Returns cudaGetLastError() of the
// launch, or -1 for a channel count above 64.
extern "C" int gl_rns_mont(int k, const void* x, long long x_stride,
                           const void* y, long long y_stride, void* out,
                           int n, const void* consts, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > rns::B_ROW) return -1;
  size_t smem = (rns::const_words(k) + WARPS * rns::B_ROW) * sizeof(uint32_t);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rns_mont_kernel,
                                                WARPS * 32, smem);
  int blocks = (n + WARPS - 1) / WARPS;
  int resident = (per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > resident) blocks = resident;
  rns_mont_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const int*)x, x_stride, (const int*)y, y_stride, (int*)out, n,
      (const uint32_t*)consts, k);
  return (int)cudaGetLastError();
}

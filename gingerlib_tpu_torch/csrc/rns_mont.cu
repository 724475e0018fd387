// K7: batched double-base RNS Montgomery multiply  out = x * y * M_A^-1
// (mod p), residues in the packed [n, 128] int32 layout of
// gingerlib_tpu_torch/ops/rns_kernels.py (base A in words 0..k-1, base B in
// 64..63+k).  Values below 3p out for products below 2^10 p^2 in.
//
// Replaces _rns_mont_kernel behind mont_mul_rns_pallas of
// gingerlib_tpu/ops/pallas_rns.py (pallas_rns.py:171-207; its core
// _rns_mont_core:148 is also the tree kernel of pallas_ec_rns.py).  The TPU
// kernel lays an element down a 128-row column and runs the two base
// extensions as [128, 128] x [128, N] bf16 matrix products on 7-bit splits,
// with Barrett reductions on the vector unit.  Here (rns_core.cuh) a block
// of 128 threads owns a tile of 16 elements: the channelwise steps run on
// the CUDA cores, one thread per (element, channel word) set, and each
// extension is a [16, 64] x [64, 64] product on the integer tensor cores
// (mma.m16n8k32 over byte splits, 16 a warp).  Blocks are persistent (as
// many as fit, from the occupancy API): each stages the constants once,
// then walks over tiles, asking by cp.async for the next tile's rows as
// soon as the current ones are in registers.
//
// Row selection for the inversion tree's down-sweep: element e multiplies
// row e >> x_shift of x by row e ^ y_xor of y, so one launch multiplies
// each parent by the sibling of each of its two children.
//
// What bounds it on an H100: the bytes of the packed rows (3 x 512 a
// multiply, against 3 x 236 bytes of residues) and the channelwise 32-bit
// operations (~3,000 a multiply at k = 59); the extensions' byte products
// (4 x 2 x 64 x 64 a multiply) take the tensor cores far below either.
// chip_smoke.py computes the bound and PERF.md holds the time beside it.
#include <cuda_runtime.h>

#include "rns_core.cuh"

namespace {

using rns::STAGE_WORDS;
using rns::TILE;

struct Operand {
  const int* ptr;
  long long stride;   // words between rows (0: one row for all)
  int shift;          // row of element e: (e >> shift) ^ flip
  int flip;
};

// Rows of tile `tile` of both operands into shared memory, 16 bytes a
// copy, consecutive threads on consecutive chunks of a row; rows at or
// beyond n are zero.
__device__ __forceinline__ void fetch(const Operand (&op)[2], int tile, int n,
                                      uint32_t* stage) {
  constexpr int CHUNKS = rns::LANES / 4;
  for (int i = threadIdx.x; i < 2 * TILE * CHUNKS; i += rns::THREADS) {
    const int o = i / (TILE * CHUNKS), r = (i / CHUNKS) % TILE,
              c = i % CHUNKS;
    const int e = tile * TILE + r;
    const bool ok = e < n;
    const long long row = ok ? (e >> op[o].shift) ^ op[o].flip : 0;
    rns::cp_async16(stage + (o * TILE + r) * STAGE_WORDS + 4 * c,
                    op[o].ptr + row * op[o].stride + 4 * c, ok);
  }
  rns::cp_async_commit();
}

// four blocks an SM: up to 128 registers a thread, no spill
__global__ void __launch_bounds__(rns::THREADS, 4)
rns_mont_kernel(const Operand x, const Operand y, int* __restrict__ out,
                int n, const uint32_t* __restrict__ consts, int k) {
  extern __shared__ __align__(16) uint32_t sm[];
  uint32_t* stage = sm + rns::CONST_WORDS;
  uint32_t* work = stage + 2 * TILE * STAGE_WORDS;
  const Operand op[2] = {x, y};
  const int tiles = (n + TILE - 1) / TILE;
  int tile = blockIdx.x;
  rns::stage(sm, consts, rns::CONST_WORDS);
  if (tile < tiles) fetch(op, tile, n, stage);
  const rns::Core C = rns::core_at(sm, work, k);
  const uint32_t st = rns::smem(stage);
  for (; tile < tiles; tile += gridDim.x) {
    rns::cp_async_wait_all();
    __syncthreads();
    rns::Elem a, b, r;
    rns::load_staged(C, st, a);
    rns::load_staged(C, st + 4 * TILE * STAGE_WORDS, b);
    __syncthreads();                  // every thread has its words
    if (tile + gridDim.x < tiles) fetch(op, tile + gridDim.x, n, stage);
    rns::mont_inline(C, a, b, r);
    rns::store_rows(C, out, tile * TILE, n, r);
  }
}

size_t smem_bytes() {
  return (rns::CONST_WORDS + 2 * TILE * STAGE_WORDS + rns::WORK_WORDS) *
         sizeof(uint32_t);
}

}  // namespace

// x, y: rows of 128 int32 words, x_stride / y_stride words apart (0: one
// row for all), 16-byte aligned; element e takes row (e >> x_shift) of x
// and row (e ^ y_xor) of y; out: dense [n, 128]; consts: device block of
// rns::CONST_WORDS words (rns_core.cuh).  Returns the CUDA error of the
// set-up or the launch, or -1 for a channel count above 64 or a shift or
// flip other than 0 or 1.
extern "C" int gl_rns_mont(int k, const void* x, long long x_stride,
                           int x_shift, const void* y, long long y_stride,
                           int y_xor, void* out, int n, const void* consts,
                           void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > rns::B_ROW || (x_shift & ~1) || (y_xor & ~1)) return -1;
  static int per_sm[64];            // resident blocks an SM, by device
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = smem_bytes();
  if (e == cudaSuccess && dev < 64 && per_sm[dev] == 0) {
    e = cudaFuncSetAttribute(rns_mont_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[dev], rns_mont_kernel, rns::THREADS, smem);
  }
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + TILE - 1) / TILE;
  int resident = (dev < 64 && per_sm[dev] > 0 ? per_sm[dev] : 1) * sms;
  const int blocks = tiles < resident ? tiles : resident;
  const Operand xo = {(const int*)x, x_stride, x_shift, 0};
  const Operand yo = {(const int*)y, y_stride, 0, y_xor};
  rns_mont_kernel<<<blocks, rns::THREADS, smem, (cudaStream_t)stream>>>(
      xo, yo, (int*)out, n, (const uint32_t*)consts, k);
  return (int)cudaGetLastError();
}

// Prime-field arithmetic on 32-bit limbs held in registers, one field element
// per CUDA thread.  Shared by every kernel of the library: Montgomery
// multiply, modular add/sub/neg (register forms and the tile loop, first
// part), affine curve additions and inversion trees (the multiply's
// memory-resident form, second part).  The projective addition, the pow
// chain and Poseidon spread each element over a group of threads
// (fp_group.cuh); the inverse of one element is fp_inv.cuh.
//
// Boundary layout (see gingerlib_tpu_torch/fields/fp.py): an element is ND
// little-endian 16-bit digits, each stored in an int64, so R = 2^(16*ND).
// Two digits make one limb: L = ND/2 limbs of 32 bits share the same R, which
// is why only even ND is built.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace gl {

// Per-field constants, passed to kernels by value so that they sit in the
// kernel-parameter constant bank: fully unrolled loops index them with
// compile-time offsets and they cost no registers.
template <int L>
struct FpConst {
  uint32_t p[L];   // modulus, little-endian limbs
  uint32_t inv;    // -p^-1 mod 2^32
};

template <int L>
__device__ __forceinline__ void load_digits(const long long* __restrict__ src,
                                            uint32_t (&x)[L]) {
  const longlong2* s2 = reinterpret_cast<const longlong2*>(src);
#pragma unroll
  for (int i = 0; i < L; i++) {
    longlong2 d = s2[i];  // rows are 16-byte aligned: ND even, 8-byte digits
    x[i] = ((uint32_t)d.x & 0xFFFFu) | ((uint32_t)d.y << 16);
  }
}

template <int L>
__device__ __forceinline__ void store_digits(long long* __restrict__ dst,
                                             const uint32_t (&x)[L]) {
  longlong2* d2 = reinterpret_cast<longlong2*>(dst);
#pragma unroll
  for (int i = 0; i < L; i++) {
    longlong2 d;
    d.x = (long long)(x[i] & 0xFFFFu);
    d.y = (long long)(x[i] >> 16);
    d2[i] = d;
  }
}

// ---------------------------------------------------------------------------
// Tiles streamed through shared memory, for the elementwise kernels (the
// Montgomery multiply and the add/sub/neg helper).  A row of the boundary
// layout is ND*8 bytes: threads that each read their own row load from
// addresses ND*8 bytes apart across a warp, so each warp-wide load touches
// 32 lines and uses a few bytes of each, and a block's operands overflow the
// L1 before its threads come back to the same lines.  Here a block of T
// threads moves a tile of T rows together: a warp's lanes take consecutive
// digits (or 16-byte chunks) of a row, so its accesses cover whole lines, and
// a dense operand's tile is one contiguous range.
//
// Operands come in by cp.async, straight from global to shared memory with
// no registers held: the low 32-bit word of each int64 digit (a digit is
// below 2^16), ND + 1 words a row (the odd row stride puts thread t's reads
// of its own row, word t*(ND+1) + j, in 32 different banks).  A thread
// packs its row's digit pairs into limbs as it reads them.  So a block can
// ask for its next tile while it computes on the current one: the operands
// are in registers by then, and their shared memory is free (tile_loop).
// Results leave through shared memory as L + 1 packed words a row and are
// written out as 16-byte digit pairs, consecutive threads on consecutive
// chunks.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Ask for batch rows base .. base+cnt-1 of operand x, row r into s + r*(2L+1):
// each warp takes whole rows, its lanes consecutive digits.  Batch row i is
// row i % rows of x, rows `stride` digits apart; a one-row operand is
// fetched once, to row 0 (its readers take row step 0).
template <int L, int T>
__device__ __forceinline__ void fetch_rows(const long long* __restrict__ x,
                                           int rows, long long stride,
                                           int base, int cnt, uint32_t* s) {
  constexpr int ND = 2 * L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nrows = rows == 1 ? 1 : cnt;
  for (int r = warp; r < nrows; r += T / 32) {
    int row = base + r;
    if (row >= rows) row %= rows;
    const long long* src = x + (size_t)row * stride;
    uint32_t* dst = s + r * (ND + 1);
#pragma unroll
    for (int d = lane; d < ND; d += 32) cp_async4(dst + d, src + d);
  }
}

// The limbs of a fetched row.
template <int L>
__device__ __forceinline__ void fetched_limbs(const uint32_t* s,
                                              uint32_t (&x)[L]) {
#pragma unroll
  for (int j = 0; j < L; j++)
    x[j] = (s[2 * j] & 0xFFFFu) | (s[2 * j + 1] << 16);
}

// s (rows of L + 1 packed words) -> the dense output rows base .. base+cnt-1.
template <int L, int T>
__device__ __forceinline__ void unstage_rows(const uint32_t* s,
                                             long long* __restrict__ out,
                                             int base, int cnt) {
  longlong2* o = reinterpret_cast<longlong2*>(out + (size_t)base * 2 * L);
  const int total = cnt * L;
#pragma unroll 8
  for (int it = 0; it < L; it++) {
    int k = it * T + (int)threadIdx.x;
    if (k < total) {
      uint32_t w = s[k + k / L];
      longlong2 d;
      d.x = (long long)(w & 0xFFFFu);
      d.y = (long long)(w >> 16);
      o[k] = d;
    }
  }
}

// Rows a tile takes in shared memory: T, or n where the whole batch is
// smaller, so that a launch on a few elements asks for little shared memory.
template <int T>
__host__ __device__ __forceinline__ int tile_rows(int n) {
  return n < T ? n : T;
}

// Bytes of dynamic shared memory tile_loop takes for n rows: NOPS fetched
// operand tiles and one result tile.
template <int L, int T, int NOPS>
__host__ __device__ __forceinline__ int tile_loop_bytes(int n) {
  return 4 * tile_rows<T>(n) * (NOPS * (2 * L + 1) + L + 1);
}

// Host side: the launch of a tile_loop kernel over n rows, (blocks, bytes):
// as many blocks as can be resident at once with full tiles, at most one a
// tile.  `resident` is the caller's cache of that count for this kernel,
// one entry a device, 0 until known: the first call on a device also opens
// the kernel's dynamic shared memory to a full tile's there.  Returns the
// first CUDA error of those queries, else cudaSuccess.
constexpr int MAX_DEVICES = 16;

template <int L, int T, int NOPS, typename Kernel>
inline cudaError_t tile_loop_launch(Kernel kernel, int n,
                                    int (&resident)[MAX_DEVICES],
                                    int& blocks, int& bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= MAX_DEVICES) e = cudaErrorInvalidDevice;
  if (e != cudaSuccess) return e;
  if (resident[dev] == 0) {
    const int full = tile_loop_bytes<L, T, NOPS>(T);
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, full)) !=
            cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T,
                                                           full)) !=
            cudaSuccess) {
      cudaGetLastError();  // clear it: the caller returns it
      return e;
    }
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int tiles = (n + T - 1) / T;
  blocks = tiles < resident[dev] ? tiles : resident[dev];
  bytes = tile_loop_bytes<L, T, NOPS>(n);
  return cudaSuccess;
}

// Host side: lets `kernel` take `bytes` of dynamic shared memory on the
// current device (above 48 KB a kernel has to ask for it).  `opened` is the
// caller's record for this kernel, one entry a device: the most it has
// asked for there.  Returns the CUDA error of the query or the setting.
template <typename Kernel>
inline cudaError_t open_smem(Kernel kernel, int bytes,
                             int (&opened)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= MAX_DEVICES) e = cudaErrorInvalidDevice;
  if (e != cudaSuccess || bytes <= opened[dev]) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller returns it
    return e;
  }
  opened[dev] = bytes;
  return cudaSuccess;
}

// The elementwise kernels' body: out[i] = op(a[i], b[i]) for every batch
// row i (op(a) when NOPS == 1), each block walking tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...; the next tile's operands are fetched while
// the current one computes.  Row addressing as fetch_rows; the output is
// dense.  smem: tile_loop_bytes<L, T, NOPS>(n) bytes.
template <int L, int T, int NOPS, typename Op>
__device__ __forceinline__ void tile_loop(
    const long long* __restrict__ a, int a_rows, long long a_stride,
    const long long* __restrict__ b, int b_rows, long long b_stride,
    long long* __restrict__ out, int n, uint32_t* smem, Op op) {
  constexpr int RW = 2 * L + 1;
  const int rows = tile_rows<T>(n);
  uint32_t* sa = smem;
  uint32_t* sb = smem + rows * RW;
  uint32_t* so = smem + NOPS * rows * RW;
  const int t = threadIdx.x;
  const int tiles = (n + T - 1) / T;
  int tile = blockIdx.x;
  auto fetch = [&](int k) {
    const int base = k * T, cnt = min(T, n - base);
    fetch_rows<L, T>(a, a_rows, a_stride, base, cnt, sa);
    if constexpr (NOPS == 2)
      fetch_rows<L, T>(b, b_rows, b_stride, base, cnt, sb);
    cp_async_commit();
  };
  if (tile < tiles) fetch(tile);
  for (; tile < tiles; tile += gridDim.x) {
    const int base = tile * T, cnt = min(T, n - base);
    cp_async_wait_all();
    __syncthreads();  // the tile's operands have landed
    uint32_t x[L], y[L], r[L];
    if (t < cnt) {
      fetched_limbs<L>(sa + (a_rows == 1 ? 0 : t * RW), x);
      if constexpr (NOPS == 2)
        fetched_limbs<L>(sb + (b_rows == 1 ? 0 : t * RW), y);
    }
    __syncthreads();  // operands in registers: fetch the next tile
    if (tile + (int)gridDim.x < tiles) fetch(tile + gridDim.x);
    if (t < cnt) {
      op(x, y, r);
#pragma unroll
      for (int j = 0; j < L; j++) so[t * (L + 1) + j] = r[j];
    }
    __syncthreads();
    unstage_rows<L, T>(so, out, base, cnt);
  }
}

// r = a + b, returns the carry out of the top limb.
template <int L>
__device__ __forceinline__ uint32_t add_limbs(const uint32_t (&a)[L],
                                              const uint32_t (&b)[L],
                                              uint32_t (&r)[L]) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < L; i++) {
    c += (uint64_t)a[i] + b[i];
    r[i] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// r = a - b, returns the borrow out of the top limb (1 where b > a).
template <int L>
__device__ __forceinline__ uint32_t sub_limbs(const uint32_t (&a)[L],
                                              const uint32_t (&b)[L],
                                              uint32_t (&r)[L]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < L; i++) {
    uint64_t d = (uint64_t)a[i] - b[i] - borrow;
    r[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return borrow;
}

// x in [0, 2p) given as L limbs plus a top bit -> x mod p.
template <int L>
__device__ __forceinline__ void cond_sub_p(uint32_t (&x)[L], uint32_t top,
                                           const uint32_t (&p)[L]) {
  uint32_t d[L];
  uint32_t borrow = sub_limbs<L>(x, p, d);
  // x >= p  <=>  the subtraction over L limbs plus the top bit does not
  // go negative
  bool ge = top >= borrow;
#pragma unroll
  for (int i = 0; i < L; i++) x[i] = ge ? d[i] : x[i];
}

template <int L>
__device__ __forceinline__ void add_mod(const uint32_t (&a)[L],
                                        const uint32_t (&b)[L],
                                        const uint32_t (&p)[L],
                                        uint32_t (&r)[L]) {
  uint32_t top = add_limbs<L>(a, b, r);
  cond_sub_p<L>(r, top, p);
}

template <int L>
__device__ __forceinline__ void sub_mod(const uint32_t (&a)[L],
                                        const uint32_t (&b)[L],
                                        const uint32_t (&p)[L],
                                        uint32_t (&r)[L]) {
  uint32_t borrow = sub_limbs<L>(a, b, r);
  uint32_t fixed[L];
  add_limbs<L>(r, p, fixed);  // wraps mod 2^(32L), as wanted
#pragma unroll
  for (int i = 0; i < L; i++) r[i] = borrow ? fixed[i] : r[i];
}

template <int L>
__device__ __forceinline__ bool is_zero(const uint32_t (&a)[L]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < L; i++) acc |= a[i];
  return acc == 0;
}

// Montgomery product a*b*R^-1 mod p, R = 2^(32L), by coarsely integrated
// operand scanning (CIOS): for each limb of b, one row of the product and
// one row of the reduction, carried in 64-bit accumulators.  The result is
// canonical (< p) whenever a*b < R*p, i.e. one operand may be any value
// below R as long as the other is below p.
template <int L>
__device__ __forceinline__ void mont_mul(const uint32_t (&a)[L],
                                         const uint32_t (&b)[L],
                                         const uint32_t (&p)[L], uint32_t inv,
                                         uint32_t (&r)[L]) {
  uint32_t t[L + 2];
#pragma unroll
  for (int i = 0; i < L + 2; i++) t[i] = 0;

#pragma unroll
  for (int i = 0; i < L; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < L; j++) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[L] + c;
    t[L] = (uint32_t)s;
    t[L + 1] = (uint32_t)(s >> 32);

    uint32_t m = t[0] * inv;
    s = (uint64_t)m * p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < L; j++) {
      s = (uint64_t)m * p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[L] + c;
    t[L - 1] = (uint32_t)s;
    t[L] = t[L + 1] + (uint32_t)(s >> 32);
  }

#pragma unroll
  for (int i = 0; i < L; i++) r[i] = t[i];
  cond_sub_p<L>(r, t[L], p);
}

// ---------------------------------------------------------------------------
// The memory-resident multiply, for kernels that chain many field
// operations (the inversion tree).  Such a kernel keeps its field elements
// as L-limb arrays in thread-local or shared memory and calls this
// function, which is NOT inlined: it loads its operands into registers,
// runs the register form above and stores the result.  A curve addition then costs the
// registers of ONE multiply (not of a dozen inlined ones with all their
// operands alive), its code stays small, and the extra traffic -- 3L words
// of cached local memory per multiply against 2*L*L + L multiply-adds -- is
// a few percent.  The result may alias an operand.  ``p`` points to the
// modulus limbs (the kernels keep them in shared memory).
// ---------------------------------------------------------------------------

// Constants of one curve (or of one field: a = 0), passed to a kernel by
// value and copied by it into shared memory as [p | a | one].
template <int L>
struct CurveConst {
  uint32_t p[L];    // modulus
  uint32_t a[L];    // curve coefficient a, Montgomery form
  uint32_t one[L];  // R mod p, the Montgomery form of 1
  uint32_t inv;     // -p^-1 mod 2^32
  int a_is_zero;
};

// Host side: the struct from the wrapper's limb array [p | a | one].
template <int L>
inline CurveConst<L> make_curve_const(const uint32_t* consts, uint32_t inv,
                                      int a_is_zero) {
  CurveConst<L> K;
  memcpy(K.p, consts, sizeof(K.p));
  memcpy(K.a, consts + L, sizeof(K.a));
  memcpy(K.one, consts + 2 * L, sizeof(K.one));
  K.inv = inv;
  K.a_is_zero = a_is_zero;
  return K;
}

// To be called by every thread of a block with at least L threads, before
// any thread leaves the kernel: shared[0:L] = p, [L:2L] = a, [2L:3L] = one.
template <int L>
__device__ __forceinline__ void stage_consts(const CurveConst<L>& K,
                                             uint32_t* shared) {
  if (threadIdx.x < L) {
    shared[threadIdx.x] = K.p[threadIdx.x];
    shared[L + threadIdx.x] = K.a[threadIdx.x];
    shared[2 * L + threadIdx.x] = K.one[threadIdx.x];
  }
  __syncthreads();
}

template <int L>
__device__ __noinline__ void mont_mul_mem(const uint32_t* a, const uint32_t* b,
                                          const uint32_t* p, uint32_t inv,
                                          uint32_t* r) {
  uint32_t x[L], y[L], m[L], o[L];
#pragma unroll
  for (int i = 0; i < L; i++) {
    x[i] = a[i];
    y[i] = b[i];
    m[i] = p[i];
  }
  mont_mul<L>(x, y, m, inv, o);
#pragma unroll
  for (int i = 0; i < L; i++) r[i] = o[i];
}

template <int L>
__device__ __forceinline__ void zero_limbs(uint32_t* dst) {
#pragma unroll
  for (int i = 0; i < L; i++) dst[i] = 0;
}

}  // namespace gl

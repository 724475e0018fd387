// K6: shared inversion of a batch of field elements (Montgomery's trick):
// all N inverses for about 3 multiplies an element and ONE field inversion,
// as a product tree over tiles of B = 512 consecutive elements, one tile a
// block, the whole tree of a tile in shared memory:
//
//   up   (N > B):  each block builds its tile's product tree and writes the
//                  tree (scratch for down) and its root, the product of the
//                  tile's non-zero elements, canonical;
//   ...            the wrapper inverts the N / B roots the same way: by the
//                  tail where they fit one tile, else by up and down again;
//   tail (N <= B): one block builds the tree, one thread inverts its root
//                  (gl::inv_divsteps of fp_inv.cuh, the inverse kernel's
//                  function) and the block pushes the inverse down, all in
//                  one launch;
//   down (N > B):  each block reads its tile's tree back and pushes its
//                  root's inverse down it.
//
// So a batch of up to B elements takes one launch, of up to B^2 = 2^18
// three, of up to B^3 five.  A tree over W leaves (W a power of two; B, or
// the next power of two above N in the tail) is 2W - 1 rows of L + 1 words
// in shared memory, level by level: the leaves in rows 0 .. W-1, and each
// level of width w folds in halves, node i of the next level being
// node i times node i + w/2 (consecutive threads on consecutive rows: the
// odd row stride puts them in distinct banks).  A zero leaf counts as one
// going up and comes out as zero.  Going down, a node's inverse r gives its
// children (a, b) the inverses r b and r a.  Every product here is the
// canonical residue, and an inverse mod p is unique, so the digits are
// those of any other grouping (fp.batch_inverse_tree pairs neighbours).
//
// Replaces _inv_up_kernel / _inv_down_kernel of gingerlib_tpu/ops/
// pallas_ec.py (:258, :282; pallas_call sites _inv_up_call :313,
// _inv_down_call :342; entries _inv_tree_rec :366, _batch_inverse_dm
// :389).  Those fold a 1024-column tile in halves, ten levels in the TPU's
// on-chip memory in one launch, and recurse over the tile roots; this is
// the same tree, cut to what a block's shared memory holds: B = 512 at 48
// digits is 1023 rows x 25 words = 102,300 bytes, two blocks an SM.
//
// Staging: a block asks for its tile's rows by cp.async (fetch_rows of
// fp_limbs.cuh: a warp on consecutive digits of a row, the low word of
// each), half a tile at a time, into the rows of the levels above the
// leaves (free until the sweep starts), and each thread packs its row into
// limbs.  Inverses leave as 16-byte digit pairs, consecutive threads on
// consecutive chunks (unstage_rows).
//
// Scratch: down reads the tree that up stored (2B - 1 rows of L words a
// tile, dense: 2 x 96 bytes an element written and read again at 48
// digits) rather than recomputing it, which would read the 384-byte int64
// element again and add a multiply and log2(B) dependent levels to down.
//
// Multiplies run on register limbs (gl::mont_mul, inlined), B/2 = 256
// threads a block, one node pair each at the widest level.
//
// At the odd digit counts (19, 49): rows are read and written digit by
// digit (8-byte aligned only), the multiplies' last row reduces by 16 bits
// (fp_limbs.cuh), and the narrow levels' groups pad the limbs with zeros
// to a multiple of G (10 -> 12 at G = 4, 25 -> 32 at G = 8; fp_group.cuh).
// At 49 digits a tile's tree is 1023 rows x 26 words, 106,392 bytes, still
// two blocks an SM.
//
// What bounds it on an H100: at wide batches the multiplies (one up, two
// down an element, 2*L*L + L multiply-adds each); at a narrow level, one
// block's chain of log2(W) dependent multiplies up and as many pairs down,
// with one serial inversion between them in the tail.
#include <cuda_runtime.h>
#include <string.h>

#include "fp_group.cuh"
#include "fp_inv.cuh"
#include "fp_limbs.cuh"

namespace {

constexpr int B = 512;    // elements a tile, a power of two
constexpr int T = B / 2;  // threads a block

template <int L>
struct InvConst {
  uint32_t p[L];    // modulus
  uint32_t r3[L];   // R^3 mod p: the plain inverse of aR times R^3 / R
  uint32_t one[L];  // R mod p, the Montgomery form of 1
  uint32_t inv;     // -p^-1 mod 2^32
};

// Words a tree over W leaves takes in shared memory, the staging included.
template <int L>
__host__ __device__ __forceinline__ int tree_words(int W) {
  const int stage = W > 1 ? W / 2 : 1;
  const int tree = (2 * W - 1) * (L + 1);
  const int staged = W * (L + 1) + stage * (2 * L + 1);
  return tree > staged ? tree : staged;
}

template <int L>
__device__ __forceinline__ void load_row(const uint32_t* s, uint32_t (&x)[L]) {
#pragma unroll
  for (int j = 0; j < L; j++) x[j] = s[j];
}

template <int L>
__device__ __forceinline__ void store_row(const uint32_t (&x)[L], uint32_t* s) {
#pragma unroll
  for (int j = 0; j < L; j++) s[j] = x[j];
}

// x <- one where x is zero; returns whether it was.
template <int L>
__device__ __forceinline__ bool one_if_zero(uint32_t (&x)[L],
                                            const uint32_t (&one)[L]) {
  const bool z = gl::is_zero<L>(x);
#pragma unroll
  for (int j = 0; j < L; j++) x[j] = z ? one[j] : x[j];
  return z;
}

// Rows 0 .. W-1 of the tree <- elements base .. base+cnt-1 of x (n rows,
// dense) as limbs, zero past cnt.  Staged by cp.async half a tree at a
// time through the rows above the leaves.
template <int L, int ND>
__device__ void stage_leaves(const long long* __restrict__ x, int n, int base,
                             int cnt, int W, uint32_t* tree) {
  constexpr int RW = L + 1, SW = 2 * L + 1;
  const int chunk = W > 1 ? W / 2 : 1;
  uint32_t* stage = tree + W * RW;
  for (int c = 0; c < cnt; c += chunk) {
    const int k = min(chunk, cnt - c);
    gl::fetch_rows<L, T, ND>(x, n, ND, base + c, k, stage);
    gl::cp_async_commit();
    gl::cp_async_wait_all();
    __syncthreads();
    for (int r = threadIdx.x; r < k; r += T) {
      uint32_t v[L];
      gl::fetched_limbs<L, ND>(stage + r * SW, v);
      store_row<L>(v, tree + (c + r) * RW);
    }
    __syncthreads();  // the staging rows are free again
  }
  for (int k = cnt * RW + threadIdx.x; k < W * RW; k += T) tree[k] = 0;
  __syncthreads();
}

// The narrow levels, where a block's time is the latency of its chain of
// multiplies, run a multiply on a group of G threads (fp_group.cuh: each
// thread L / G limbs, the Montgomery rows' carry chains G times shorter):
// every level of at most T / G multiplies (up) or children (down), one a
// group.  A wider level takes one a thread, so that it too is one
// multiply's latency (the leaves going down two: a child's inverse must
// wait until its sibling has been read, so a group could keep only one).
// Each sweep holds ONE copy of each multiply: a 48-digit multiply unrolled
// is some 56 KB of instructions, and copies that run in turn do not stay
// in the instruction cache.  G is 8 from 48 digits, 4 below; the group's
// limbs LP are L rounded up to a multiple of G, the limbs above L zero.
template <int ND>
constexpr int GROUP = ND >= 48 ? 8 : 4;

// The group's part of a shared-memory row of L limbs (rank r: limbs r*M ..
// r*M+M-1 of LP, those at L and above zero, and not stored).
template <int L, int LP, int G>
__device__ __forceinline__ void load_part(const gl::Grp<LP, G>& g,
                                          const uint32_t* row,
                                          uint32_t (&x)[LP / G]) {
#pragma unroll
  for (int j = 0; j < LP / G; j++) {
    const int k = g.rank * (LP / G) + j;
    x[j] = LP == L || k < L ? row[k] : 0u;
  }
}

template <int L, int LP, int G>
__device__ __forceinline__ void store_part(const gl::Grp<LP, G>& g,
                                           const uint32_t (&x)[LP / G],
                                           uint32_t* row) {
#pragma unroll
  for (int j = 0; j < LP / G; j++) {
    const int k = g.rank * (LP / G) + j;
    if (LP == L || k < L) row[k] = x[j];
  }
}

// Levels 1 .. log2(W): node i of a level of width w/2 = node i times node
// i + w/2 of the level below, a zero leaf counting as one.  C: [p | one]
// in shared memory.
template <int ND>
__device__ __forceinline__ void sweep_up(uint32_t* tree, int W,
                                         const InvConst<gl::limbs_of<ND>>& K,
                                         const uint32_t* C) {
  constexpr int L = gl::limbs_of<ND>, RW = L + 1, G = GROUP<ND>;
  constexpr int LP = gl::group_limbs<ND, G>, M = LP / G;
  const gl::Grp<LP, G> g = gl::Grp<LP, G>::of_thread();
  const int q = threadIdx.x / G;
  uint32_t pp[M], one[M];
  load_part<L, LP, G>(g, C, pp);
  load_part<L, LP, G>(g, C + L, one);
  int lo = 0;
  for (int w = W; w > 1; w >>= 1) {
    const int h = w / 2, hi = lo + w;
    if (h > T / G) {
      for (int t = threadIdx.x; t < h; t += T) {
        uint32_t a[L], b[L], r[L];
        load_row<L>(tree + (lo + t) * RW, a);
        load_row<L>(tree + (lo + t + h) * RW, b);
        one_if_zero<L>(a, K.one);  // only a leaf can be zero
        one_if_zero<L>(b, K.one);
        gl::mont_mul<L, ND>(a, b, K.p, K.inv, r);
        store_row<L>(r, tree + (hi + t) * RW);
      }
    } else {
      for (int c = q; c < h; c += T / G) {
        uint32_t a[M], b[M], r[M];
        load_part<L, LP, G>(g, tree + (lo + c) * RW, a);
        load_part<L, LP, G>(g, tree + (lo + c + h) * RW, b);
        const bool az = gl::grp_is_zero<LP, G>(g, a);
        const bool bz = gl::grp_is_zero<LP, G>(g, b);
#pragma unroll
        for (int j = 0; j < M; j++) {
          a[j] = az ? one[j] : a[j];
          b[j] = bz ? one[j] : b[j];
        }
        gl::grp_mont_mul<LP, G, ND>(g, a, b, pp, K.inv, r);
        store_part<L, LP, G>(g, r, tree + (hi + c) * RW);
      }
    }
    __syncthreads();
    lo = hi;
  }
}

// From the root's row, which holds the root's inverse, down to the leaves,
// a level of w children at a time: child c of a node with inverse r gets r
// times its sibling (c + w/2 or c - w/2, the node's other child), a zero
// leaf gets zero.  Every child of a level reads its sibling before any is
// overwritten.  One multiply a thread (children t and t + T: two, siblings
// of one another, so the second may be written at once) while w > T / G,
// one a group above.
template <int ND>
__device__ __forceinline__ void sweep_down(uint32_t* tree, int W,
                                           const InvConst<gl::limbs_of<ND>>& K,
                                           const uint32_t* C) {
  constexpr int L = gl::limbs_of<ND>, RW = L + 1, G = GROUP<ND>;
  constexpr int LP = gl::group_limbs<ND, G>, M = LP / G;
  const gl::Grp<LP, G> g = gl::Grp<LP, G>::of_thread();
  const int q = threadIdx.x / G;
  uint32_t pp[M], one[M];
  load_part<L, LP, G>(g, C, pp);
  load_part<L, LP, G>(g, C + L, one);
  for (int w = 2; w <= W; w <<= 1) {
    const int h = w / 2, lo = 2 * W - 2 * w, hi = lo + w;
    if (w > T / G) {
      uint32_t first[L];
#pragma unroll 1
      for (int c = threadIdx.x; c < w; c += T) {
        const int sib = c < h ? c + h : c - h;
        uint32_t r[L], s[L];
        load_row<L>(tree + (hi + (c < h ? c : sib)) * RW, r);
        load_row<L>(tree + (lo + sib) * RW, s);
        one_if_zero<L>(s, K.one);
        gl::mont_mul<L, ND>(r, s, K.p, K.inv, s);
        load_row<L>(tree + (lo + c) * RW, r);
        if (gl::is_zero<L>(r)) gl::zero_limbs<L>(s);
        if (c == (int)threadIdx.x) {
#pragma unroll
          for (int j = 0; j < L; j++) first[j] = s[j];
        } else {
          store_row<L>(s, tree + (lo + c) * RW);
        }
      }
      __syncthreads();
      if ((int)threadIdx.x < w)
        store_row<L>(first, tree + (lo + threadIdx.x) * RW);
    } else {
      uint32_t o[M];
      if (q < w) {
        const int sib = q < h ? q + h : q - h;
        uint32_t r[M], s[M];
        load_part<L, LP, G>(g, tree + (hi + (q < h ? q : sib)) * RW, r);
        load_part<L, LP, G>(g, tree + (lo + sib) * RW, s);
        const bool sz = gl::grp_is_zero<LP, G>(g, s);
#pragma unroll
        for (int j = 0; j < M; j++) s[j] = sz ? one[j] : s[j];
        gl::grp_mont_mul<LP, G, ND>(g, r, s, pp, K.inv, o);
        load_part<L, LP, G>(g, tree + (lo + q) * RW, r);
        if (gl::grp_is_zero<LP, G>(g, r)) {
#pragma unroll
          for (int j = 0; j < M; j++) o[j] = 0;
        }
      }
      __syncthreads();
      if (q < w) store_part<L, LP, G>(g, o, tree + (lo + q) * RW);
    }
    __syncthreads();
  }
}

// Leaves 0 .. cnt-1 of the tree -> dense output rows base .. base+cnt-1.
template <int L, int ND>
__device__ __forceinline__ void unstage_leaves(const uint32_t* tree,
                                               long long* __restrict__ out,
                                               int base, int cnt) {
  for (int r = 0; r < cnt; r += T)
    gl::unstage_rows<L, T, ND>(tree + r * (L + 1), out, base + r,
                               min(T, cnt - r));
}

// C <- [p | one | R^3] in shared memory (visible after the caller's next
// __syncthreads).
template <int L>
__device__ __forceinline__ void stage_inv_consts(const InvConst<L>& K,
                                                 uint32_t* C) {
  if (threadIdx.x < L) {
    C[threadIdx.x] = K.p[threadIdx.x];
    C[L + threadIdx.x] = K.one[threadIdx.x];
    C[2 * L + threadIdx.x] = K.r3[threadIdx.x];
  }
}

template <int ND>
__global__ void __launch_bounds__(T, 2)
inv_up_kernel(const long long* __restrict__ x, uint32_t* __restrict__ scratch,
              long long* __restrict__ roots, int n,
              const InvConst<gl::limbs_of<ND>> K) {
  constexpr int L = gl::limbs_of<ND>, RW = L + 1, ROWS = 2 * B - 1;
  extern __shared__ uint32_t tree[];
  __shared__ uint32_t C[3 * L];
  stage_inv_consts<L>(K, C);
  const int base = blockIdx.x * B;
  stage_leaves<L, ND>(x, n, base, min(B, n - base), B, tree);
  sweep_up<ND>(tree, B, K, C);
  uint32_t* s = scratch + (size_t)blockIdx.x * ROWS * L;
  for (int k = threadIdx.x; k < ROWS * L; k += T) s[k] = tree[k + k / L];
  if (threadIdx.x < L) {
    const uint32_t w = tree[(ROWS - 1) * RW + threadIdx.x];
    long long* d = roots + (size_t)blockIdx.x * ND + 2 * threadIdx.x;
    if constexpr (ND == 2 * L) {
      *reinterpret_cast<longlong2*>(d) = make_longlong2(w & 0xFFFFu, w >> 16);
    } else {
      d[0] = w & 0xFFFFu;
      if (2 * (int)threadIdx.x + 1 < ND) d[1] = w >> 16;
    }
  }
}

template <int ND>
__global__ void __launch_bounds__(T, 2)
inv_down_kernel(const uint32_t* __restrict__ scratch,
                const long long* __restrict__ rinv,
                long long* __restrict__ out, int n,
                const InvConst<gl::limbs_of<ND>> K) {
  constexpr int L = gl::limbs_of<ND>, RW = L + 1, ROWS = 2 * B - 1;
  extern __shared__ uint32_t tree[];
  __shared__ uint32_t C[3 * L];
  stage_inv_consts<L>(K, C);
  const uint32_t* s = scratch + (size_t)blockIdx.x * ROWS * L;
  for (int k = threadIdx.x; k < (ROWS - 1) * L; k += T)
    gl::cp_async4(tree + k + k / L, s + k);
  gl::cp_async_commit();
  if (threadIdx.x < L) {
    const long long* d = rinv + (size_t)blockIdx.x * ND + 2 * threadIdx.x;
    uint32_t w = (uint32_t)d[0] & 0xFFFFu;
    if (2 * (int)threadIdx.x + 1 < ND) w |= (uint32_t)d[1] << 16;
    tree[(ROWS - 1) * RW + threadIdx.x] = w;
  }
  gl::cp_async_wait_all();
  __syncthreads();
  sweep_down<ND>(tree, B, K, C);
  const int base = blockIdx.x * B;
  unstage_leaves<L, ND>(tree, out, base, min(B, n - base));
}

template <int ND>
__global__ void __launch_bounds__(T, 1)
inv_tail_kernel(const long long* __restrict__ x, long long* __restrict__ out,
                int n, const InvConst<gl::limbs_of<ND>> K) {
  constexpr int L = gl::limbs_of<ND>, RW = L + 1;
  extern __shared__ uint32_t tree[];
  __shared__ uint32_t C[3 * L];
  stage_inv_consts<L>(K, C);
  int W = 1;
  while (W < n) W <<= 1;
  stage_leaves<L, ND>(x, n, 0, n, W, tree);
  sweep_up<ND>(tree, W, K, C);
  if (threadIdx.x == 0) {
    // the root aR: its plain inverse (aR)^-1, times R^3 / R, is a^-1 R.
    // (A one-leaf tree's root is its leaf, which may be zero: 0 -> 0.)
    uint32_t r[L];
    load_row<L>(tree + (2 * W - 2) * RW, r);
    gl::inv_divsteps<L>(r, C, K.inv, r);
    gl::mont_mul_mem<L, ND>(r, C + 2 * L, C, K.inv, r);
    store_row<L>(r, tree + (2 * W - 2) * RW);
  }
  __syncthreads();
  sweep_down<ND>(tree, W, K, C);
  unstage_leaves<L, ND>(tree, out, 0, n);
}

// Host side: the constants, and the kernel's dynamic shared memory opened
// to `bytes` on the current device (`opened`: what each device allows so
// far).
template <int L>
InvConst<L> make_const(const uint32_t* consts, uint32_t inv) {
  InvConst<L> K;
  memcpy(K.p, consts, sizeof(K.p));
  memcpy(K.r3, consts + L, sizeof(K.r3));
  memcpy(K.one, consts + 2 * L, sizeof(K.one));
  K.inv = inv;
  return K;
}

template <int ND>
int launch_up(const void* x, void* scratch, void* roots, int n,
              const uint32_t* consts, uint32_t inv, void* stream) {
  static int opened[gl::MAX_DEVICES] = {};
  const int bytes = 4 * tree_words<gl::limbs_of<ND>>(B);
  cudaError_t e = gl::open_smem(inv_up_kernel<ND>, bytes, opened);
  if (e != cudaSuccess) return (int)e;
  inv_up_kernel<ND><<<(n + B - 1) / B, T, bytes, (cudaStream_t)stream>>>(
      (const long long*)x, (uint32_t*)scratch, (long long*)roots, n,
      make_const<gl::limbs_of<ND>>(consts, inv));
  return (int)cudaGetLastError();
}

template <int ND>
int launch_down(const void* scratch, const void* rinv, void* out, int n,
                const uint32_t* consts, uint32_t inv, void* stream) {
  static int opened[gl::MAX_DEVICES] = {};
  const int bytes = 4 * tree_words<gl::limbs_of<ND>>(B);
  cudaError_t e = gl::open_smem(inv_down_kernel<ND>, bytes, opened);
  if (e != cudaSuccess) return (int)e;
  inv_down_kernel<ND><<<(n + B - 1) / B, T, bytes, (cudaStream_t)stream>>>(
      (const uint32_t*)scratch, (const long long*)rinv, (long long*)out, n,
      make_const<gl::limbs_of<ND>>(consts, inv));
  return (int)cudaGetLastError();
}

template <int ND>
int launch_tail(const void* x, void* out, int n, const uint32_t* consts,
                uint32_t inv, void* stream) {
  static int opened[gl::MAX_DEVICES] = {};
  int W = 1;
  while (W < n) W <<= 1;
  const int bytes = 4 * tree_words<gl::limbs_of<ND>>(W);
  cudaError_t e = gl::open_smem(inv_tail_kernel<ND>, bytes, opened);
  if (e != cudaSuccess) return (int)e;
  inv_tail_kernel<ND><<<1, T, bytes, (cudaStream_t)stream>>>(
      (const long long*)x, (long long*)out, n,
      make_const<gl::limbs_of<ND>>(consts, inv));
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point: nd digits an element; `tile` must be B (the wrapper's
// constant, checked here); consts: 3 ceil(nd/2) limbs [p | R^3 mod p |
// R mod p]; inv: -p^-1 mod 2^32.  Returns cudaGetLastError() of the launch
// (or the error of its set-up), -1 for a digit count that was not built, -2 for
// another tile or a batch the kernel does not take.

// x: dense [n, nd], n > 0; scratch: [ceil(n / B), 2B - 1, ceil(nd / 2)] 32-bit
// words, the tiles' trees; roots: dense [ceil(n / B), nd], the tiles'
// products.
extern "C" int gl_inv_tree_up(int nd, const void* x, void* scratch,
                              void* roots, int n, int tile,
                              const uint32_t* consts, uint32_t inv,
                              void* stream) {
  if (n <= 0) return 0;
  if (tile != B) return -2;
  switch (nd) {
    case 16: return launch_up<16>(x, scratch, roots, n, consts, inv, stream);
    case 19: return launch_up<19>(x, scratch, roots, n, consts, inv, stream);
    case 24: return launch_up<24>(x, scratch, roots, n, consts, inv, stream);
    case 48: return launch_up<48>(x, scratch, roots, n, consts, inv, stream);
    case 49: return launch_up<49>(x, scratch, roots, n, consts, inv, stream);
    default: return -1;
  }
}

// scratch: the trees of gl_inv_tree_up on a batch of n; rinv: dense
// [ceil(n / B), nd], the inverses of its roots; out: dense [n, nd], the
// inverses of the batch (zero where an element is zero).
extern "C" int gl_inv_tree_down(int nd, const void* scratch, const void* rinv,
                                void* out, int n, int tile,
                                const uint32_t* consts, uint32_t inv,
                                void* stream) {
  if (n <= 0) return 0;
  if (tile != B) return -2;
  switch (nd) {
    case 16: return launch_down<16>(scratch, rinv, out, n, consts, inv, stream);
    case 19: return launch_down<19>(scratch, rinv, out, n, consts, inv, stream);
    case 24: return launch_down<24>(scratch, rinv, out, n, consts, inv, stream);
    case 48: return launch_down<48>(scratch, rinv, out, n, consts, inv, stream);
    case 49: return launch_down<49>(scratch, rinv, out, n, consts, inv, stream);
    default: return -1;
  }
}

// x: dense [n, nd], 0 < n <= B; out: dense [n, nd], the inverses of x
// (zero where x is zero).
extern "C" int gl_inv_tree_tail(int nd, const void* x, void* out, int n,
                                int tile, const uint32_t* consts, uint32_t inv,
                                void* stream) {
  if (n <= 0) return 0;
  if (tile != B || n > B) return -2;
  switch (nd) {
    case 16: return launch_tail<16>(x, out, n, consts, inv, stream);
    case 19: return launch_tail<19>(x, out, n, consts, inv, stream);
    case 24: return launch_tail<24>(x, out, n, consts, inv, stream);
    case 48: return launch_tail<48>(x, out, n, consts, inv, stream);
    case 49: return launch_tail<49>(x, out, n, consts, inv, stream);
    default: return -1;
  }
}

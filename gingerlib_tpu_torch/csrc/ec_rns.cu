// K8: batched affine short-Weierstrass addition with RNS multiplies, the two
// kernels around its shared inversion:
//
//   pre :  (x1, y1, inf1), (x2, y2, inf2), positional Montgomery digits
//          ->  num, den, x1r, y1r, x2r (packed RNS rows), inf3, dead
//          flags from canonical digit equality; to-RNS of the four
//          coordinates (value v R) and one RNS multiply by
//          c_norm = M_A^2 R^-1 each (value v M_A); lambda's numerator and
//          denominator: (y2 - y1, x2 - x1), or (3 x1^2 + a, 2 y1) in a lane
//          that holds the same point twice; dead = inf3 | inf1 | inf2, the
//          lanes whose denominator must not join the inversion tree.
//   post:  num, 1/den (RNS, scale M_A), x1r, y1r, x2r, the operands and
//          the three flags  ->  x3, y3 (positional, canonical)
//          lambda, x3 = lambda^2 - x1 - x2, y3 = lambda (x1 - x3) - y1 in
//          RNS, subtractions offset by 4p and 12p; exit by one multiply by
//          k_out = R (value x3 R < 3p), CRT to digits, conditional
//          subtracts; a lane with one operand at infinity returns the
//          other, a lane with inf3 returns (0, 0).
//
// Between them the host inverts the denominators with an RNS product tree
// whose multiplies are K7 launches (rns_mont.cu) and whose root goes through
// the binary-Euclid kernel (K2): ops/ec_rns.py, tree_inverse_rns.
//
// Replaces _ecr_pre_kernel and _ecr_post_kernel (and, through K7,
// _ecr_tree_kernel) behind batch_affine_add_rns of
// gingerlib_tpu/ops/pallas_ec_rns.py (:127-252), with its formulas, scale
// constants and bound budget (lam, ll < 3p; x3 < 11p; x1 + 12p - x3 < 15p;
// every product below 45 p^2 << 2^10 p^2).  There the conversions are
// bf16-split matrix products on [128, lanes] tiles.  Here both kernels work
// on tiles of 16 lanes, one a block of 128 threads, on the core of
// rns_core.cuh, and every inner product runs on the integer tensor cores:
//   to-RNS: the tile's digits [16, nd] (bytes of 16-bit digits) times
//     |2^16j|_m [nd, 128];
//   CRT: the sigmas [16, k] times the digits of M_A/m_i [k, 64], less
//     alpha times the digits of M_A, as signed 64-bit digit columns;
// then one thread a coordinate of a lane resolves the columns' carries in
// one pass that also subtracts p, 2p and 3p beside them (three borrow
// chains), and a second pass takes the largest of the three that fits:
// the value mod p, for values below 4p, as the plain version's three
// conditional subtractions give it.  Post skips the arithmetic of a tile
// whose lanes are all selects; a select lane's digits are the select
// form's.  Pre fetches the tile's four digit rows by cp.async (16 bytes a
// copy); post fetches num and dinv the same way and reads x1r, y1r and
// x2r, each when it needs it, as 8-byte pairs.
//
// What bounds them on an H100: the bytes of the digit and residue rows
// and the channelwise 32-bit operations of their RNS multiplies (pre 4, or
// 5 where a lane doubles; post 5 a live lane); the conversions' byte
// products (4 x 16 x 64 x (128 or 64) a tile) take the tensor cores far
// below those.  chip_smoke.py computes the bounds and PERF.md holds the
// times.
#include <cuda_runtime.h>

#include "rns_core.cuh"

namespace {

using rns::STAGE_WORDS;
using rns::THREADS;
using rns::TILE;

// the curve's block: rows [EC_ROWS][128], digits of p, 2p, 3p [3][64],
// digits of M_A [64], then the fragments of the digits of M_A/m_i [64, 64]
// and of |2^16j|_m [64, 128]
enum EcRow { CNORM, KOUT, ARNS, P4, P12, EC_ROWS };
constexpr int KP = EC_ROWS * rns::LANES;
constexpr int MD = KP + 3 * 64;
constexpr int EC_HEAD = MD + 64;
constexpr int D_WORDS = rns::frag_words(rns::KMAX, 64);
constexpr int P2_WORDS = rns::frag_words(rns::KMAX, rns::LANES);
constexpr int COL_STRIDE = 65;   // odd: a tail's 16 rows hit 16 bank pairs

struct Coords4 {
  const long long* ptr[4];  // x1 y1 x2 y2
  long long stride[4];      // digits between consecutive rows
};

struct Flags3 {
  const unsigned char* ptr[3];  // inf1 inf2 (inf3), one byte a lane
  long long stride[3];
};

__device__ __forceinline__ bool flag(const Flags3& f, int i, int e) {
  return f.ptr[i][(size_t)e * f.stride[i]] != 0;
}

// The tile's digits (TILE rows of nd int64 digits at shared address `dig`,
// rs digits apart) -> the residues of their values: their byte planes,
// then the product with |2^16j|_m (fragments at `p2`, 128 columns).
__device__ __forceinline__ void to_rns(rns::Core& C, uint32_t dig, int rs,
                                       int nd, uint32_t p2, rns::Elem& out) {
  const uint32_t lo = rns::plane(C, C.buf, 0), hi = rns::plane(C, C.buf, 1);
  for (int i = threadIdx.x; i < TILE * rns::KMAX / 4; i += THREADS) {
    const int r = i / (rns::KMAX / 4), j0 = 4 * (i % (rns::KMAX / 4));
    uint32_t l = 0, h = 0;
#pragma unroll
    for (int b = 0; b < 4; b++) {
      const uint32_t d =
          j0 + b < nd ? rns::lds(dig + 8 * (r * rs + j0 + b)) : 0;
      l |= (d & 0xFF) << (8 * b);
      h |= (d >> 8 & 0xFF) << (8 * b);
    }
    rns::sts(lo + r * rns::PLANE_STRIDE + j0, l);
    rns::sts(hi + r * rns::PLANE_STRIDE + j0, h);
  }
  __syncthreads();
  const int ks = (nd + 31) / 32;
  rns::AFrag A;
  rns::load_a(C, ks, A);
#pragma unroll
  for (int h = 0; h < 2; h++) {
    uint64_t oa[4], ob[4];
    rns::product(C, A, p2, rns::LANES / 8, 2 * C.w + h, ks, oa);
    rns::product(C, A, p2, rns::LANES / 8, 8 + 2 * C.w + h, ks, ob);
#pragma unroll
    for (int b = 0; b < 2; b++) {
      const int q = 2 * h + b, c = rns::chan(C, q);
      const rns::Mod ma = rns::mod_at(C, c), mb = rns::mod_at(C, rns::B_ROW + c);
#pragma unroll
      for (int r = 0; r < 2; r++) {
        out.a[r][q] = rns::red64(oa[2 * r + b], ma);
        out.b[r][q] = rns::red64(ob[2 * r + b], mb);
      }
    }
  }
  C.buf ^= 1;
}

// residues of v (base A; value below 4p) -> the digit columns of the CRT,
// sum_i sigma_i D[i][j] - alpha MD[j] (exact alpha: offset), into cols
// [TILE][COL_STRIDE] (int64)
__device__ __forceinline__ void crt_cols(rns::Core& C, const rns::Elem& v,
                                         uint32_t dfrag, const uint32_t* md,
                                         long long* cols) {
  uint32_t sg[2][4], part[2] = {0, 0};
#pragma unroll
  for (int q = 0; q < 4; q++) {
    const int c = rns::chan(C, q);
    const rns::Mod m = rns::mod_at(C, c);
    const uint32_t sig = rns::rowv(C, rns::SIG, c), w = rns::rowv(C, rns::W, c);
#pragma unroll
    for (int r = 0; r < 2; r++) {
      sg[r][q] = rns::mulmod(v.a[r][q], sig, m);
      part[r] += sg[r][q] * w;
    }
  }
  rns::extend(C, sg, part, rns::ALPHA_OFF, dfrag,
              [&](int q, uint64_t acc0, uint64_t acc1, uint32_t al0,
                  uint32_t al1) {
                const int j = rns::chan(C, q);
                const long long mdj = md[j];
                cols[C.g * COL_STRIDE + j] = (long long)acc0 - al0 * mdj;
                cols[(C.g + 8) * COL_STRIDE + j] = (long long)acc1 - al1 * mdj;
              });
}

// One lane's digit columns -> the canonical digits of its value mod p
// (values below 4p): digits 0..nd of the value with the carries resolved,
// beside v - p, v - 2p and v - 3p (kp: their digits, 64 apart); then v - k p
// for the largest k whose subtraction does not borrow.
__device__ __forceinline__ void crt_tail(const long long* col,
                                         const uint32_t* kp, int nd,
                                         uint32_t* dig) {
  long long carry = 0;
  int b1 = 0, b2 = 0, b3 = 0;
  for (int j = 0; j <= nd; j++) {
    const long long s = col[j] + carry;
    const int d = (int)(s & 0xFFFF);
    carry = s >> 16;                  // arithmetic: a column may be negative
    dig[j] = (uint32_t)d;
    b1 = d - (int)kp[j] - b1 < 0;
    b2 = d - (int)kp[64 + j] - b2 < 0;
    b3 = d - (int)kp[128 + j] - b3 < 0;
  }
  const int k = 3 - b1 - b2 - b3;    // v >= k p exactly for k <= this
  if (k == 0) return;
  const uint32_t* sub = kp + 64 * (k - 1);
  int b = 0;
  for (int j = 0; j < nd; j++) {
    const int s = (int)dig[j] - (int)sub[j] - b;
    b = s < 0;
    dig[j] = (uint32_t)(s + (b << 16));
  }
}

// three blocks an SM, as many as their shared memory allows: registers up
// to 170 a thread
__global__ void __launch_bounds__(THREADS, 3)
ecr_pre_kernel(const Coords4 in, const Flags3 fl, int* __restrict__ num,
               int* __restrict__ den, int* __restrict__ x1r,
               int* __restrict__ y1r, int* __restrict__ x2r,
               unsigned char* __restrict__ inf3,
               unsigned char* __restrict__ dead, int n,
               const uint32_t* __restrict__ rc,
               const uint32_t* __restrict__ ec, int k, int nd) {
  extern __shared__ __align__(16) uint32_t sm[];
  uint32_t* E = sm + rns::CONST_WORDS;
  const int rs = nd + 2;                       // staged row: 16 bytes spare
  long long* stage = reinterpret_cast<long long*>(E + EC_HEAD + P2_WORDS);
  int* dbl_row = reinterpret_cast<int*>(stage + 4 * TILE * rs);
  uint32_t* work = reinterpret_cast<uint32_t*>(dbl_row + TILE);
  rns::stage(sm, rc, rns::CONST_WORDS);
  rns::stage(E, ec, EC_HEAD);
  rns::stage(E + EC_HEAD, ec + EC_HEAD + D_WORDS, P2_WORDS);
  rns::Core C = rns::core_at(sm, work, k);
  const uint32_t e_sm = rns::smem(E), p2 = e_sm + 4 * EC_HEAD,
                 st = rns::smem(stage);
  const int tiles = (n + TILE - 1) / TILE, chunks = nd / 2;
  const int tid = threadIdx.x;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int base = tile * TILE;
    for (int i = tid; i < 4 * TILE * chunks; i += THREADS) {
      const int c = i / (TILE * chunks), r = (i / chunks) % TILE,
                q = i % chunks, e = base + r;
      rns::cp_async16(stage + (c * TILE + r) * rs + 2 * q,
                      in.ptr[c] + (size_t)(e < n ? e : 0) * in.stride[c] +
                          2 * q,
                      e < n);
    }
    rns::cp_async_commit();
    rns::cp_async_wait_all();
    __syncthreads();
    // flags, eight threads a lane; canonical digits: equality of values is
    // equality of digits
    const int r8 = tid >> 3, part = tid & 7, e8 = base + r8;
    int ex = 1, ey = 1, yz = 1;
    for (int j = part; j < nd; j += 8) {
      const long long v1 = stage[r8 * rs + j], w1 = stage[(TILE + r8) * rs + j];
      const long long v2 = stage[(2 * TILE + r8) * rs + j],
                      w2 = stage[(3 * TILE + r8) * rs + j];
      ex &= v1 == v2;
      ey &= w1 == w2;
      yz &= w1 == 0;
    }
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) {
      ex &= __shfl_xor_sync(rns::FULL, ex, m);
      ey &= __shfl_xor_sync(rns::FULL, ey, m);
      yz &= __shfl_xor_sync(rns::FULL, yz, m);
    }
    bool dbl = false;
    if (part == 0) {
      const bool i1 = e8 < n ? flag(fl, 0, e8) : true;
      const bool i2 = e8 < n ? flag(fl, 1, e8) : true;
      const bool ninf = !i1 && !i2;
      dbl = ex && ey && ninf;
      const bool anti = ex && !ey && ninf;
      const bool f3 = (i1 && i2) || anti || (dbl && yz);
      dbl_row[r8] = dbl;
      if (e8 < n) {
        inf3[e8] = f3;
        dead[e8] = f3 || i1 || i2;
      }
    }
    const int any_dbl = __syncthreads_or(dbl);

    rns::Elem cn, r, xr[4];
    rns::row_elem(C, e_sm + 4 * CNORM * rns::LANES, cn);
#pragma unroll 1
    for (int c = 0; c < 4; c++) {
      to_rns(C, st + 8 * c * TILE * rs, rs, nd, p2, r);  // value v R
      rns::mont(C, r, cn, xr[c]);                       // value v M_A
    }
    rns::store_rows(C, x1r, base, n, xr[0]);
    rns::store_rows(C, y1r, base, n, xr[1]);
    rns::store_rows(C, x2r, base, n, xr[2]);
    rns::Elem p4, s, d;
    rns::row_elem(C, e_sm + 4 * P4 * rns::LANES, p4);
    rns::sub_off(C, xr[3], p4, xr[1], s);              // y2 - y1 < 7p
    rns::sub_off(C, xr[2], p4, xr[0], d);              // x2 - x1 < 7p
    if (any_dbl) {
      rns::Elem xx, t3;
      rns::mont(C, xr[0], xr[0], xx);                   // < 3p
      rns::add(C, xx, xx, t3);
      rns::add(C, t3, xx, t3);                          // < 9p
      rns::row_elem(C, e_sm + 4 * ARNS * rns::LANES, r);
      rns::add(C, t3, r, t3);                           // 3 x1^2 + a < 10p
      rns::add(C, xr[1], xr[1], xx);                    // 2 y1 < 6p
      const bool take[2] = {dbl_row[C.g] != 0, dbl_row[C.g + 8] != 0};
      rns::select(take, s, t3, s);
      rns::select(take, d, xx, d);
    }
    rns::store_rows(C, num, base, n, s);
    rns::store_rows(C, den, base, n, d);
  }
}

// three blocks an SM, as many as their shared memory allows: registers up
// to 170 a thread
__global__ void __launch_bounds__(THREADS, 3)
ecr_post_kernel(const int* __restrict__ num, const int* __restrict__ dinv,
                const int* __restrict__ x1r, const int* __restrict__ y1r,
                const int* __restrict__ x2r, const Coords4 in,
                const Flags3 fl, long long* __restrict__ x3,
                long long* __restrict__ y3, int n,
                const uint32_t* __restrict__ rc,
                const uint32_t* __restrict__ ec, int k, int nd) {
  extern __shared__ __align__(16) uint32_t sm[];
  uint32_t* E = sm + rns::CONST_WORDS;
  // num and dinv staged, later the CRT columns [2][TILE][COL_STRIDE]
  uint32_t* stage = E + EC_HEAD + D_WORDS;
  long long* cols = reinterpret_cast<long long*>(stage);
  uint32_t* dig = stage + 2 * TILE * STAGE_WORDS;   // [2][TILE][COL_STRIDE]
  int* sel = reinterpret_cast<int*>(dig + 2 * TILE * COL_STRIDE);
  uint32_t* work = reinterpret_cast<uint32_t*>(sel + TILE);
  rns::stage(sm, rc, rns::CONST_WORDS);
  rns::stage(E, ec, EC_HEAD + D_WORDS);
  rns::Core C = rns::core_at(sm, work, k);
  const uint32_t e_sm = rns::smem(E), dfrag = e_sm + 4 * EC_HEAD,
                 st = rns::smem(stage);
  const int tiles = (n + TILE - 1) / TILE;
  const int tid = threadIdx.x;
  long long* out[2] = {x3, y3};

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int base = tile * TILE;
    constexpr int CHUNKS = rns::LANES / 4;
    for (int i = tid; i < 2 * TILE * CHUNKS; i += THREADS) {
      const int o = i / (TILE * CHUNKS), r = (i / CHUNKS) % TILE,
                c = i % CHUNKS, e = base + r;
      rns::cp_async16(stage + (o * TILE + r) * STAGE_WORDS + 4 * c,
                      (o ? dinv : num) + (size_t)(e < n ? e : 0) * rns::LANES +
                          4 * c,
                      e < n);
    }
    rns::cp_async_commit();
    bool live = false;
    if (tid < TILE) {                 // bit 0: inf1, 1: inf2, 2: inf3
      const int e = base + tid;
      int s = 4;
      if (e < n)
        s = flag(fl, 0, e) | flag(fl, 1, e) << 1 | flag(fl, 2, e) << 2;
      sel[tid] = s;
      live = s == 0;
    }
    rns::cp_async_wait_all();
    if (__syncthreads_or(live)) {
      rns::Elem nm, di, lam, ll, a1, a2, x3r, y3r, off, tmp, v;
      rns::load_staged(C, st, nm);
      rns::load_staged(C, st + 4 * TILE * STAGE_WORDS, di);
      rns::mont(C, nm, di, lam);                      // lambda M_A < 3p
      rns::mont(C, lam, lam, ll);                     // < 3p
      rns::load_rows(C, x1r, base, n, a1);
      rns::load_rows(C, x2r, base, n, a2);
      rns::row_elem(C, e_sm + 4 * P4 * rns::LANES, off);
      rns::sub_off(C, ll, off, a1, tmp);
      rns::sub_off(C, tmp, off, a2, x3r);             // < 11p
      rns::row_elem(C, e_sm + 4 * P12 * rns::LANES, off);
      rns::sub_off(C, a1, off, x3r, tmp);             // < 15p
      rns::mont(C, lam, tmp, v);                      // < 3p
      rns::load_rows(C, y1r, base, n, a1);
      rns::row_elem(C, e_sm + 4 * P4 * rns::LANES, off);
      rns::sub_off(C, v, off, a1, y3r);               // < 7p
      rns::row_elem(C, e_sm + 4 * KOUT * rns::LANES, off);
#pragma unroll 1
      for (int c = 0; c < 2; c++) {                   // value R < 3p, CRT
        rns::mont(C, c ? y3r : x3r, off, v);
        crt_cols(C, v, dfrag, E + MD, cols + c * TILE * COL_STRIDE);
      }
      __syncthreads();
      if (tid < 2 * TILE)
        crt_tail(cols + tid * COL_STRIDE, E + KP, nd, dig + tid * COL_STRIDE);
    }
    __syncthreads();
    // the results, selects and all, consecutive threads on consecutive
    // digits of a row
    for (int i = tid; i < 2 * TILE * nd; i += THREADS) {
      const int c = i / (TILE * nd), r = (i / nd) % TILE, j = i % nd;
      const int e = base + r;
      if (e >= n) continue;
      const int s = sel[r];
      long long v;
      if (s & 4)
        v = 0;                        // inf3 -> 0
      else if (s & 3)                 // inf1 -> (x2, y2), inf2 -> (x1, y1)
        v = in.ptr[(s & 1 ? 2 : 0) + c]
                  [(size_t)e * in.stride[(s & 1 ? 2 : 0) + c] + j];
      else
        v = dig[(c * TILE + r) * COL_STRIDE + j];
      out[c][(size_t)e * nd + j] = v;
    }
    __syncthreads();                  // sel, dig and the stage are reused
  }
}

// Sets the kernel's shared memory limit and returns the blocks of a
// persistent grid over `tiles` tiles: as many as fit on the card.
cudaError_t grid(const void* kernel, size_t smem, int tiles, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  *blocks = tiles < resident ? tiles : resident;
  return e;
}

Coords4 make_coords(const void* const* in, const long long* stride) {
  Coords4 c;
  for (int i = 0; i < 4; i++) {
    c.ptr[i] = (const long long*)in[i];
    c.stride[i] = stride[i];
  }
  return c;
}

Flags3 make_flags(const void* const* flags, const long long* stride,
                  int count) {
  Flags3 f;
  for (int i = 0; i < 3; i++) {
    f.ptr[i] = (const unsigned char*)flags[i < count ? i : 0];
    f.stride[i] = stride[i < count ? i : 0];
  }
  return f;
}

bool widths_ok(int k, int nd) {
  return k >= 1 && k <= rns::B_ROW && (nd == 24 || nd == 48);
}

}  // namespace

// in: four row pointers x1 y1 x2 y2 ([.., nd] int64 digits, rows 16-byte
// aligned) with row strides in digits; flags: bool bytes inf1 inf2 with
// strides in bytes; num, den, x1r, y1r, x2r: dense [n, 128] int32 outputs;
// inf3, dead: [n] bool outputs; rns_consts: the block of rns_core.cuh;
// ec_consts: the curve's block (rows, digits of p, 2p, 3p and M_A, the
// fragments of the CRT and to-RNS matrices).  Returns the CUDA error of
// the set-up or the launch, or -1 for widths the kernels are not built for.
extern "C" int gl_ecr_pre(int k, int nd, const void* const* in,
                          const long long* in_stride,
                          const void* const* flags,
                          const long long* flag_stride, void* num, void* den,
                          void* x1r, void* y1r, void* x2r, void* inf3,
                          void* dead, int n, const void* rns_consts,
                          const void* ec_consts, void* stream) {
  if (n <= 0) return 0;
  if (!widths_ok(k, nd)) return -1;
  const size_t smem = (rns::CONST_WORDS + EC_HEAD + P2_WORDS +
                       2 * 4 * TILE * (nd + 2) + TILE + rns::WORK_WORDS) *
                      sizeof(uint32_t);
  int blocks = 0;
  cudaError_t e = grid((const void*)ecr_pre_kernel, smem,
                       (n + TILE - 1) / TILE, &blocks);
  if (e != cudaSuccess) return (int)e;
  ecr_pre_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      make_coords(in, in_stride), make_flags(flags, flag_stride, 2),
      (int*)num, (int*)den, (int*)x1r, (int*)y1r, (int*)x2r,
      (unsigned char*)inf3, (unsigned char*)dead, n,
      (const uint32_t*)rns_consts, (const uint32_t*)ec_consts, k, nd);
  return (int)cudaGetLastError();
}

// num, dinv, x1r, y1r, x2r: dense [n, 128] int32 residues, 16-byte
// aligned; in as above; flags: inf1 inf2 inf3; x3, y3: dense [n, nd] int64
// outputs; wdt: digit columns of the CRT (ops/rns.py crt_width), at most
// 64.  Returns as above, or -2 for a CRT width the columns cannot hold.
extern "C" int gl_ecr_post(int k, int nd, int wdt, const void* num,
                           const void* dinv, const void* x1r,
                           const void* y1r, const void* x2r,
                           const void* const* in, const long long* in_stride,
                           const void* const* flags,
                           const long long* flag_stride, void* x3, void* y3,
                           int n, const void* rns_consts,
                           const void* ec_consts, void* stream) {
  if (n <= 0) return 0;
  if (!widths_ok(k, nd)) return -1;
  if (wdt > rns::KMAX || wdt < nd + 1) return -2;
  const size_t smem = (rns::CONST_WORDS + EC_HEAD + D_WORDS +
                       2 * TILE * STAGE_WORDS + 2 * TILE * COL_STRIDE + TILE +
                       rns::WORK_WORDS) *
                      sizeof(uint32_t);
  int blocks = 0;
  cudaError_t e = grid((const void*)ecr_post_kernel, smem,
                       (n + TILE - 1) / TILE, &blocks);
  if (e != cudaSuccess) return (int)e;
  ecr_post_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)num, (const int*)dinv, (const int*)x1r, (const int*)y1r,
      (const int*)x2r, make_coords(in, in_stride),
      make_flags(flags, flag_stride, 3), (long long*)x3, (long long*)y3, n,
      (const uint32_t*)rns_consts, (const uint32_t*)ec_consts, k, nd);
  return (int)cudaGetLastError();
}

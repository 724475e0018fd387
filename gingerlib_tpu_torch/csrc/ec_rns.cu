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
// bf16-split matrix products on [128, lanes] tiles; here one warp owns one
// lane as in rns_core.cuh: to-RNS is a 64-bit inner product of the nd
// digits with |2^16j|_m a channel, the CRT an inner product of the k sigmas
// with the digits of M_A/m_i a digit column, then one lane resolves the
// carries and subtracts p.  Post skips the arithmetic of a lane whose result
// is a select (a warp-uniform branch); its digits are the select form's.
//
// What bounds them on an H100: the integer multiply-adds of their RNS
// multiplies (pre 5, post 5 a live lane, 2 k^2 + 10 k each) and of the
// conversions (pre 4 nd x 2k, post 2 k x wdt); chip_smoke.py computes the
// bounds and PERF.md holds the times.
#include <cuda_runtime.h>

#include "rns_core.cuh"

namespace {

constexpr int WARPS = 8;
// the curve's block, after its rows [EC_ROWS][128]: pd [64] digits of p,
// md [64] digits of M_A, p2 [nd][128] |2^16j|_m, d [k][64] digits of M_A/m_i
enum EcRow { CNORM, KOUT, ARNS, P4, P12, EC_ROWS };
constexpr int EC_HEAD = EC_ROWS * rns::LANES + 2 * 64;
constexpr int PRE_SCRATCH = 5 * 64;    // sig, then four digit rows
constexpr int POST_SCRATCH = 4 * 64;   // col (64-bit, 128 words), sig, dig

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

__global__ void __launch_bounds__(WARPS * 32)
ecr_pre_kernel(const Coords4 in, const Flags3 fl, int* __restrict__ num,
               int* __restrict__ den, int* __restrict__ x1r,
               int* __restrict__ y1r, int* __restrict__ x2r,
               unsigned char* __restrict__ inf3,
               unsigned char* __restrict__ dead, int n,
               const uint32_t* __restrict__ rc,
               const uint32_t* __restrict__ ec, int k, int nd) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int rw = rns::const_words(k);
  const int ew = EC_HEAD + nd * rns::LANES;     // rows, pd, md, p2
  rns::stage(sm, rc, rw);
  rns::stage(sm + rw, ec, ew);
  uint32_t* sig = sm + rw + ew + (threadIdx.x / 32) * PRE_SCRATCH;
  uint32_t* dig = sig + 64;
  __syncthreads();
  const rns::Consts K = rns::consts_at(sm, k);
  const uint32_t* E = sm + rw;
  const uint32_t* p2 = E + EC_HEAD;
  const int t = rns::lane_id();

  for (int e = blockIdx.x * WARPS + threadIdx.x / 32; e < n;
       e += gridDim.x * WARPS) {
    bool ex = true, ey = true, yz = true;
    for (int j = t; j < nd; j += 32) {
      uint32_t v[4];
#pragma unroll
      for (int c = 0; c < 4; c++) {
        v[c] = (uint32_t)in.ptr[c][(size_t)e * in.stride[c] + j];
        dig[c * 64 + j] = v[c];
      }
      ex &= v[0] == v[2];
      ey &= v[1] == v[3];
      yz &= v[1] == 0;
    }
    // canonical digits: equality of values is equality of digits
    const bool same_x = __all_sync(rns::FULL, ex);
    const bool same_y = __all_sync(rns::FULL, ey);
    const bool y1z = __all_sync(rns::FULL, yz);
    const bool i1 = flag(fl, 0, e), i2 = flag(fl, 1, e);
    const bool ninf = !i1 && !i2;
    const bool dbl = same_x && same_y && ninf;
    const bool anti = same_x && !same_y && ninf;
    const bool f3 = (i1 && i2) || anti || (dbl && y1z);
    __syncwarp();

    rns::Elem cn, r, xr[4];
    rns::row_elem(E + CNORM * rns::LANES, cn);
#pragma unroll 1
    for (int c = 0; c < 4; c++) {
      rns::to_rns(K, dig + c * 64, p2, nd, r);     // value v R
      rns::mont(K, sig, r, cn, xr[c]);              // value v M_A
    }
    rns::Elem p4, d, xx, s;
    rns::row_elem(E + P4 * rns::LANES, p4);
    if (dbl) {
      rns::mont(K, sig, xr[0], xr[0], xx);          // < 3p
      rns::add(K, xx, xx, s);
      rns::add(K, s, xx, s);                        // < 9p
      rns::row_elem(E + ARNS * rns::LANES, r);
      rns::add(K, s, r, s);                         // 3 x1^2 + a < 10p
      rns::add(K, xr[1], xr[1], d);                 // 2 y1 < 6p
    } else {
      rns::sub_off(K, xr[3], p4, xr[1], s);         // y2 - y1 < 7p
      rns::sub_off(K, xr[2], p4, xr[0], d);         // x2 - x1 < 7p
    }
    const size_t o = (size_t)e * rns::LANES;
    rns::store_elem(num + o, s);
    rns::store_elem(den + o, d);
    rns::store_elem(x1r + o, xr[0]);
    rns::store_elem(y1r + o, xr[1]);
    rns::store_elem(x2r + o, xr[2]);
    if (t == 0) {
      inf3[e] = f3;
      dead[e] = f3 || i1 || i2;
    }
    __syncwarp();                                   // dig is reused
  }
}

__global__ void __launch_bounds__(WARPS * 32)
ecr_post_kernel(const int* __restrict__ num, const int* __restrict__ dinv,
                const int* __restrict__ x1r, const int* __restrict__ y1r,
                const int* __restrict__ x2r, const Coords4 in,
                const Flags3 fl, long long* __restrict__ x3,
                long long* __restrict__ y3, int n,
                const uint32_t* __restrict__ rc,
                const uint32_t* __restrict__ ec, int k, int nd, int wdt) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int rw = rns::const_words(k);
  const int dw = k * 64;
  rns::stage(sm, rc, rw);
  rns::stage(sm + rw, ec, EC_HEAD);                 // rows, pd, md
  rns::stage(sm + rw + EC_HEAD, ec + EC_HEAD + nd * rns::LANES, dw);
  // every offset so far is even: the 64-bit scratch row is aligned
  uint32_t* scratch = sm + rw + EC_HEAD + dw +
                      (threadIdx.x / 32) * POST_SCRATCH;
  long long* col = reinterpret_cast<long long*>(scratch);
  uint32_t* sig = scratch + 128;
  uint32_t* dig = sig + 64;
  __syncthreads();
  const rns::Consts K = rns::consts_at(sm, k);
  const uint32_t* E = sm + rw;
  const uint32_t* pd = E + EC_ROWS * rns::LANES;
  const uint32_t* md = pd + 64;
  const uint32_t* d = E + EC_HEAD;
  const int t = rns::lane_id();

  for (int e = blockIdx.x * WARPS + threadIdx.x / 32; e < n;
       e += gridDim.x * WARPS) {
    const bool i1 = flag(fl, 0, e), i2 = flag(fl, 1, e), i3 = flag(fl, 2, e);
    long long* out[2] = {x3 + (size_t)e * nd, y3 + (size_t)e * nd};
    if (i1 || i2 || i3) {           // the result is a select: inf3 -> 0,
      for (int c = 0; c < 2; c++) { // inf1 -> (x2, y2), inf2 -> (x1, y1)
        const int src = (i1 ? 2 : 0) + c;
        const long long* row = in.ptr[src] + (size_t)e * in.stride[src];
        for (int j = t; j < nd; j += 32) out[c][j] = i3 ? 0 : row[j];
      }
      continue;
    }
    const size_t o = (size_t)e * rns::LANES;
    rns::Elem nm, di, a1, b1, a2, lam, ll, x3r, y3r, off, tmp, v;
    rns::load_elem(num + o, nm);
    rns::load_elem(dinv + o, di);
    rns::load_elem(x1r + o, a1);
    rns::load_elem(y1r + o, b1);
    rns::load_elem(x2r + o, a2);
    rns::mont(K, sig, nm, di, lam);                 // lambda M_A < 3p
    rns::mont(K, sig, lam, lam, ll);                // < 3p
    rns::row_elem(E + P4 * rns::LANES, off);
    rns::sub_off(K, ll, off, a1, tmp);
    rns::sub_off(K, tmp, off, a2, x3r);             // < 11p
    rns::row_elem(E + P12 * rns::LANES, off);
    rns::sub_off(K, a1, off, x3r, tmp);             // < 15p
    rns::mont(K, sig, lam, tmp, v);                 // < 3p
    rns::row_elem(E + P4 * rns::LANES, off);
    rns::sub_off(K, v, off, b1, y3r);               // < 7p
    rns::row_elem(E + KOUT * rns::LANES, off);
#pragma unroll 1
    for (int c = 0; c < 2; c++) {
      rns::mont(K, sig, c == 0 ? x3r : y3r, off, v);  // value R < 3p
      rns::from_rns(K, sig, col, dig, v, d, md, pd, wdt, nd);
      for (int j = t; j < nd; j += 32) out[c][j] = dig[j];
      __syncwarp();
    }
  }
}

int smem_limit(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int grid(const void* kernel, int n, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32,
                                                smem);
  int blocks = (n + WARPS - 1) / WARPS;
  int resident = (per_sm > 0 ? per_sm : 1) * sms;
  return blocks < resident ? blocks : resident;
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

// in: four row pointers x1 y1 x2 y2 ([.., nd] int64 digits) with row strides
// in digits; flags: bool bytes inf1 inf2 with strides in bytes; num, den,
// x1r, y1r, x2r: dense [n, 128] int32 outputs; inf3, dead: [n] bool
// outputs; rns_consts: the block of rns_core.cuh; ec_consts: the curve's
// block (EC rows, pd, md, p2, d).  Returns cudaGetLastError() of the
// launch, or -1 for widths the kernels are not built for.
extern "C" int gl_ecr_pre(int k, int nd, const void* const* in,
                          const long long* in_stride,
                          const void* const* flags,
                          const long long* flag_stride, void* num, void* den,
                          void* x1r, void* y1r, void* x2r, void* inf3,
                          void* dead, int n, const void* rns_consts,
                          const void* ec_consts, void* stream) {
  if (n <= 0) return 0;
  if (!widths_ok(k, nd)) return -1;
  size_t smem = (rns::const_words(k) + EC_HEAD + nd * rns::LANES +
                 WARPS * PRE_SCRATCH) * sizeof(uint32_t);
  int rc = smem_limit((const void*)ecr_pre_kernel, smem);
  if (rc) return rc;
  ecr_pre_kernel<<<grid((const void*)ecr_pre_kernel, n, smem), WARPS * 32,
                   smem, (cudaStream_t)stream>>>(
      make_coords(in, in_stride), make_flags(flags, flag_stride, 2),
      (int*)num, (int*)den, (int*)x1r, (int*)y1r, (int*)x2r,
      (unsigned char*)inf3, (unsigned char*)dead, n,
      (const uint32_t*)rns_consts, (const uint32_t*)ec_consts, k, nd);
  return (int)cudaGetLastError();
}

// num, dinv, x1r, y1r, x2r: dense [n, 128] int32 residues; in as above;
// flags: inf1 inf2 inf3; x3, y3: dense [n, nd] int64 outputs; wdt: digit
// columns of the CRT (ops/rns.py crt_width), at most 64.  Returns as above,
// or -2 for a CRT width the scratch rows cannot hold.
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
  if (wdt > 64 || wdt < nd + 1) return -2;
  size_t smem = (rns::const_words(k) + EC_HEAD + k * 64 +
                 WARPS * POST_SCRATCH) * sizeof(uint32_t);
  int rc = smem_limit((const void*)ecr_post_kernel, smem);
  if (rc) return rc;
  ecr_post_kernel<<<grid((const void*)ecr_post_kernel, n, smem), WARPS * 32,
                    smem, (cudaStream_t)stream>>>(
      (const int*)num, (const int*)dinv, (const int*)x1r, (const int*)y1r,
      (const int*)x2r, make_coords(in, in_stride),
      make_flags(flags, flag_stride, 3), (long long*)x3, (long long*)y3, n,
      (const uint32_t*)rns_consts, (const uint32_t*)ec_consts, k, nd, wdt);
  return (int)cudaGetLastError();
}

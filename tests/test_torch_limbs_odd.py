"""The limb code of the port's kernels at odd digit counts (19: MNT6-298, 49:
SW6), compiled for the host with g++ and held to python ints:

    python -m pytest tests/test_torch_limbs_odd.py -q

At an odd ``n_digits`` an element is ceil(nd / 2) 32-bit limbs with the top
one half full, and R stays 2^(16 nd): the Montgomery multiply's last row
reduces by 16 bits.  The program below includes ``csrc/fp_limbs.cuh`` and
``csrc/fp_group.cuh`` -- the sources nvcc builds for the card -- over a small
stand-in for ``cuda_runtime.h`` (``SHIM``: the CUDA keywords defined away,
each CUDA thread a ``std::thread``, shuffles and ballots exchanged through
a buffer between barriers).  It runs

* ``gl::mont_mul<L, ND>`` (one thread an element: K1, K5, K6) and
  ``gl::grp_mont_mul<LP, G, ND>`` (a group of G threads, the limbs padded
  to LP, a multiple of G: K4 and K6's narrow levels) on the same operands;
* ``load_digits`` / ``store_digits`` (K2) and the group's ``grp_load`` /
  ``grp_store`` on rows at odd digit offsets, between sentinels;
* ``fetched_limbs`` and ``unstage_rows`` (the tile loop of K1 and add/sub,
  K5, K6): a tile's packed rows written out as exactly nd digits a row.

Each product must be a * b * R^-1 mod p for R = 2^(16 nd), at 0, 1, p - 1,
seeded values and one operand up to R - 1; each store must write the nd
digits and nothing beside them.  Integer arithmetic: tolerance 0.  The even
widths the kernels are built for (24 and 48 digits) run beside, as a check
of the program itself.  Skips only where g++ is missing.
"""

import random
import shutil
import subprocess

import pytest

from gingerlib_tpu_torch import params as PP
from gingerlib_tpu_torch.ops import cuda_lib

# (field, group size G, padded limbs LP) as the kernels take them:
# ec_add.cu's group_size and inv_tree.cu's GROUP
WIDTHS = {
    "mnt6298_fq": (PP.MNT6298_FQ, 4, 12),
    "sw6_fq": (PP.SW6_FQ, 8, 32),
    "bls12_377_fq": (PP.BLS12_377_FQ, 4, 12),
    "mnt4753_fq": (PP.MNT4753_FQ, 8, 24),
}

SHIM = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <stdint.h>
#include <string.h>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __shared__ static

struct longlong2 { long long x, y; };
inline longlong2 make_longlong2(long long x, long long y) { return {x, y}; }
struct uint3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local uint3_ threadIdx, blockIdx;
inline uint3_ blockDim, gridDim;
using std::min;

typedef int cudaError_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidDevice = 101;
constexpr int cudaDevAttrMultiProcessorCount = 16;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaGetLastError() { return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
template <class K> int cudaFuncSetAttribute(K, int, int) { return 0; }
template <class K>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, K, int, int) {
  *v = 1;
  return 0;
}
inline unsigned __cvta_generic_to_shared(const void*) { return 0; }

// The threads of one emulated warp: lanes 0 .. n-1, each a std::thread.
namespace shim {
inline std::barrier<>* bar = nullptr;
inline uint32_t slot[32];
inline int lanes = 0;
inline void sync() { bar->arrive_and_wait(); }
inline uint32_t exchange(uint32_t v, int src) {
  slot[threadIdx.x & 31] = v;
  sync();
  uint32_t w = slot[src];
  sync();
  return w;
}
// f(lane) on n threads, threadIdx.x = lane
template <class F>
void run(int n, F f) {
  std::barrier<> b(n);
  bar = &b;
  lanes = n;
  std::vector<std::thread> ts;
  for (int t = 0; t < n; t++)
    ts.emplace_back([&, t] { threadIdx.x = t; f(t); });
  for (auto& t : ts) t.join();
  bar = nullptr;
}
}  // namespace shim

inline void __syncthreads() { shim::sync(); }
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src, int width) {
  int lane = threadIdx.x & 31;
  return shim::exchange(v, (lane & ~(width - 1)) + (src & (width - 1)));
}
inline uint32_t __shfl_down_sync(unsigned, uint32_t v, unsigned d, int width) {
  int lane = threadIdx.x & 31, seg = lane & ~(width - 1);
  int src = lane + (int)d;
  return shim::exchange(v, src < seg + width ? src : lane);
}
inline uint32_t __shfl_up_sync(unsigned, uint32_t v, unsigned d, int width) {
  int lane = threadIdx.x & 31, seg = lane & ~(width - 1);
  int src = lane - (int)d;
  return shim::exchange(v, src >= seg ? src : lane);
}
inline uint32_t __ballot_sync(unsigned, int pred) {
  shim::slot[threadIdx.x & 31] = pred ? 1u : 0u;
  shim::sync();
  uint32_t bits = 0;
  for (int k = 0; k < shim::lanes; k++) bits |= shim::slot[k] << k;
  shim::sync();
  return bits;
}
"""

# Commands on stdin, hex words low first; answers on stdout, one a line.
#   mul ND n | p (L words) inv | n x (a, b)  ->  n x "one-thread | group"
#   io ND off | ND digits  ->  load_digits and grp_load limbs, then the
#       buffers store_digits and grp_store wrote, sentinels -1 around
#   tile ND cnt | cnt x L words  ->  the buffer unstage_rows wrote
DRIVER = r"""
#include <stdio.h>
#include "cuda_runtime.h"
#include "fp_group.cuh"

template <int ND, int G, int LP>
struct W {
  static constexpr int L = gl::limbs_of<ND>;
  static constexpr int M = LP / G;

  static void read(uint32_t* x, int n) {
    for (int i = 0; i < n; i++) scanf("%x", &x[i]);
  }
  static void print(const uint32_t* x, int n) {
    for (int i = 0; i < n; i++) printf(" %x", x[i]);
  }

  static void mul(int n) {
    uint32_t p[L], inv, pp[LP] = {};
    read(p, L);
    scanf("%x", &inv);
    memcpy(pp, p, sizeof(p));
    for (int k = 0; k < n; k++) {
      uint32_t a[L], b[L], r[L], ga[LP] = {}, gb[LP] = {}, gr[LP] = {};
      read(a, L);
      read(b, L);
      gl::mont_mul<L, ND>(a, b, p, inv, r);
      memcpy(ga, a, sizeof(a));
      memcpy(gb, b, sizeof(b));
      shim::run(G, [&](int t) {
        using Grp = gl::Grp<LP, G>;
        const Grp g = Grp::of_thread();
        uint32_t x[M], y[M], q[M], o[M];
        for (int j = 0; j < M; j++) {
          x[j] = ga[t * M + j];
          y[j] = gb[t * M + j];
          q[j] = pp[t * M + j];
        }
        gl::grp_mont_mul<LP, G, ND>(g, x, y, q, inv, o);
        for (int j = 0; j < M; j++) gr[t * M + j] = o[j];
      });
      print(r, L);
      printf(" |");
      print(gr, LP);
      printf("\n");
    }
  }

  static void io(int off) {
    long long src[3 * ND], dst[3 * ND], gdst[3 * ND];
    for (int i = 0; i < 3 * ND; i++) src[i] = dst[i] = gdst[i] = -1;
    for (int i = 0; i < ND; i++) scanf("%llx", &src[off + i]);
    uint32_t x[L], gx[LP] = {};
    gl::load_digits<L, ND>(src + off, x);
    gl::store_digits<L, ND>(dst + off, x);
    shim::run(G, [&](int t) {
      using Grp = gl::Grp<LP, G>;
      const Grp g = Grp::of_thread();
      uint32_t part[M];
      gl::grp_load<LP, G, ND>(g, src + off, part);
      for (int j = 0; j < M; j++) gx[t * M + j] = part[j];
      gl::grp_store<LP, G, ND>(g, gdst + off, part);
    });
    print(x, L);
    printf(" |");
    print(gx, LP);
    printf(" |");
    for (int i = 0; i < 3 * ND; i++) printf(" %llx", dst[i]);
    printf(" |");
    for (int i = 0; i < 3 * ND; i++) printf(" %llx", gdst[i]);
    printf("\n");
  }

  static void tile(int cnt) {
    constexpr int T = 32;
    std::vector<uint32_t> s(cnt * (L + 1), 0xDEADBEEFu), f(2 * L + 1, 0);
    for (int r = 0; r < cnt; r++) read(&s[r * (L + 1)], L);
    std::vector<long long> out((cnt + 2) * ND, -1);
    // the threads of a block in turn: unstage_rows has no barrier
    for (int t = 0; t < T; t++) {
      threadIdx.x = t;
      gl::unstage_rows<L, T, ND>(s.data(), out.data(), 1, cnt);
    }
    // row 0 as a fetched row (the low words of its digits), read back
    for (int d = 0; d < ND; d++) f[d] = (uint32_t)out[ND + d];
    f[ND] = 0xFFFFFFFFu;  // an odd ND leaves the row's last word unread
    uint32_t x[L];
    gl::fetched_limbs<L, ND>(f.data(), x);
    for (long long v : out) printf(" %llx", v);
    printf(" |");
    print(x, L);
    printf("\n");
  }
};

template <class X>
int dispatch(const char* cmd, int arg) {
  if (!strcmp(cmd, "mul")) X::mul(arg);
  else if (!strcmp(cmd, "io")) X::io(arg);
  else if (!strcmp(cmd, "tile")) X::tile(arg);
  else return 1;
  return 0;
}

int main() {
  char cmd[8];
  int nd, arg;
  while (scanf("%7s %d %d", cmd, &nd, &arg) == 3) {
    int rc = nd == 19 ? dispatch<W<19, 4, 12>>(cmd, arg)
           : nd == 49 ? dispatch<W<49, 8, 32>>(cmd, arg)
           : nd == 24 ? dispatch<W<24, 4, 12>>(cmd, arg)
           : nd == 48 ? dispatch<W<48, 8, 24>>(cmd, arg) : 2;
    if (rc) return rc;
    fflush(stdout);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/fp_limbs.cuh for the host")
    d = tmp_path_factory.mktemp("fp_limbs")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "driver.cpp").write_text(DRIVER)
    exe = d / "driver"
    subprocess.run([gxx, "-O1", "-std=c++20", "-pthread", "-I", str(d), "-I",
                    cuda_lib.CSRC, str(d / "driver.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, text=True)
    return str(exe)


def run(exe, text: str) -> list:
    return subprocess.run([exe], input=text, capture_output=True, text=True,
                          check=True).stdout.splitlines()


def words(v: int, n: int) -> str:
    return " ".join(f"{(v >> 32 * i) & 0xFFFFFFFF:x}" for i in range(n))


def value(ws) -> int:
    return sum(int(w, 16) << 32 * i for i, w in enumerate(ws))


@pytest.mark.parametrize("name", list(WIDTHS))
def test_mont_mul_one_thread_and_group_at_r_of_the_digits(driver, name):
    F, _, _ = WIDTHS[name]
    p, nd = F.modulus, F.n_digits
    L = (nd + 1) // 2
    R = 1 << (16 * nd)
    rng = random.Random(nd)
    edge = [0, 1, 2, p - 1, (p - 1) // 2]
    pairs = [(a, b) for a in edge for b in edge]
    pairs += [(rng.randrange(p), rng.randrange(p)) for _ in range(40)]
    # one operand below R only, as from_mont and lazy sums give the kernels
    pairs += [(R - 1, p - 1), (R - 1, rng.randrange(p)),
              (rng.randrange(p, R), rng.randrange(p))]
    text = f"mul {nd} {len(pairs)} {words(p, L)} {F.inv32:x}\n"
    text += "\n".join(f"{words(a, L)} {words(b, L)}" for a, b in pairs)
    out = run(driver, text + "\n")
    assert len(out) == len(pairs)
    r_inv = pow(R, -1, p)
    for (a, b), line in zip(pairs, out):
        one, grp = line.split("|")
        want = a * b * r_inv % p
        assert value(one.split()) == want, (hex(a), hex(b))
        assert value(grp.split()) == want, (hex(a), hex(b))


# rows at odd digit offsets exist only at odd widths (even rows are
# 16-byte aligned)
@pytest.mark.parametrize("name,off", [
    (name, off) for name, (F, _, _) in WIDTHS.items()
    for off in ((0, 1, 3) if F.n_digits % 2 else (0, 2))])
def test_loads_and_stores_touch_exactly_the_digits(driver, name, off):
    F, _, lp = WIDTHS[name]
    nd = F.n_digits
    L = (nd + 1) // 2
    v = random.Random(off * 97 + nd).randrange(F.modulus)
    dig = [(v >> 16 * i) & 0xFFFF for i in range(nd)]
    out = run(driver, f"io {nd} {off} " + " ".join(f"{d:x}" for d in dig)
              + "\n")
    x, gx, dst, gdst = out[0].split("|")
    assert value(x.split()) == v and len(x.split()) == L
    assert value(gx.split()) == v and len(gx.split()) == lp
    want = ["ffffffffffffffff"] * (3 * nd)
    want[off:off + nd] = [f"{d:x}" for d in dig]
    assert dst.split() == want
    assert gdst.split() == want


@pytest.mark.parametrize("cnt", [1, 2, 5])
@pytest.mark.parametrize("name", list(WIDTHS))
def test_unstaged_rows_are_nd_digits_each(driver, name, cnt):
    F, _, _ = WIDTHS[name]
    nd = F.n_digits
    L = (nd + 1) // 2
    rng = random.Random(cnt * 31 + nd)
    vals = [rng.randrange(F.modulus) for _ in range(cnt)]
    text = f"tile {nd} {cnt} " + " ".join(words(v, L) for v in vals)
    out, fetched = run(driver, text + "\n")[0].split("|")
    want = ["ffffffffffffffff"] * ((cnt + 2) * nd)
    for r, v in enumerate(vals):
        want[(1 + r) * nd:(2 + r) * nd] = [
            f"{(v >> 16 * i) & 0xFFFF:x}" for i in range(nd)]
    assert out.split() == want
    assert value(fetched.split()) == vals[0]

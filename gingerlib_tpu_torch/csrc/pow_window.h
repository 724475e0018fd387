// The pow kernel's window (pow_const.cu): host code with no CUDA header,
// so that tests/test_torch_pow_window.py compiles it with g++ and holds it
// to fields/fp.pow_window.
#pragma once

namespace gl {

constexpr int kMaxWindow = 5;  // a table of 31 entries a group

// The w-bit digits of bits[0 .. nbits) (MSB first) into d, most
// significant first, the bits padded on the left to a multiple of w;
// returns their count.
inline int window_digits(const unsigned char* bits, int nbits, int w,
                         unsigned char* d) {
  const int ndig = (nbits + w - 1) / w, pad = ndig * w - nbits;
  for (int k = 0; k < ndig; k++) {
    int v = 0;
    for (int b = 0; b < w; b++) {
      const int pos = k * w + b - pad;
      v = 2 * v + (pos >= 0 && bits[pos] ? 1 : 0);
    }
    d[k] = (unsigned char)v;
  }
  return ndig;
}

// Multiplies of the window chain for bits[0 .. nbits) at window w:
// squarings + non-zero digits after the first + the table's 2^w - 2; 0
// where no bit is set.  nbits <= 1024.
inline int window_muls(const unsigned char* bits, int nbits, int w) {
  unsigned char d[1024];
  const int ndig = window_digits(bits, nbits, w, d);
  int first = -1, nonzero = 0;
  for (int k = 0; k < ndig; k++) {
    if (d[k] == 0) continue;
    if (first < 0)
      first = k;
    else
      nonzero++;
  }
  if (first < 0) return 0;
  return w * (ndig - 1 - first) + nonzero + (1 << w) - 2;
}

inline int pick_window(const unsigned char* bits, int nbits) {
  int best = 1, muls = window_muls(bits, nbits, 1);
  for (int w = 2; w <= kMaxWindow; w++) {
    const int m = window_muls(bits, nbits, w);
    if (m < muls) {
      best = w;
      muls = m;
    }
  }
  return best;
}

}  // namespace gl

"""Byte serialization, bit-compatible with the reference's ToBytes/FromBytes.

Counterpart of ``gingerlib_tpu/utils/serialize.py``, over the port's int64
digit tensors.  Formats (byte-identical to the reference's, groth16/mod.rs):

* Fp element: little-endian bytes of the *standard-form* integer, width
  8 * ceil(bits / 64) bytes (the reference's u64 limb count);
* extension elements: components in order, low first;
* SW affine point: x || y || infinity byte; the affine zero is
  (0, 1, infinity = 1);
* Proof: a || b || c (groth16/mod.rs:35-54);
* VerifyingKey: alpha_g1_beta_g2 || gamma_g2 || delta_g2 || u32-BE count ||
  gamma_abc points (groth16/mod.rs:104-132);
* Parameters: the verifying key, alpha_g1, beta_g1, beta_g2, delta_g1,
  delta_g2, then five u32-BE length-prefixed query vectors
  (groth16/mod.rs:188-209).

Host code: points convert to python ints in bulk, one transfer a tensor.
``*_to_bytes`` take tensors on any device; ``*_from_bytes`` place theirs
on ``device`` under the package's device rule (``None`` is the GPU).  A
query point at infinity comes back as (0, 0) with its flag set, the port's
convention, where the bytes hold (0, 1).  Point compression, GT
compression and their inverses work on python ints.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..device import resolve_device
from ..fields import fp as fpmod
from ..fields import host_ext
from ..fields.fp import FpParams


def _ref_width(params: FpParams) -> int:
    return 8 * (-(-params.modulus_bits // 64))


def _std_ints(params: FpParams, t) -> list:
    """Montgomery digits [..., nd] (tensor or array) -> flat list of
    standard-form ints."""
    return fpmod.fp_to_ints(params, t)


def _ints_bytes(params: FpParams, vals) -> bytes:
    w = _ref_width(params)
    return b"".join(int(v).to_bytes(w, "little") for v in vals)


def _read_int(params: FpParams, data: bytes, offset: int):
    w = _ref_width(params)
    if offset + w > len(data):
        raise ValueError("truncated field element")
    v = int.from_bytes(data[offset:offset + w], "little")
    if v >= params.modulus:
        raise ValueError("field element not in range")
    return v, offset + w


def _upload(params: FpParams, vals, shape, device):
    return torch.from_numpy(np.ascontiguousarray(
        fpmod.fp_from_ints(params, vals).reshape(shape))).to(device)


def fp_to_bytes(params: FpParams, mont_digits) -> bytes:
    return _ints_bytes(params, _std_ints(params, mont_digits))


def fp_from_bytes(params: FpParams, data: bytes, offset: int = 0,
                  device=None):
    """(Montgomery digits [nd] on ``device``, next offset)."""
    device = resolve_device(device)
    v, offset = _read_int(params, data, offset)
    return _upload(params, [v], (params.n_digits,), device), offset


def ext_to_bytes(ops, elem) -> bytes:
    return _ints_bytes(ops.fp, _std_ints(ops.fp, elem))


def _read_ext(ops, data: bytes, offset: int):
    comps = []
    for _ in range(ops.K):
        v, offset = _read_int(ops.fp, data, offset)
        comps.append(v)
    return comps, offset


def ext_from_bytes(ops, data: bytes, offset: int = 0, device=None):
    """(an element [K, nd] on ``device``, next offset)."""
    device = resolve_device(device)
    comps, offset = _read_ext(ops, data, offset)
    return _upload(ops.fp, comps, (ops.K, ops.fp.n_digits), device), offset


def _zero_bytes(curve) -> bytes:
    """The reference's affine zero: x = 0, y = 1, infinity = 1."""
    K = curve.F.K
    return _ints_bytes(curve.fp, [0] * K + [1] + [0] * (K - 1)) + b"\x01"


def affine_to_bytes(curve, xy, infinity: bool = False) -> bytes:
    if infinity:
        return _zero_bytes(curve)
    return (ext_to_bytes(curve.F, xy[0]) + ext_to_bytes(curve.F, xy[1]) +
            b"\x00")


def _read_affine(curve, data: bytes, offset: int):
    x, offset = _read_ext(curve.F, data, offset)
    y, offset = _read_ext(curve.F, data, offset)
    if offset >= len(data):
        raise ValueError("truncated point")
    return x, y, data[offset] == 1, offset + 1


def affine_from_bytes(curve, data: bytes, offset: int = 0, device=None):
    """((x, y, infinity), next offset): x, y [K, nd] on ``device`` as the
    bytes hold them."""
    device = resolve_device(device)
    x, y, inf, offset = _read_affine(curve, data, offset)
    shape = (curve.F.K, curve.fp.n_digits)
    return (_upload(curve.fp, x, shape, device),
            _upload(curve.fp, y, shape, device), inf), offset


# ---------------------------------------------------------------------------
# compressed bit serialization (ToCompressedBits / FromCompressedBits,
# short_weierstrass_projective.rs:205-268; write_bits fields/mod.rs:264-285)
# ---------------------------------------------------------------------------

def _write_bits(v: int, n: int):
    return [bool((v >> (n - 1 - i)) & 1) for i in range(n)]


def _read_bits(bits, n: int, modulus: int) -> int:
    if len(bits) > n:
        raise ValueError("bit vec longer than modulus bits")
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    if v >= modulus:
        raise ValueError("element over the field modulus")
    return v


def fp_write_bits(params: FpParams, v: int):
    """Big-endian bits of a standard-form element, MODULUS_BITS long."""
    return _write_bits(v, params.modulus_bits)


def fp_read_bits(params: FpParams, bits) -> int:
    return _read_bits(bits, params.modulus_bits, params.modulus)


def point_compress(params: FpParams, xy_host, infinity: bool = False):
    """G1 point (host ints) -> bit vec: x bits || infinity || y parity."""
    x = 0 if infinity else xy_host[0]
    bits = fp_write_bits(params, x)
    bits.append(bool(infinity))
    bits.append((not infinity) and bool(xy_host[1] & 1))
    return bits


def point_decompress(params: FpParams, a: int, b: int, r: int, bits):
    """Bit vec -> affine host point (x, y), or None for infinity; checks
    that the point is on y^2 = x^3 + a x + b and of order dividing r."""
    from ..proofs.groth16_host import HostCurve, HostField
    parity = bool(bits[-1])
    infinity = bool(bits[-2])
    x = fp_read_bits(params, bits[:-2])
    if infinity:
        if parity or x != 0:
            raise ValueError("invalid flags")
        return None
    p = params.modulus
    y = _sqrt_mod((x * x % p * x + a * x + b) % p, p)
    if y is None:
        raise ValueError("not on curve")
    if bool(y & 1) != parity:
        y = p - y
    curve = HostCurve(HostField(p), (a % p,), None)
    if curve.mul(([x], [y]), r) is not None:
        raise ValueError("not prime order")
    return (x, y)


def _sqrt_mod(v: int, p: int):
    """Tonelli-Shanks on host ints; None for a non-square."""
    if v == 0:
        return 0
    if pow(v, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(v, (p + 1) // 4, p)
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, rr = s, pow(z, q, p), pow(v, q, p), pow(v, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, rr = t * c % p, rr * b % p
    return rr


# ---------------------------------------------------------------------------
# proof, verifying key, parameters
# ---------------------------------------------------------------------------

def proof_to_bytes(engine, proof) -> bytes:
    g1, g2 = engine.g1, engine.g2
    return (affine_to_bytes(g1, proof.a) + affine_to_bytes(g2, proof.b) +
            affine_to_bytes(g1, proof.c))


def proof_from_bytes(engine, data: bytes, device=None):
    """(Proof on ``device``, bytes read)."""
    from ..proofs.groth16 import Proof
    device = resolve_device(device)
    pts = []
    off = 0
    for curve in (engine.g1, engine.g2, engine.g1):
        (x, y, _), off = affine_from_bytes(curve, data, off, device)
        pts.append((x, y))
    return Proof(a=pts[0], b=pts[1], c=pts[2]), off


def vk_to_bytes(engine, vk) -> bytes:
    if vk.alpha_g1_beta_g2 is None:
        raise ValueError("verifying key has no alpha_g1_beta_g2")
    xs, ys = vk.gamma_abc_g1
    n = xs.shape[0]
    return b"".join([
        ext_to_bytes(engine.fqk, vk.alpha_g1_beta_g2),
        affine_to_bytes(engine.g2, vk.gamma_g2),
        affine_to_bytes(engine.g2, vk.delta_g2),
        struct.pack(">I", n),
        _points_bytes(engine.g1, xs, ys, [False] * n)])


def vk_from_bytes(engine, data: bytes, offset: int = 0, device=None):
    """(VerifyingKey on ``device``, next offset)."""
    from ..proofs.groth16 import VerifyingKey
    device = resolve_device(device)
    gt, off = ext_from_bytes(engine.fqk, data, offset, device)
    (gx, gy, _), off = affine_from_bytes(engine.g2, data, off, device)
    (dx, dy, _), off = affine_from_bytes(engine.g2, data, off, device)
    (xs, ys, inf), off = _query_from_bytes(engine.g1, data, off, device)
    if bool(inf.any()):
        raise ValueError("point at infinity in gamma_abc")
    return VerifyingKey(alpha_g1_beta_g2=gt, gamma_g2=(gx, gy),
                        delta_g2=(dx, dy), gamma_abc_g1=(xs, ys)), off


def _points_bytes(curve, xs, ys, inf) -> bytes:
    """Affine points [n, K, nd] with flags [n], one after another."""
    K = curve.F.K
    xi = _std_ints(curve.fp, xs)
    yi = _std_ints(curve.fp, ys)
    zero = _zero_bytes(curve)
    out = []
    for i, at_inf in enumerate(inf):
        if at_inf:
            out.append(zero)
        else:
            out.append(_ints_bytes(curve.fp, xi[i * K:(i + 1) * K] +
                                   yi[i * K:(i + 1) * K]) + b"\x00")
    return b"".join(out)


def _query_to_bytes(curve, query) -> bytes:
    """Length-prefixed affine vector with per-point infinity flags
    (Parameters ToBytes, groth16/mod.rs:188-209)."""
    xs, ys, inf = query
    return struct.pack(">I", xs.shape[0]) + _points_bytes(
        curve, xs, ys, [bool(v) for v in torch.as_tensor(inf).cpu()])


def _query_from_bytes(curve, data: bytes, offset: int, device):
    if offset + 4 > len(data):
        raise ValueError("truncated vector length")
    (n,) = struct.unpack(">I", data[offset:offset + 4])
    offset += 4
    K = curve.F.K
    xs, ys, inf = [], [], []
    for _ in range(n):
        x, y, at_inf, offset = _read_affine(curve, data, offset)
        if at_inf:
            x = y = [0] * K
        xs.extend(x)
        ys.extend(y)
        inf.append(at_inf)
    shape = (n, K, curve.fp.n_digits)
    return (_upload(curve.fp, xs, shape, device),
            _upload(curve.fp, ys, shape, device),
            torch.tensor(inf, dtype=torch.bool, device=device)), offset


_SINGLES = (("alpha_g1", "g1"), ("beta_g1", "g1"), ("beta_g2", "g2"),
            ("delta_g1", "g1"), ("delta_g2", "g2"))
_QUERIES = (("a_query", "g1"), ("b_g1_query", "g1"), ("b_g2_query", "g2"),
            ("h_query", "g1"), ("l_query", "g1"))


def params_to_bytes(engine, params) -> bytes:
    """Full Parameters serialization (groth16/mod.rs:188-209)."""
    out = [vk_to_bytes(engine, params.vk)]
    for name, g in _SINGLES:
        out.append(affine_to_bytes(getattr(engine, g), getattr(params, name)))
    for name, g in _QUERIES:
        out.append(_query_to_bytes(getattr(engine, g), getattr(params, name)))
    return b"".join(out)


def params_from_bytes(engine, data: bytes, device=None):
    """(Parameters on ``device``, bytes read)."""
    from ..proofs.groth16 import Parameters
    device = resolve_device(device)
    vk, off = vk_from_bytes(engine, data, 0, device)
    fields = {}
    for name, g in _SINGLES:
        (x, y, _), off = affine_from_bytes(getattr(engine, g), data, off,
                                           device)
        fields[name] = (x, y)
    for name, g in _QUERIES:
        fields[name], off = _query_from_bytes(getattr(engine, g), data, off,
                                              device)
    return Parameters(vk=vk, num_inputs=vk.gamma_abc_g1[0].shape[0],
                      domain_size=fields["h_query"][0].shape[0] + 1,
                      **fields), off


# ---------------------------------------------------------------------------
# GT (Fqk) compressed serialization (ToCompressedBits/FromCompressedBits for
# Fp4 and Fp6 over Fp3, fields/models/fp4.rs:331-376): c1's bits and c0's
# parity; the inverse solves the unitary relation c0^2 - NR c1^2 = 1 with a
# square root in the subfield.  F: the host tower of Fqk
# (``host_ext.HostTower``).
# ---------------------------------------------------------------------------

def _ext_is_odd(F, comps) -> bool:
    """The reference's Field::is_odd for a tower element (fp2.rs:101,
    fp3.rs:135): the parity of its highest non-zero component,
    recursively."""
    if F.sf is None:
        return bool(comps[0] & 1)
    for part in reversed(F.parts(comps)):
        if any(v % F.p for v in part):
            return _ext_is_odd(F.sf, part)
    return False


def _ext_pow_host(F, a, e: int):
    r = [1] + [0] * (F.K - 1)
    base = list(a)
    while e:
        if e & 1:
            r = host_ext.host_ext_mul(F, r, base)
        base = host_ext.host_ext_mul(F, base, base)
        e >>= 1
    return r


def _ext_norm_host(F, a) -> int:
    """The norm of a down to the prime field, one level at a time:
    a0^2 - nr a1^2 over a quadratic level, a0^3 + nr a1^3 + nr^2 a2^3 -
    3 nr a0 a1 a2 over a cubic one."""
    if F.sf is None:
        return a[0] % F.p
    S, p, nr = F.sf, F.p, list(F.nr)

    def m(x, y):
        return host_ext.host_ext_mul(S, x, y)

    if F.degree == 2:
        a0, a1 = F.parts(a)
        n = [(x - y) % p for x, y in zip(
            m(a0, a0), host_ext.host_ext_mul_const(S, m(a1, a1), nr))]
    else:
        a0, a1, a2 = F.parts(a)
        nr2 = m(nr, nr)
        n = [(x + y + z - 3 * w) % p for x, y, z, w in zip(
            m(a0, m(a0, a0)),
            host_ext.host_ext_mul_const(S, m(a1, m(a1, a1)), nr),
            host_ext.host_ext_mul_const(S, m(a2, m(a2, a2)), nr2),
            host_ext.host_ext_mul_const(S, m(a0, m(a1, a2)), nr))]
    return _ext_norm_host(S, n)


def _ext_is_square_host(F, a) -> bool:
    """Euler's criterion through the norm: a^((q - 1)/2) = N(a)^((p -
    1)/2) for a non-zero a of F_q over F_p."""
    return pow(_ext_norm_host(F, a), (F.p - 1) // 2, F.p) == 1


def _ext_sqrt_host(F, a):
    """Tonelli-Shanks over F_(p^k) in host ints; None for a non-square."""
    p, k = F.p, F.K
    q = p ** k
    one = [1] + [0] * (k - 1)
    zero = [0] * k
    a = [v % p for v in a]
    if a == zero:
        return zero
    if not _ext_is_square_host(F, a):
        return None
    t, s = q - 1, 0
    while t % 2 == 0:
        t //= 2
        s += 1
    z = None
    for trial in range(2, 50):
        cands = [[trial] + [0] * (k - 1)]
        if k > 1:
            cands += [[0] * (k - 1) + [trial], [trial, 1] + [0] * (k - 2)]
        for cand in cands:
            if not _ext_is_square_host(F, cand):
                z = cand
                break
        if z:
            break
    if z is None:
        raise ValueError("no quadratic non-residue found")
    m, c = s, _ext_pow_host(F, z, t)
    # x = a^((t + 1)/2), b = a^t = x^2 / a
    x = _ext_pow_host(F, a, (t + 1) // 2)
    b = host_ext.host_ext_mul(F, host_ext.host_ext_mul(F, x, x),
                              host_ext.host_ext_inv(F, a))
    while b != one:
        i, bb = 0, list(b)
        while bb != one:
            bb = host_ext.host_ext_mul(F, bb, bb)
            i += 1
        e = _ext_pow_host(F, c, 1 << (m - i - 1))
        m, c = i, host_ext.host_ext_mul(F, e, e)
        b = host_ext.host_ext_mul(F, b, c)
        x = host_ext.host_ext_mul(F, x, e)
    return x


def gt_compress(F, comps):
    """comps: the K standard-form ints of a GT element.  Returns the
    reference's compressed bit vec: c1.write_bits() || parity(c0)."""
    k = F.sf.K
    n = F.p.bit_length()
    bits = []
    for v in comps[k:]:
        bits.extend(_write_bits(v % F.p, n))
    bits.append(_ext_is_odd(F.sf, comps[:k]))
    return bits


def gt_decompress(F, bits):
    """Inverse of ``gt_compress``; raises ValueError where sqrt(1 + NR c1^2)
    does not exist (BitSerializationError::UndefinedSqrt)."""
    p, k, n = F.p, F.sf.K, F.p.bit_length()
    parity = bool(bits[-1])
    body = bits[:-1]
    if len(body) != k * n:
        raise ValueError("wrong compressed length")
    c1 = [_read_bits(body[i * n:(i + 1) * n], n, p) for i in range(k)]
    nr_c1_sq = host_ext.host_ext_mul_const(
        F.sf, host_ext.host_ext_mul(F.sf, c1, c1), list(F.nr))
    c0 = _ext_sqrt_host(F.sf, [(a + b) % p for a, b in zip(
        [1] + [0] * (k - 1), nr_c1_sq)])
    if c0 is None:
        raise ValueError("undefined sqrt")
    if _ext_is_odd(F.sf, c0) != parity:
        c0 = [(-v) % p for v in c0]
    return c0 + c1

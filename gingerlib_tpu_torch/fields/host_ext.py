"""Host-side exact extension-field arithmetic (python ints).

Counterpart of ``gingerlib_tpu/fields/host_ext.py`` as far as the ported
towers need it: the Frobenius coefficients of the quadratic and cubic
extensions, of MNT4's Fq4, of MNT6's Fq6 and of BLS12's Fq6 = Fq2[V]/(V^3
- xi) and Fq12 = Fq6[W]/(W^2 - V) (coefficients in Fq2), derived at build
time instead of transcribed, the python-int arithmetic over Fq2 and Fq3 that the host
ladders run (``ext_ops``), and the flat component-list arithmetic over a
tower of quadratic and cubic extensions that the python-int pairing oracle
(``curves/pairing_host.py``) runs on.

An element is a flat list of ints, sub-tower low component first (the
device layout's order); a tower level is a ``HostTower``.
"""

from __future__ import annotations

from dataclasses import dataclass


def quad_mul(p, nr, a, b):
    """(a0 + a1 X)(b0 + b1 X) with X^2 = nr, an int."""
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 + nr * a1 * b1) % p, (a0 * b1 + a1 * b0) % p)


def quad_inv(p, nr, a):
    """1 / (a0 + a1 X) through the norm a0^2 - nr a1^2."""
    a0, a1 = a
    di = pow((a0 * a0 - nr * a1 * a1) % p, -1, p)
    return (a0 * di % p, -a1 * di % p)


def quad_pow(p, nr, a, e):
    r = (1, 0)
    while e > 0:
        if e & 1:
            r = quad_mul(p, nr, r, a)
        a = quad_mul(p, nr, a, a)
        e >>= 1
    return r


def cubic_mul(p, nr, a, b):
    """(a0 + a1 X + a2 X^2)(b0 + b1 X + b2 X^2) with X^3 = nr, an int."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    return ((a0 * b0 + nr * (a1 * b2 + a2 * b1)) % p,
            (a0 * b1 + a1 * b0 + nr * a2 * b2) % p,
            (a0 * b2 + a1 * b1 + a2 * b0) % p)


def cubic_inv(p, nr, a):
    """1 / (a0 + a1 X + a2 X^2) through the adjugate and the norm."""
    a0, a1, a2 = a
    c0 = (a0 * a0 - nr * a1 * a2) % p
    c1 = (nr * a2 * a2 - a0 * a1) % p
    c2 = (a1 * a1 - a0 * a2) % p
    di = pow((a0 * c0 + nr * (a2 * c1 + a1 * c2)) % p, -1, p)
    return (c0 * di % p, c1 * di % p, c2 * di % p)


def cubic_pow(p, nr, a, e):
    r = (1, 0, 0)
    while e > 0:
        if e & 1:
            r = cubic_mul(p, nr, r, a)
        a = cubic_mul(p, nr, a, a)
        e >>= 1
    return r


def ext_ops(p, nr, K):
    """(mul, inv) of python-int elements of the base field (K = 1), of
    Fq2 = Fq[X]/(X^2 - nr) or of Fq3 = Fq[X]/(X^3 - nr): the closed forms
    the host ladders run (``prepare_g2``, the fixed-base window bases)."""
    if K == 1:
        return (lambda a, b: [a[0] * b[0] % p],
                lambda a: [pow(a[0], -1, p)])
    mul, inv = {2: (quad_mul, quad_inv), 3: (cubic_mul, cubic_inv)}[K]
    return (lambda a, b: list(mul(p, nr, a, b)),
            lambda a: list(inv(p, nr, a)))


def frob_table_fp2(p, nr):
    """c1[i] = nr^((p^i-1)/2) for i in 0..1."""
    return [pow(nr, (pow(p, i) - 1) // 2, p) for i in range(2)]


def frob_table_fp4(p, nr2):
    """Fp4 = Fp2[Y]/(Y^2 - X), X^2 = nr2.  c1[i] = X^((p^i-1)/2), which
    lands in Fp for these parameter sets; returns a list of ints."""
    out = []
    for i in range(4):
        v = quad_pow(p, nr2, (0, 1), (pow(p, i) - 1) // 2)
        if v[1]:
            raise ValueError("Fp4 Frobenius coefficient not in Fp")
        out.append(v[0])
    return out


def frob_table_fp3(p, nr):
    """c1[i] = nr^((p^i-1)/3), c2[i] = nr^(2(p^i-1)/3) for i in 0..2."""
    c1 = [pow(nr, (pow(p, i) - 1) // 3, p) for i in range(3)]
    c2 = [pow(nr, 2 * (pow(p, i) - 1) // 3, p) for i in range(3)]
    return c1, c2


def frob_table_fp6_2over3(p, nr3):
    """Fp6 = Fp3[Y]/(Y^2 - X), X^3 = nr3.  c1[i] = X^((p^i-1)/2), which
    lands in Fp for these parameter sets; returns a list of ints."""
    out = []
    for i in range(6):
        v = cubic_pow(p, nr3, (0, 1, 0), (pow(p, i) - 1) // 2)
        if v[1] or v[2]:
            raise ValueError("Fp6 Frobenius coefficient not in Fp")
        out.append(v[0])
    return out


def frob_table_fp6_3over2(p, nr2, xi):
    """Fp6 = Fp2[V]/(V^3 - xi), xi in Fp2, X^2 = nr2.  c1[i] =
    xi^((p^i-1)/3), c2[i] = xi^(2(p^i-1)/3): Fp2 elements (pairs)."""
    c1, c2 = [], []
    for i in range(6):
        e = (pow(p, i) - 1) // 3
        c1.append(quad_pow(p, nr2, tuple(xi), e))
        c2.append(quad_pow(p, nr2, tuple(xi), 2 * e))
    return c1, c2


def frob_table_fp12(p, nr2, xi):
    """Fp12 = Fp6[W]/(W^2 - V), V^3 = xi in Fp2.  c1[i] = xi^((p^i-1)/6):
    Fp2 elements (pairs)."""
    return [quad_pow(p, nr2, tuple(xi), (pow(p, i) - 1) // 6)
            for i in range(12)]


def flatten(v):
    """Nested int tuple/list -> flat list of ints (depth-first)."""
    if isinstance(v, int):
        return [v]
    out = []
    for c in v:
        out.extend(flatten(c))
    return out


@dataclass(frozen=True)
class HostTower:
    """One level of a tower of quadratic and cubic extensions, as the host
    functions read it: the prime field (``sf`` None, K = 1) or
    sf[Y]/(Y^d - nr), d = ``degree`` (2 or 3), with ``nr`` and the Frobenius
    coefficients ``frob_c1`` (and ``frob_c2`` for d = 3) flat elements of
    ``sf``.  Either degree goes over any level: BLS12's Fq6 is a cubic
    extension of the quadratic Fq2, its Fq12 a quadratic one of that."""
    p: int
    K: int = 1
    sf: "HostTower | None" = None
    nr: tuple = ()
    frob_c1: tuple = ()
    degree: int = 1
    frob_c2: tuple = ()

    @staticmethod
    def quad(sub: "HostTower", nr, frob_c1) -> "HostTower":
        return HostTower(sub.p, 2 * sub.K, sub, tuple(flatten(nr)),
                         tuple(tuple(flatten(c)) for c in frob_c1), 2)

    @staticmethod
    def cubic(sub: "HostTower", nr, frob_c1, frob_c2) -> "HostTower":
        return HostTower(sub.p, 3 * sub.K, sub, tuple(flatten(nr)),
                         tuple(tuple(flatten(c)) for c in frob_c1), 3,
                         tuple(tuple(flatten(c)) for c in frob_c2))

    def parts(self, u):
        """A flat element's ``degree`` subfield components."""
        k = self.sf.K
        return [u[i * k:(i + 1) * k] for i in range(self.degree)]


def _add(p, x, y):
    return [(a + b) % p for a, b in zip(x, y)]


def _sub(p, x, y):
    return [(a - b) % p for a, b in zip(x, y)]


def host_ext_mul(F: HostTower, u, v):
    """Multiply flat component lists in F (Karatsuba and Toom-style, as
    the device)."""
    p = F.p
    if F.sf is None:
        return [u[0] * v[0] % p]
    S, nr = F.sf, list(F.nr)

    def m(x, y):
        return host_ext_mul(S, x, y)

    if F.degree == 2:
        (a0, a1), (b0, b1) = F.parts(u), F.parts(v)
        v0, v1 = m(a0, b0), m(a1, b1)
        t = m(_add(p, a0, a1), _add(p, b0, b1))
        return _add(p, v0, host_ext_mul_const(S, v1, nr)) + \
            _sub(p, _sub(p, t, v0), v1)
    (a0, a1, a2), (b0, b1, b2) = F.parts(u), F.parts(v)
    v0, v1, v2 = m(a0, b0), m(a1, b1), m(a2, b2)
    t12 = m(_add(p, a1, a2), _add(p, b1, b2))
    t01 = m(_add(p, a0, a1), _add(p, b0, b1))
    t02 = m(_add(p, a0, a2), _add(p, b0, b2))
    return (_add(p, v0, host_ext_mul_const(
                S, _sub(p, _sub(p, t12, v1), v2), nr)) +
            _add(p, _sub(p, _sub(p, t01, v0), v1),
                 host_ext_mul_const(S, v2, nr)) +
            _add(p, _sub(p, _sub(p, t02, v0), v2), v1))


def host_ext_mul_const(F: HostTower, u, k):
    """u times a constant of F given as an int or a flat list."""
    return host_ext_mul(F, u, [x % F.p for x in
                               (k if isinstance(k, list) else [k])])


def host_ext_inv(F: HostTower, u):
    p = F.p
    if F.sf is None:
        return [pow(u[0], -1, p)]
    S, nr = F.sf, list(F.nr)

    def m(x, y):
        return host_ext_mul(S, x, y)

    if F.degree == 2:
        a0, a1 = F.parts(u)
        t = host_ext_inv(S, _sub(p, m(a0, a0),
                                 host_ext_mul_const(S, m(a1, a1), nr)))
        return m(a0, t) + [(-x) % p for x in m(a1, t)]
    a0, a1, a2 = F.parts(u)
    s0 = _sub(p, m(a0, a0), host_ext_mul_const(S, m(a1, a2), nr))
    s1 = _sub(p, host_ext_mul_const(S, m(a2, a2), nr), m(a0, a1))
    s2 = _sub(p, m(a1, a1), m(a0, a2))
    t = host_ext_inv(S, _add(p, m(a0, s0), host_ext_mul_const(
        S, _add(p, m(a2, s1), m(a1, s2)), nr)))
    return m(s0, t) + m(s1, t) + m(s2, t)


def host_ext_frob(F: HostTower, u, i: int):
    """u^(p^i) on a flat component list."""
    if F.sf is None:
        return [u[0] % F.p]
    parts = F.parts(u)
    out = host_ext_frob(F.sf, parts[0], i)
    for part, coeffs in zip(parts[1:], (F.frob_c1, F.frob_c2)):
        out += host_ext_mul_const(F.sf, host_ext_frob(F.sf, part, i),
                                  list(coeffs[i % F.K]))
    return out


def build_mnt4_host_towers(p: int, nr2: int):
    """Fq -> Fq2 (X^2 = nr2) -> Fq4 (Y^2 = X) as host descriptors."""
    base = HostTower(p)
    fq2 = HostTower.quad(base, nr2, frob_table_fp2(p, nr2))
    fq4 = HostTower.quad(fq2, [0, 1],
                         [[c, 0] for c in frob_table_fp4(p, nr2)])
    return base, fq2, fq4


def build_mnt6_host_towers(p: int, nr3: int):
    """Fq -> Fq3 (X^3 = nr3) -> Fq6 (Y^2 = X) as host descriptors."""
    base = HostTower(p)
    fq3 = HostTower.cubic(base, nr3, *frob_table_fp3(p, nr3))
    fq6 = HostTower.quad(fq3, [0, 1, 0],
                         [[c, 0, 0] for c in frob_table_fp6_2over3(p, nr3)])
    return base, fq3, fq6


def build_bls12_host_towers(p: int, nr2: int, xi):
    """Fq -> Fq2 (X^2 = nr2) -> Fq6 (V^3 = xi) -> Fq12 (W^2 = V) as host
    descriptors; Fq12's Frobenius coefficients are Fq2 values embedded as
    (c, 0, 0) in Fq6."""
    base = HostTower(p)
    fq2 = HostTower.quad(base, nr2, frob_table_fp2(p, nr2))
    fq6 = HostTower.cubic(fq2, list(xi), *frob_table_fp6_3over2(p, nr2, xi))
    fq12 = HostTower.quad(fq6, [0, 0, 1, 0, 0, 0],
                          [[list(c), [0, 0], [0, 0]]
                           for c in frob_table_fp12(p, nr2, xi)])
    return base, fq2, fq6, fq12

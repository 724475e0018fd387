"""Host-side exact extension-field arithmetic (python ints).

Counterpart of ``gingerlib_tpu/fields/host_ext.py`` as far as the ported
towers need it: the Frobenius coefficients of the quadratic extension and of
MNT4's Fq4, derived at build time instead of transcribed, and the flat
component-list arithmetic over a tower of quadratic extensions that the
python-int pairing oracle (``curves/pairing_host.py``) runs on.

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
    """One level of a tower of quadratic extensions, as the host functions
    read it: the prime field (``sf`` None, K = 1) or sf[Y]/(Y^2 - nr) with
    ``nr`` and the Frobenius coefficients ``frob_c1`` flat elements of
    ``sf``."""
    p: int
    K: int = 1
    sf: "HostTower | None" = None
    nr: tuple = ()
    frob_c1: tuple = ()

    @staticmethod
    def quad(sub: "HostTower", nr, frob_c1) -> "HostTower":
        return HostTower(sub.p, 2 * sub.K, sub, tuple(flatten(nr)),
                         tuple(tuple(flatten(c)) for c in frob_c1))


def host_ext_mul(F: HostTower, u, v):
    """Multiply flat component lists in F (Karatsuba, as the device)."""
    p = F.p
    if F.sf is None:
        return [u[0] * v[0] % p]
    k = F.sf.K
    a0, a1 = u[:k], u[k:]
    b0, b1 = v[:k], v[k:]
    v0 = host_ext_mul(F.sf, a0, b0)
    v1 = host_ext_mul(F.sf, a1, b1)
    c0 = [(x + y) % p for x, y in zip(v0, host_ext_mul_const(
        F.sf, v1, list(F.nr)))]
    t = host_ext_mul(F.sf, [(x + y) % p for x, y in zip(a0, a1)],
                     [(x + y) % p for x, y in zip(b0, b1)])
    return c0 + [(x - y - z) % p for x, y, z in zip(t, v0, v1)]


def host_ext_mul_const(F: HostTower, u, k):
    """u times a constant of F given as an int or a flat list."""
    return host_ext_mul(F, u, [x % F.p for x in
                               (k if isinstance(k, list) else [k])])


def host_ext_inv(F: HostTower, u):
    p = F.p
    if F.sf is None:
        return [pow(u[0], -1, p)]
    k = F.sf.K
    a0, a1 = u[:k], u[k:]
    norm = [(x - y) % p for x, y in zip(
        host_ext_mul(F.sf, a0, a0),
        host_ext_mul_const(F.sf, host_ext_mul(F.sf, a1, a1), list(F.nr)))]
    t = host_ext_inv(F.sf, norm)
    return host_ext_mul(F.sf, a0, t) + \
        [(-x) % p for x in host_ext_mul(F.sf, a1, t)]


def host_ext_frob(F: HostTower, u, i: int):
    """u^(p^i) on a flat component list."""
    if F.sf is None:
        return [u[0] % F.p]
    k = F.sf.K
    return host_ext_frob(F.sf, u[:k], i) + host_ext_mul_const(
        F.sf, host_ext_frob(F.sf, u[k:], i), list(F.frob_c1[i % F.K]))


def build_mnt4_host_towers(p: int, nr2: int):
    """Fq -> Fq2 (X^2 = nr2) -> Fq4 (Y^2 = X) as host descriptors."""
    base = HostTower(p)
    fq2 = HostTower.quad(base, nr2, frob_table_fp2(p, nr2))
    fq4 = HostTower.quad(fq2, [0, 1],
                         [[c, 0] for c in frob_table_fp4(p, nr2)])
    return base, fq2, fq4

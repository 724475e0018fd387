"""Python-int Groth16 oracle: what a proof must be, computed in closed form
from the toxic waste.

Independent of all tensor code.  With the setup secrets known, a proof is
three scalar multiplications:

    A = [alpha + a(t) + r*delta] G1
    B = [beta  + b(t) + s*delta] G2
    C = [sum_aux z_i*(beta*a_i + alpha*b_i + c_i)(t)/delta
         + h(t)*Z(t)/delta + s*A_s + r*B_s - r*s*delta] G1

with a(t) = sum_i z_i a_i(t) (likewise b, c), h(t) = (a(t) b(t) - c(t))/Z(t),
and A_s, B_s the scalars of A and B.  This is what the device proof is held
against, coordinate for coordinate, at sizes where a python-int prover with
its six MSMs would take far too long.

Also here: the QAP at the toxic point in python ints (Lagrange
coefficients and per-variable evaluations, ``qap_at``), the oracle that
``proofs/groth16.qap_at_device`` is held to, affine curve arithmetic
over Fq, Fq2 and Fq3 in python ints (``host_curves``: MNT4-753, MNT6-753,
BLS12-377, BLS12-381), and ``HostGroth16``: setup, prove and verify in python ints
for small circuits (counterpart of the JAX package's ``HostGroth16``), the
prover of the recursion's inner proofs in the tests.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from .. import params as PP
from ..curves.pairing_host import (HostMNTPairing, host_bls12_377_pairing,
                                   host_bls12_381_pairing,
                                   host_mnt4753_pairing, host_mnt6753_pairing,
                                   host_mnt6298_pairing, host_sw6_pairing)
from ..fields import host_ext
from ..params._gen import curves_gen as CG, towers_gen as TG
from ..relations.r1cs import ConstraintSystem


# ---------------------------------------------------------------------------
# Fq / Fq2 / Fq3 elements as lists of ints (length K), and affine EC on them
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HostField:
    """Fq (K = 1) or Fq[X]/(X^K - nr) for K = 2, 3."""
    p: int
    nr: int = 0
    K: int = 1

    @functools.cached_property
    def _ops(self):
        return host_ext.ext_ops(self.p, self.nr, self.K)

    def mul(self, a, b):
        return self._ops[0](a, b)

    def inv(self, a):
        return self._ops[1](a)

    def sub(self, a, b):
        return [(x - y) % self.p for x, y in zip(a, b)]


@dataclass(frozen=True)
class HostCurve:
    """y^2 = x^3 + a x + b over ``F``; points are (x, y) of component lists,
    None is infinity."""
    F: HostField
    a: tuple
    gen: tuple

    def double(self, P):
        if P is None:
            return None
        F, p = self.F, self.F.p
        x, y = P
        if all(v == 0 for v in y):
            return None
        num = [(3 * u + v) % p for u, v in zip(F.mul(x, x), self.a)]
        lam = F.mul(num, F.inv([2 * u % p for u in y]))
        x3 = F.sub(F.sub(F.mul(lam, lam), x), x)
        y3 = F.sub(F.mul(lam, F.sub(x, x3)), y)
        return (x3, y3)

    def add(self, P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        F, p = self.F, self.F.p
        if P[0] == Q[0]:
            if all((u + v) % p == 0 for u, v in zip(P[1], Q[1])):
                return None
            return self.double(P)
        lam = F.mul(F.sub(Q[1], P[1]), F.inv(F.sub(Q[0], P[0])))
        x3 = F.sub(F.sub(F.mul(lam, lam), P[0]), Q[0])
        y3 = F.sub(F.mul(lam, F.sub(P[0], x3)), P[1])
        return (x3, y3)

    def mul(self, P, k: int):
        acc = None
        for bit in bin(k)[2:] if k else "":
            acc = self.double(acc)
            if bit == "1":
                acc = self.add(acc, P)
        return acc

    def neg(self, P):
        if P is None:
            return None
        return (P[0], [(-v) % self.F.p for v in P[1]])


# (curve constants, G2's field and its degree, Fq, Fr)
_FAMILIES = {
    "mnt4753": (CG.MNT4753, TG.MNT4753_FQ2, 2, PP.MNT4753_FQ, PP.MNT4753_FR),
    "mnt6753": (CG.MNT6753, TG.MNT6753_FQ3, 3, PP.MNT6753_FQ, PP.MNT6753_FR),
    "bls12_377": (CG.BLS12_377, TG.BLS12_377_FQ2, 2, PP.BLS12_377_FQ,
                  PP.BLS12_377_FR),
    "bls12_381": (CG.BLS12_381, TG.BLS12_381_FQ2, 2, PP.BLS12_381_FQ,
                  PP.BLS12_381_FR),
    "sw6": (CG.SW6, TG.SW6_FQ3, 3, PP.SW6_FQ, PP.SW6_FR),
    "mnt6298": (CG.MNT6298, TG.MNT6298_FQ3, 3, PP.MNT6298_FQ,
                PP.MNT6298_FR),
}


def host_curves(family: str):
    """(G1 curve, G2 curve, Fr parameters) of ``family`` in python ints."""
    c, tw, k, fq, fr = _FAMILIES[family]
    p = fq.modulus
    g1 = HostCurve(HostField(p), (c["a"] % p,),
                   ([c["g1_x"]], [c["g1_y"]]))
    g2 = HostCurve(HostField(p, tw["nonresidue"] % p, k),
                   tuple(v % p for v in c["g2_a"]),
                   (list(c["g2_x"]), list(c["g2_y"])))
    return g1, g2, fr


# ---------------------------------------------------------------------------
# host half of setup
# ---------------------------------------------------------------------------

def domain_generator(fr, m: int) -> int:
    lg = m.bit_length() - 1
    return pow(fr.root_of_unity, 1 << (fr.two_adicity - lg), fr.modulus)


def lagrange_at(fr, m: int, gen: int, t: int):
    """(l_i(t) for i < m, Z(t)) as python ints, one modular inverse in all:
    l_i(t) = Z(t) * w^i / (m * (t - w^i))."""
    p = fr.modulus
    zt = (pow(t, m, p) - 1) % p
    denoms = []
    w = 1
    for _ in range(m):
        denoms.append((t - w) % p)
        w = w * gen % p
    prefix = [1] * (m + 1)
    for i in range(m):
        prefix[i + 1] = prefix[i] * denoms[i] % p
    inv_all = pow(prefix[m], -1, p)
    invs = [0] * m
    for i in range(m - 1, -1, -1):
        invs[i] = inv_all * prefix[i] % p
        inv_all = inv_all * denoms[i] % p
    m_inv = pow(m, -1, p)
    out = []
    w = 1
    for i in range(m):
        out.append(zt * m_inv % p * w % p * invs[i] % p)
        w = w * gen % p
    return out, zt


def qap_at(cs, t: int):
    """Per-variable QAP evaluations a_i(t), b_i(t), c_i(t), the vanishing
    value Z(t) and the domain size m for constraint system ``cs``."""
    fr = cs.field
    p = fr.modulus
    raw = cs.num_constraints + cs.num_inputs
    m = 1 << max(0, (raw - 1).bit_length())
    if pow(t, m, p) == 1:
        raise ValueError("t lies in the evaluation domain")
    u, zt = lagrange_at(fr, m, domain_generator(fr, m), t)
    nvars = cs.num_variables
    a = [0] * nvars
    b = [0] * nvars
    c = [0] * nvars
    for i in range(cs.num_inputs):
        a[i] = u[cs.num_constraints + i]
    for i in range(cs.num_constraints):
        for v, k in cs.at[i]:
            a[v] = (a[v] + u[i] * k) % p
        for v, k in cs.bt[i]:
            b[v] = (b[v] + u[i] * k) % p
        for v, k in cs.ct[i]:
            c[v] = (c[v] + u[i] * k) % p
    return a, b, c, zt, m


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------

def expected_proof(family: str, cs, alpha: int, beta: int, gamma: int,
                   delta: int, t: int, r: int, s: int, qap=None) -> dict:
    """The Groth16 proof of ``cs``'s assignment under the given toxic waste
    and blinding scalars: {"a": G1, "b": G2, "c": G1}, each an affine (x, y)
    of component lists in standard form.  ``gamma`` does not enter a proof
    and is taken only so that the call mirrors setup.  ``qap``: ``qap_at(cs,
    t)`` where the caller has it (a large circuit's takes seconds)."""
    g1, g2, fr = host_curves(family)
    p = fr.modulus
    a, b, c, zt, _ = qap if qap is not None else qap_at(cs, t)
    z = cs.assignment()
    ni = cs.num_inputs
    dot = lambda q: sum(x * y for x, y in zip(z, q)) % p
    a_t, b_t, c_t = dot(a), dot(b), dot(c)
    d_inv = pow(delta, -1, p)
    h_t = (a_t * b_t - c_t) * pow(zt, -1, p) % p
    a_s = (alpha + a_t + r * delta) % p
    b_s = (beta + b_t + s * delta) % p
    l_acc = sum(z[i] * (beta * a[i] + alpha * b[i] + c[i])
                for i in range(ni, len(z))) % p * d_inv % p
    c_s = (l_acc + h_t * zt % p * d_inv + s * a_s + r * b_s
           - r * s % p * delta) % p
    return {"a": g1.mul(g1.gen, a_s), "b": g2.mul(g2.gen, b_s),
            "c": g1.mul(g1.gen, c_s)}


# ---------------------------------------------------------------------------
# Groth16 in python ints
# ---------------------------------------------------------------------------

def host_idft(ev, gen: int, p: int) -> list:
    """The coefficients of the polynomial with the evaluations ``ev`` on
    the domain of len(ev) points with generator ``gen``: a quadratic
    inverse DFT (small domains only)."""
    m = len(ev)
    m_inv = pow(m, -1, p)
    out = []
    for j in range(m):
        wj, w, acc = pow(gen, -j, p), 1, 0
        for e in ev:
            acc = (acc + e * w) % p
            w = w * wj % p
        out.append(acc * m_inv % p)
    return out


def divide_by_vanishing(A, B, C, p: int) -> list:
    """(A B - C) / (x^m - 1) for coefficient lists of length m, by
    schoolbook product and division; ValueError where a remainder is left
    (the assignment does not satisfy the circuit)."""
    m = len(A)
    ab = [0] * (2 * m)
    for i in range(m):
        if A[i]:
            for j in range(m):
                ab[i + j] = (ab[i + j] + A[i] * B[j]) % p
    for i in range(m):
        ab[i] = (ab[i] - C[i]) % p
    h = [0] * m
    for i in range(2 * m - 1, m - 1, -1):
        h[i - m] = (h[i - m] + ab[i]) % p
        ab[i - m] = (ab[i - m] + ab[i]) % p     # x^m == 1
        ab[i] = 0
    if any(ab[:m]):
        raise ValueError("the assignment does not satisfy the circuit")
    return h


@dataclass
class HostParams:
    vk: dict
    num_inputs: int
    domain_size: int
    # the prover's tables, absent on setup_vk results (verify-only use)
    alpha_g1: tuple = None
    beta_g1: tuple = None
    beta_g2: tuple = None
    delta_g1: tuple = None
    delta_g2: tuple = None
    a_query: list = None
    b_g1_query: list = None
    b_g2_query: list = None
    h_query: list = None
    l_query: list = None


class HostGroth16:
    """Groth16 in python ints over the pairing ``E`` (an MNT or a BLS12
    host pairing): points are affine
    ([x comps], [y comps]) in standard form, None for infinity; every query
    element is one scalar multiplication, so only small circuits.  The vk
    is the dict the verifier gadget allocates from: ``alpha_g1_beta_g2``
    (flat GT ints), ``gamma_g2``, ``delta_g2`` and ``gamma_abc``."""

    def __init__(self, pairing: HostMNTPairing, g1: HostCurve,
                 g2: HostCurve, fr_params):
        self.E = pairing
        self.g1 = g1
        self.g2 = g2
        self.fr = fr_params

    def _g1(self, k, base=None):
        return self.g1.mul(base or self.g1.gen, k % self.fr.modulus)

    def _g2(self, k, base=None):
        return self.g2.mul(base or self.g2.gen, k % self.fr.modulus)

    def _vk(self, a, b, c, ni, alpha, beta, gamma, delta):
        p = self.fr.modulus
        ginv = pow(gamma, -1, p)
        return {
            "alpha_g1_beta_g2": self.E.pairing(self._g1(alpha),
                                               self._g2(beta)),
            "gamma_g2": self._g2(gamma),
            "delta_g2": self._g2(delta),
            "gamma_abc": [self._g1((beta * a[i] + alpha * b[i] + c[i])
                                   * ginv) for i in range(ni)],
        }

    def setup(self, cs: ConstraintSystem, alpha, beta, gamma, delta, t):
        p = self.fr.modulus
        ni = cs.num_inputs
        a, b, c, zt, m = qap_at(cs, t)
        dinv = pow(delta, -1, p)
        return HostParams(
            vk=self._vk(a, b, c, ni, alpha, beta, gamma, delta),
            alpha_g1=self._g1(alpha), beta_g1=self._g1(beta),
            beta_g2=self._g2(beta), delta_g1=self._g1(delta),
            delta_g2=self._g2(delta),
            a_query=[self._g1(s) for s in a],
            b_g1_query=[self._g1(s) for s in b],
            b_g2_query=[self._g2(s) for s in b],
            h_query=[self._g1(zt * dinv * pow(t, i, p))
                     for i in range(m - 1)],
            l_query=[self._g1((beta * a[i] + alpha * b[i] + c[i]) * dinv)
                     for i in range(ni, cs.num_variables)],
            num_inputs=ni, domain_size=m)

    def setup_vk(self, cs: ConstraintSystem, alpha, beta, gamma, delta, t):
        """The verifying key only: ``setup`` without the prover's query
        tables (a scalar multiplication a query element); verify needs the
        inputs' gamma_abc points and three constants."""
        a, b, c, _, m = qap_at(cs, t)
        return HostParams(
            vk=self._vk(a, b, c, cs.num_inputs, alpha, beta, gamma, delta),
            num_inputs=cs.num_inputs, domain_size=m)

    def _witness_h(self, cs: ConstraintSystem, m: int):
        """h's coefficients and the assignment (small m only)."""
        p = self.fr.modulus
        vals = cs.assignment()
        gen = domain_generator(self.fr, m)
        ev = [[0] * m for _ in range(3)]
        for i in range(cs.num_constraints):
            for e, mat in zip(ev, (cs.at, cs.bt, cs.ct)):
                e[i] = cs.eval_lc(mat[i], vals)
        for i in range(cs.num_inputs):
            ev[0][cs.num_constraints + i] = vals[i] if i else 1
        A, B, C = (host_idft(e, gen, p) for e in ev)
        return divide_by_vanishing(A, B, C, p), vals

    def prove(self, cs: ConstraintSystem, params: HostParams, r, s):
        p = self.fr.modulus
        m = params.domain_size
        h, vals = self._witness_h(cs, m)
        ni = params.num_inputs
        g1, g2 = self.g1, self.g2

        def msm(curve, points, scalars):
            acc = None
            for pt, k in zip(points, scalars):
                if pt is not None and k % p:
                    acc = curve.add(acc, curve.mul(pt, k % p))
            return acc

        g_a = g1.add(g1.add(msm(g1, params.a_query, vals),
                            self._g1(r, params.delta_g1)), params.alpha_g1)
        g1_b = g1.add(g1.add(msm(g1, params.b_g1_query, vals),
                             self._g1(s, params.delta_g1)), params.beta_g1)
        g2_b = g2.add(g2.add(msm(g2, params.b_g2_query, vals),
                             self._g2(s, params.delta_g2)), params.beta_g2)
        terms = [g1.mul(g_a, s % p), g1.mul(g1_b, r % p),
                 g1.neg(self._g1(r * s, params.delta_g1)),
                 msm(g1, params.l_query, vals[ni:]),
                 msm(g1, params.h_query, h[:m - 1])]
        g_c = None
        for term in terms:
            g_c = g1.add(g_c, term)
        return {"a": g_a, "b": g2_b, "c": g_c}

    def verify(self, params: HostParams, proof, public_inputs) -> bool:
        """e(A, B) e(acc, -gamma) e(C, -delta) == e(alpha, beta), acc the
        sum of gamma_abc[i] times (1, public_inputs...)."""
        p = self.fr.modulus
        vk = params.vk
        g1, g2, E = self.g1, self.g2, self.E
        g_ic = vk["gamma_abc"][0]
        for x, pt in zip(public_inputs, vk["gamma_abc"][1:]):
            g_ic = g1.add(g_ic, g1.mul(pt, x % p))
        gt = E._fmul(E._fmul(E.pairing(proof["a"], proof["b"]),
                             E.pairing(g_ic, g2.neg(vk["gamma_g2"]))),
                     E.pairing(proof["c"], g2.neg(vk["delta_g2"])))
        return gt == vk["alpha_g1_beta_g2"]


def host_groth16_mnt4753() -> HostGroth16:
    g1, g2, fr = host_curves("mnt4753")
    return HostGroth16(host_mnt4753_pairing(), g1, g2, fr)


def host_groth16_mnt6753() -> HostGroth16:
    g1, g2, fr = host_curves("mnt6753")
    return HostGroth16(host_mnt6753_pairing(), g1, g2, fr)


def host_groth16_bls12_377() -> HostGroth16:
    """Groth16 over BLS12-377 (reference groth16/test.rs bls12_377
    module): the inner proof of the BLS12-377 verifier circuit."""
    g1, g2, fr = host_curves("bls12_377")
    return HostGroth16(host_bls12_377_pairing(), g1, g2, fr)


def host_groth16_bls12_381() -> HostGroth16:
    g1, g2, fr = host_curves("bls12_381")
    return HostGroth16(host_bls12_381_pairing(), g1, g2, fr)


def host_groth16_sw6() -> HostGroth16:
    """Groth16 over SW6: the outer proof of the BLS12-377 verifier circuit
    (SW6's Fr is BLS12-377's Fq)."""
    g1, g2, fr = host_curves("sw6")
    return HostGroth16(host_sw6_pairing(), g1, g2, fr)


def host_groth16_mnt6298() -> HostGroth16:
    g1, g2, fr = host_curves("mnt6298")
    return HostGroth16(host_mnt6298_pairing(), g1, g2, fr)

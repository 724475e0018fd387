"""Host (python-int) GM17 (Groth-Maller '17): the oracles of the port's
device GM17.

Counterpart of ``gingerlib_tpu/proofs/gm17_host.py``: the exact dataflow of
proof-systems/src/gm17/{generator,prover,verifier,r1cs_to_sap}.rs.  R1CS ->
SAP (squaring only) doubles the constraints and adds one variable a
constraint and one an input; the verifier checks two pairing equations.
``HostGM17`` runs setup, prove and verify in python ints (small circuits:
its MSMs are one scalar multiplication a point); ``expected_gm17_proof``
computes a proof in closed form from the toxic waste, three scalar
multiplications, at any size.

The SAP's evaluation domain is the one the device takes (``best_domain``):
radix 2 where the size fits the field's two-adicity, else 2^k * 5^s
(MNT6-753's Fr has two-adicity 15).  The JAX package's host oracle knows the
radix-2 domain only; on such sizes the two agree.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.pairing_host import (HostMNTPairing, host_mnt4753_pairing,
                                   host_mnt6298_pairing, host_mnt6753_pairing)
from ..relations.r1cs import ConstraintSystem
from .groth16_host import (HostCurve, divide_by_vanishing, host_curves,
                           host_idft, lagrange_at)

# the small prime of the mixed-radix domain (ops/fft.py's MIXED_RADIX)
_Q = 5


def sap_size(cs: ConstraintSystem) -> int:
    """The SAP's number of rows: two a constraint, two an input past the
    ONE, and one for the ONE (r1cs_to_sap.rs)."""
    return 2 * cs.num_constraints + 2 * (cs.num_inputs - 1) + 1


def sap_domain(fr, size: int):
    """(m, generator) of the smallest domain of at least ``size`` points:
    radix 2 within the two-adicity, else 2^k * 5^s with 5^s | p - 1."""
    p = fr.modulus
    lg = max(0, (size - 1).bit_length())
    if lg <= fr.two_adicity:
        m = 1 << lg
        return m, pow(fr.root_of_unity, 1 << (fr.two_adicity - lg), p)
    best, qs = None, 1
    while (p - 1) % qs == 0:
        k = max(0, (-(-size // qs) - 1).bit_length())
        if k <= fr.two_adicity and (best is None or (qs << k) < best):
            best = qs << k
        qs *= _Q
    if best is None:
        raise ValueError(f"no 2^k*{_Q}^s domain of size >= {size}")
    return best, pow(fr.generator, (p - 1) // best, p)


def sap_at(cs: ConstraintSystem, t: int):
    """The SAP instance map at t (r1cs_to_sap.rs:14-100): (a, c, Z(t),
    sap_num_vars, m, gen), a and c indexed by SAP variable (the R1CS
    variables, then one a constraint, then one an input past the ONE)."""
    fr = cs.field
    p = fr.modulus
    nc, ni, na = cs.num_constraints, cs.num_inputs, cs.num_aux
    m, gen = sap_domain(fr, sap_size(cs))
    if pow(t, m, p) == 1:
        raise ValueError("t lies in the evaluation domain")
    u, zt = lagrange_at(fr, m, gen, t)
    sap_num_vars = 2 * (ni - 1) + na + nc
    evo, eco, evo2 = ni + na, 2 * nc, ni + na + nc - 1
    a = [0] * (sap_num_vars + 1)
    c = [0] * (sap_num_vars + 1)
    # the sums are reduced once at the end: a verifier circuit's rows hold
    # millions of terms
    for i in range(nc):
        u2i, u2i1 = u[2 * i], u[2 * i + 1]
        ua, us, uc = u2i + u2i1, u2i - u2i1, 4 * u2i
        for v, k in cs.at[i]:
            a[v] += ua * k
        for v, k in cs.bt[i]:
            a[v] += us * k
        for v, k in cs.ct[i]:
            c[v] += uc * k
        c[evo + i] += ua
    a = [x % p for x in a]
    c = [x % p for x in c]
    a[0] = (a[0] + u[eco]) % p
    c[0] = (c[0] + u[eco]) % p
    for i in range(1, ni):
        a[i] = (a[i] + u[eco + 2 * i - 1]) % p
        a[0] = (a[0] + u[eco + 2 * i - 1]) % p
        c[i] = (c[i] + 4 * u[eco + 2 * i - 1]) % p
        c[evo2 + i] = (c[evo2 + i] + u[eco + 2 * i - 1]) % p
        a[i] = (a[i] + u[eco + 2 * i]) % p
        a[0] = (a[0] - u[eco + 2 * i]) % p
        c[evo2 + i] = (c[evo2 + i] + u[eco + 2 * i]) % p
    return a, c, zt, sap_num_vars, m, gen


def sap_full_assignment(cs: ConstraintSystem) -> list:
    """The SAP witness: the R1CS assignment, then (A_i - B_i)^2 a
    constraint, then (x_i - 1)^2 an input past the ONE."""
    p = cs.field.modulus
    vals = cs.assignment()
    full = list(vals)
    for i in range(cs.num_constraints):
        d = cs.eval_lc(cs.at[i], vals) - cs.eval_lc(cs.bt[i], vals)
        full.append(d * d % p)
    full.extend((vals[i] - 1) ** 2 % p for i in range(1, cs.num_inputs))
    return full


@dataclass
class HostGM17Params:
    vk: dict
    a_query: list
    b_query: list
    c_query_1: list
    c_query_2: list
    g_gamma_z: tuple
    h_gamma_z: tuple
    g_ab_gamma_z: tuple
    g_gamma2_z2: tuple
    g_gamma2_z_t: list
    num_inputs: int
    domain_size: int


class HostGM17:
    """GM17 in python ints over the pairing ``E``: points are affine
    ([x comps], [y comps]) in standard form, None for infinity."""

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

    def setup(self, cs: ConstraintSystem, alpha, beta, t):
        """gamma = 1, as the reference pins it (generator.rs:27): gamma
        Z(t) is Z(t) and the gamma factors drop."""
        p = self.fr.modulus
        ni = cs.num_inputs
        a, c, zt, nvars, m, _ = sap_at(cs, t)
        ab = (alpha + beta) % p
        vk = {
            "h_g2": self.g2.gen,
            "g_alpha_g1": self._g1(alpha),
            "h_beta_g2": self._g2(beta),
            "g_gamma_g1": self.g1.gen,
            "h_gamma_g2": self.g2.gen,
            "query": [self._g1(c[i] + a[i] * ab) for i in range(ni)],
        }
        return HostGM17Params(
            vk=vk,
            a_query=[self._g1(ai) for ai in a],
            b_query=[self._g2(ai) for ai in a],
            c_query_1=[self._g1(c[i] + a[i] * ab)
                       for i in range(ni, nvars + 1)],
            c_query_2=[self._g1(ai * 2 * zt) for ai in a],
            g_gamma_z=self._g1(zt),
            h_gamma_z=self._g2(zt),
            g_ab_gamma_z=self._g1(ab * zt),
            g_gamma2_z2=self._g1(zt * zt),
            g_gamma2_z_t=[self._g1(zt * pow(t, i, p)) for i in range(m + 1)],
            num_inputs=ni, domain_size=m,
        )

    def _witness(self, cs: ConstraintSystem, m: int, gen: int, d1, d2):
        """(the SAP witness, h's m + 1 coefficients) by a quadratic
        inverse DFT and schoolbook division (r1cs_to_sap.rs:102-250)."""
        p = self.fr.modulus
        nc, ni = cs.num_constraints, cs.num_inputs
        vals = cs.assignment()
        full = sap_full_assignment(cs)
        eco = 2 * nc
        evo = ni + cs.num_aux
        evo2 = evo + nc - 1
        a_ev = [0] * m
        c_ev = [0] * m
        for i in range(nc):
            A = cs.eval_lc(cs.at[i], vals)
            B = cs.eval_lc(cs.bt[i], vals)
            a_ev[2 * i] = (A + B) % p
            a_ev[2 * i + 1] = (A - B) % p
            c_ev[2 * i] = (4 * cs.eval_lc(cs.ct[i], vals) + full[evo + i]) % p
            c_ev[2 * i + 1] = full[evo + i]
        a_ev[eco] = 1
        c_ev[eco] = 1
        for i in range(1, ni):
            a_ev[eco + 2 * i - 1] = (vals[i] + 1) % p
            a_ev[eco + 2 * i] = (vals[i] - 1) % p
            c_ev[eco + 2 * i - 1] = (4 * vals[i] + full[evo2 + i]) % p
            c_ev[eco + 2 * i] = full[evo2 + i]

        A, C = host_idft(a_ev, gen, p), host_idft(c_ev, gen, p)
        hq = divide_by_vanishing(A, A, C, p)
        # h = 2 d1 A + (A^2 - C)/Z - d2 - d1^2 at [0], plus top coeff d1^2
        h = [(2 * d1 * A[i] + hq[i]) % p for i in range(m)]
        h[0] = (h[0] - d2 - d1 * d1) % p
        h.append(d1 * d1 % p)
        return full, h

    def prove(self, cs: ConstraintSystem, params: HostGM17Params,
              d1, d2, r):
        p = self.fr.modulus
        m = params.domain_size
        _, gen = sap_domain(self.fr, sap_size(cs))
        full, h = self._witness(cs, m, gen, d1 % p, d2 % p)
        ni = params.num_inputs

        def msm(curve, points, scalars):
            acc = None
            for pt, k in zip(points, scalars):
                if pt is not None and k % p:
                    acc = curve.add(acc, curve.mul(pt, k % p))
            return acc

        g1, g2 = self.g1, self.g2
        g_a = g1.add(msm(g1, params.a_query, full),
                     self._g1(r + d1, params.g_gamma_z))
        g_b = g2.add(msm(g2, params.b_query, full),
                     self._g2(r + d1, params.h_gamma_z))
        # c_query_2[0] enters with coefficient r (prover.rs r_c0), not
        # full[0]: the c2 MSM skips index 0
        c2_acc = msm(g1, params.c_query_2[1:], full[1:])
        terms = [
            msm(g1, params.c_query_1, full[ni:]),
            self._g1(r * r, params.g_gamma2_z2),
            self._g1(r, params.g_ab_gamma_z),
            self._g1(d1, params.g_ab_gamma_z),
            g1.mul(params.c_query_2[0], r % p),
            self._g1(d1 * 2 * r, params.g_gamma2_z2),
            None if c2_acc is None else g1.mul(c2_acc, r % p),
            self._g1(d2, params.g_gamma2_z_t[0]),
            msm(g1, params.g_gamma2_z_t, h)]
        g_c = None
        for term in terms:
            g_c = g1.add(g_c, term)
        return {"a": g_a, "b": g_b, "c": g_c}

    def verify(self, params: HostGM17Params, proof, public_inputs) -> bool:
        """e(A + alpha, B + beta) = e(alpha, beta) e(psi, gamma_h2) e(C, h)
        and e(A, gamma_h2) = e(gamma_g1, B) (verifier.rs)."""
        p = self.fr.modulus
        vk = params.vk
        if len(public_inputs) + 1 != len(vk["query"]):
            raise ValueError("malformed verifying key")
        g1, g2, E = self.g1, self.g2, self.E
        g_psi = vk["query"][0]
        for x, pt in zip(public_inputs, vk["query"][1:]):
            g_psi = g1.add(g_psi, g1.mul(pt, x % p))
        a_alpha = g1.add(proof["a"], vk["g_alpha_g1"])
        b_beta = g2.add(proof["b"], vk["h_beta_g2"])
        ml = E._fmul(
            E._fmul(E.miller_loop(g1.neg(a_alpha), b_beta),
                    E.miller_loop(g_psi, vk["h_gamma_g2"])),
            E.miller_loop(proof["c"], vk["h_g2"]))
        ml = E._fmul(ml, E.miller_loop(vk["g_alpha_g1"], vk["h_beta_g2"]))
        one = E._fone()
        test1 = E.final_exponentiation(ml) == one
        ml2 = E._fmul(E.miller_loop(proof["a"], vk["h_gamma_g2"]),
                      E.miller_loop(vk["g_gamma_g1"], g2.neg(proof["b"])))
        test2 = E.final_exponentiation(ml2) == one
        return test1 and test2


def host_gm17_mnt4753() -> HostGM17:
    g1, g2, fr = host_curves("mnt4753")
    return HostGM17(host_mnt4753_pairing(), g1, g2, fr)


def host_gm17_mnt6753() -> HostGM17:
    g1, g2, fr = host_curves("mnt6753")
    return HostGM17(host_mnt6753_pairing(), g1, g2, fr)


def host_gm17_mnt6298() -> HostGM17:
    """GM17 over MNT6-298 (JAX ``gm17_host.host_gm17_mnt6298``)."""
    g1, g2, fr = host_curves("mnt6298")
    return HostGM17(host_mnt6298_pairing(), g1, g2, fr)


def expected_gm17_proof(family: str, cs: ConstraintSystem, alpha: int,
                        beta: int, t: int, d1: int, d2: int, r: int,
                        sap=None) -> dict:
    """The GM17 proof of ``cs``'s assignment under the given toxic waste
    (gamma = 1, as ``HostGM17.setup``) and randomness, in closed form:
    {"a": G1, "b": G2, "c": G1}, each an affine (x, y) of component lists
    in standard form.  With A(t) = sum_i z_i a_i(t) and C(t) = sum_i z_i
    c_i(t) over the SAP witness z,

        A = B = [A(t) + (r + d1) Z(t)]
        C = [sum_(i >= inputs) z_i (c_i(t) + (alpha + beta) a_i(t))
             + (r^2 + 2 d1 r) Z(t)^2 + (r + d1)(alpha + beta) Z(t)
             + 2 r Z(t) A(t) + Z(t) (h(t) + d2)]

    with h(t) + d2 = 2 d1 A(t) + (A(t)^2 - C(t)) / Z(t) + d1^2 Z(t): the
    prover's MSMs, each sum taken at t (t^m = Z(t) + 1 on both domains).
    ``sap``: ``sap_at(cs, t)`` where the caller has it already."""
    g1, g2, fr = host_curves(family)
    p = fr.modulus
    a, c, zt, _, _, _ = sap or sap_at(cs, t)
    full = sap_full_assignment(cs)
    ni = cs.num_inputs
    a_t = sum(x * y for x, y in zip(full, a)) % p
    c_t = sum(x * y for x, y in zip(full, c)) % p
    ab = (alpha + beta) % p
    ab_s = (a_t + (r + d1) * zt) % p
    h_d2 = (2 * d1 * a_t + (a_t * a_t - c_t) * pow(zt, -1, p)
            + d1 * d1 * zt) % p
    c_s = (sum(full[i] * (c[i] + ab * a[i]) for i in range(ni, len(full)))
           + (r * r + 2 * d1 * r) * zt * zt + (r + d1) * ab * zt
           + 2 * r * zt * a_t + zt * h_d2) % p
    return {"a": g1.mul(g1.gen, ab_s), "b": g2.mul(g2.gen, ab_s),
            "c": g1.mul(g1.gen, c_s)}

"""GM17 (Groth-Maller '17) zk-SNARK: setup, prove and verify on the device.

Counterpart of ``gingerlib_tpu/proofs/gm17.py``, the same dataflow
(proof-systems/src/gm17/{generator,prover,verifier,r1cs_to_sap}.rs).  The
R1CS becomes a square arithmetic program (SAP): each constraint a*b = c
gives two squaring rows, (a + b)^2 and (a - b)^2, and one new witness, and
each input past the ONE two rows and one witness; the SAP's domain
(``best_domain``) has 2 constraints + 2 (inputs - 1) + 1 points, radix 2
where that fits the field's two-adicity and 2^k * 5^s beyond it (MNT6-753's
Fr has two-adicity 15).

Setup runs on the device as Groth16's does: the SAP's values at the toxic
point t from the Lagrange coefficients of its domain through one shared
inversion (``sap_at_device``, the column sums of the constraint matrices),
the query scalars by constant multiplies, and every query and single
element through the curve's windowed fixed-base table
(``groth16.setup_table``).  The witness map runs the SAP's transforms
(``sap_witness_map``: one batched inverse transform of A and C, one coset
transform, the division by the vanishing polynomial and the coset inverse
transform), on the mixed-radix domain where the size needs it.

The prover's MSMs go through ``msm_batched`` (one shared double-and-add
loop below 2^12 points, ``msm_hybrid`` on G1 and ``msm_affine`` on G2
above), and every term of a proof element that has its own base is an
extra point of that element's MSM: A is one MSM over the a query and
gamma Z(t) G1, B the same in G2, C one MSM over both c queries, the
h query and the two single bases, with r * c2_acc folded into the c2
query's scalars.  The points are those of the JAX package's sums term by
term.  Verification: the input accumulation and the two pairing-product
equations, each the engine's ``product_of_pairings``: one Miller loop
over its pairs (prepared through five host ladders over MNT; with the
lines on the device over BLS12) and one final exponentiation.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..fields import fp as fpmod
from ..ops import msm as msm_mod
from ..ops.fft import _build_powers_device, best_domain
from ..relations.r1cs import (ConstraintSystem, CompiledR1CS,
                              _compile_matrix, column_sums, compile_r1cs,
                              eval_matrix, eval_matrix_transposed)
from .groth16 import (_engine_device, _fixed_base_affine, _scalar_digits,
                      accumulate_inputs)


@dataclass
class GM17VerifyingKey:
    h_g2: tuple                   # G2 affine (x, y)
    g_alpha_g1: tuple             # G1 affine
    h_beta_g2: tuple
    g_gamma_g1: tuple
    h_gamma_g2: tuple
    query: tuple                  # (xs, ys, inf) [num_inputs]
    g_alpha_h_beta: torch.Tensor | None  # GT element [K, nd]: e(g^alpha,
    #                                       h^beta); None only in a key
    #                                       carried across without it


@dataclass
class GM17Parameters:
    vk: GM17VerifyingKey
    a_query: tuple                # (xs, ys, inf) over all SAP variables + 1
    b_query: tuple                # the same scalars in G2
    c_query_1: tuple              # the variables past the inputs
    c_query_2: tuple              # all variables (index 0 special-cased)
    g_gamma_z: tuple
    h_gamma_z: tuple
    g_ab_gamma_z: tuple
    g_gamma2_z2: tuple
    g_gamma2_z_t: tuple           # (xs, ys, inf) [m + 1]
    num_inputs: int = 0
    domain_size: int = 0


@dataclass
class GM17Proof:
    a: tuple
    b: tuple
    c: tuple


def sap_size(num_constraints: int, num_inputs: int) -> int:
    """The SAP's rows: two a constraint, two an input past the ONE, one
    for the ONE."""
    return 2 * num_constraints + 2 * (num_inputs - 1) + 1


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------

def sap_at_device(cs: ConstraintSystem, t: int, device=None):
    """(a, c, Z(t), domain): the SAP instance map at t (r1cs_to_sap.rs:14-
    100) on the device, a and c Montgomery digits [sap_num_vars + 1, nd]
    indexed by SAP variable (the R1CS variables, one a constraint, one an
    input past the ONE): ``gm17_host.sap_at`` with the Lagrange
    coefficients through one shared inversion and the constraint rows as
    column sums."""
    device = resolve_device(device)
    fr = cs.field
    nc, ni, na = cs.num_constraints, cs.num_inputs, cs.num_aux
    domain = _domain(fr, sap_size(nc, ni), device)
    m = domain.size
    if pow(t, m, fr.modulus) == 1:
        raise ValueError("t lies in the evaluation domain")
    u = domain.evaluate_all_lagrange_coefficients(t)           # [m, nd]
    nv = 2 * (ni - 1) + na + nc + 1
    evo, eco, evo2 = ni + na, 2 * nc, ni + na + nc - 1

    def cols(mat, w):
        return eval_matrix_transposed(
            fr, _compile_matrix(fr, mat, nc, device), w, nv)

    ev, od = u[0:eco:2], u[1:eco:2]
    a = fpmod.add_mod(fr, cols(cs.at, fpmod.add_mod(fr, ev, od)),
                      cols(cs.bt, fpmod.sub_mod(fr, ev, od)))
    ev2 = fpmod.add_mod(fr, ev, ev)
    c = cols(cs.ct, fpmod.add_mod(fr, ev2, ev2))
    c[evo:evo + nc] = fpmod.add_mod(fr, c[evo:evo + nc],
                                    fpmod.add_mod(fr, ev, od))
    # the ONE's row and two rows an input i past it: u[eco + 2i - 1] and
    # u[eco + 2i]
    u1, u2 = u[eco + 1:eco + 2 * ni - 1:2], u[eco + 2:eco + 2 * ni - 1:2]
    both = fpmod.add_mod(fr, u1, u2)
    a[1:ni] = fpmod.add_mod(fr, a[1:ni], both)
    terms = torch.cat([a[:1], u[eco:eco + 1], u1, fpmod.neg_mod(fr, u2)])
    a[0] = column_sums(fr, terms, torch.zeros(
        terms.shape[0], dtype=torch.int64, device=device), 1)[0]
    c[0] = fpmod.add_mod(fr, c[0], u[eco])
    u1_2 = fpmod.add_mod(fr, u1, u1)
    c[1:ni] = fpmod.add_mod(fr, c[1:ni], fpmod.add_mod(fr, u1_2, u1_2))
    c[evo2 + 1:evo2 + ni] = fpmod.add_mod(fr, c[evo2 + 1:evo2 + ni], both)
    return a, c, domain.evaluate_vanishing_polynomial(t), domain


# gamma of the toxic waste: the reference pins it to 1 in its public API
# (generator.rs:27), and the verification equations hold for that gamma
# only, so gamma Z(t) = Z(t) and every gamma factor drops
GAMMA = 1


def generate_parameters(engine, cs: ConstraintSystem, alpha: int, beta: int,
                        t: int, device=None) -> GM17Parameters:
    """CRS generation with explicit toxic waste (gm17/generator.rs) and
    gamma = ``GAMMA``."""
    device = _engine_device(engine, device)
    g1, g2 = engine.g1, engine.g2
    fr = g1.scalar_field
    p = fr.modulus
    ni = cs.num_inputs

    def const(v):
        return torch.from_numpy(fpmod.fp_from_int(fr, v % p)).to(device)

    a, c, zt, domain = sap_at_device(cs, t, device)
    m = domain.size
    ab = (alpha + beta) % p
    # c_i + a_i (alpha + beta): the vk's query (inputs), c_query_1
    cq = fpmod.add_mod(fr, c, fpmod.mont_mul(fr, a, const(ab)))
    c2 = fpmod.mont_mul(fr, a, const(2 * zt))
    zt_pows = fpmod.mont_mul(fr, _build_powers_device(fr, t, m + 1, device),
                             const(zt))
    nv = a.shape[0]
    std = fpmod.from_mont(fr, torch.cat([a, cq, c2, zt_pows]))
    a_s, cq_s, c2_s, zt_s = std.split([nv, nv, nv, m + 1])
    query, a_q, c1_q, c2_q, zt_q, single1 = _fixed_base_affine(
        g1, [cq_s[:ni], a_s, cq_s[ni:], c2_s, zt_s, _scalar_digits(
            fr, [alpha, GAMMA, zt, ab * zt, zt * zt], device)])
    b_q, single2 = _fixed_base_affine(
        g2, [a_s, _scalar_digits(fr, [beta, GAMMA, zt], device)])

    def pick(group, i):
        return (group[0][i], group[1][i])

    g_alpha, h_beta = pick(single1, 0), pick(single2, 0)
    vk = GM17VerifyingKey(
        h_g2=g2.generator_affine, g_alpha_g1=g_alpha, h_beta_g2=h_beta,
        g_gamma_g1=pick(single1, 1), h_gamma_g2=pick(single2, 1),
        query=query, g_alpha_h_beta=engine.pairing(g_alpha, h_beta))
    return GM17Parameters(
        vk=vk, a_query=a_q, b_query=b_q, c_query_1=c1_q, c_query_2=c2_q,
        g_gamma_z=pick(single1, 2), h_gamma_z=pick(single2, 2),
        g_ab_gamma_z=pick(single1, 3), g_gamma2_z2=pick(single1, 4),
        g_gamma2_z_t=zt_q, num_inputs=ni, domain_size=m)


# ---------------------------------------------------------------------------
# the SAP witness map
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _domain(field, size: int, device):
    return best_domain(field, size, device=device)


def compile_circuit(cs: ConstraintSystem, device=None) -> CompiledR1CS:
    """``cs`` compiled for ``create_proof``, its rows counted on the SAP's
    domain (``best_domain``).  The prover reads only the matrices'
    constraint rows, so no radix-2 domain is asked for: a circuit past the
    field's two-adicity, which ``compile_r1cs`` refuses, still compiles."""
    device = resolve_device(device)
    domain = _domain(cs.field, sap_size(cs.num_constraints, cs.num_inputs),
                     device)
    return compile_r1cs(cs, domain_size=domain.size, device=device)


def sap_domain(compiled: CompiledR1CS):
    """The SAP's evaluation domain of ``compiled`` on its device
    (``best_domain``), built once a field, size and device (its tables are
    set-up cost)."""
    return _domain(compiled.field, sap_size(compiled.num_constraints,
                                            compiled.num_inputs),
                   compiled.device)


def _sap_witness_core(compiled: CompiledR1CS, domain, z, blind):
    """The SAP witness and h's coefficients (r1cs_to_sap.rs:102-250):
    (full [sap_num_vars + 1, nd], h [m + 1, nd]), Montgomery.  The
    evaluation vectors interleave the two squaring rows of a constraint; h
    is (A(x)^2 - C(x)) / Z(x) + 2 d1 A(x) with the constant correction
    -(d2 + d1^2) and the top coefficient d1^2.  blind: (2 d1, d2 + d1^2,
    d1^2) as Montgomery tensors."""
    fr = compiled.field
    nc, ni = compiled.num_constraints, compiled.num_inputs
    m = domain.size
    one = fr.tensor("one_mont", z.device)

    A = eval_matrix(fr, compiled.a, z)[:nc]
    B = eval_matrix(fr, compiled.b, z)[:nc]
    C = eval_matrix(fr, compiled.c, z)[:nc]
    d = fpmod.sub_mod(fr, A, B)
    zin_m1 = fpmod.sub_mod(fr, z[:ni], one)
    # one squaring a constraint, one an input past the ONE
    sq = fpmod.mont_mul(fr, torch.cat([d, zin_m1[1:]]),
                        torch.cat([d, zin_m1[1:]]))
    full = torch.cat([z, sq])
    sq, inp_sq = sq[:nc], sq[nc:]

    ev = torch.zeros((2, m, fr.n_digits), dtype=z.dtype, device=z.device)
    c2 = fpmod.add_mod(fr, C, C)
    ev[0, 0:2 * nc:2] = fpmod.add_mod(fr, A, B)
    ev[0, 1:2 * nc:2] = d
    ev[1, 0:2 * nc:2] = fpmod.add_mod(fr, fpmod.add_mod(fr, c2, c2), sq)
    ev[1, 1:2 * nc:2] = sq
    eco = 2 * nc
    ev[:, eco] = one
    if ni > 1:
        zi = z[1:ni]
        z2 = fpmod.add_mod(fr, zi, zi)
        ev[0, eco + 1:eco + 2 * ni - 1:2] = fpmod.add_mod(fr, zi, one)
        ev[0, eco + 2:eco + 2 * ni - 1:2] = zin_m1[1:]
        ev[1, eco + 1:eco + 2 * ni - 1:2] = fpmod.add_mod(
            fr, fpmod.add_mod(fr, z2, z2), inp_sq)
        ev[1, eco + 2:eco + 2 * ni - 1:2] = inp_sq

    polys = domain.ifft(ev)                          # A(x), C(x)
    cos = domain.coset_fft(polys)
    t = fpmod.sub_mod(fr, fpmod.mont_mul(fr, cos[0], cos[0]), cos[1])
    hq = domain.coset_ifft(domain.divide_by_vanishing_poly_on_coset(t))

    d1x2, corr, top = blind
    h = fpmod.add_mod(fr, hq, fpmod.mont_mul(fr, polys[0], d1x2))
    h[0] = fpmod.sub_mod(fr, h[0], corr)
    return full, torch.cat([h, top[None]])


def _blind(fr, d1: int, d2: int, device):
    p = fr.modulus
    return tuple(torch.from_numpy(fpmod.fp_from_int(fr, v % p)).to(device)
                 for v in (2 * d1, d2 + d1 * d1, d1 * d1))


def sap_witness_map(compiled: CompiledR1CS, z, d1: int, d2: int,
                    domain=None):
    """(SAP witness, h coefficients) for the Montgomery assignment z, on
    ``domain`` (by default ``sap_domain(compiled)``)."""
    if domain is None:
        domain = sap_domain(compiled)
    return _sap_witness_core(compiled, domain, z,
                             _blind(compiled.field, d1, d2, z.device))


# ---------------------------------------------------------------------------
# proving
# ---------------------------------------------------------------------------

def create_proof(engine, params: GM17Parameters,
                 compiled: CompiledR1CS, assignment, d1: int, d2: int,
                 r: int, device=None) -> GM17Proof:
    """assignment: the full value list (python ints) or a Montgomery tensor
    [nvars, nd] on the device.  d1, d2, r: the prover's randomness (ints;
    pin them for a reproducible proof)."""
    device = _engine_device(engine, device)
    if compiled.device != device:
        raise ValueError(f"compiled circuit lives on {compiled.device}, "
                         f"not on {device}")
    g1, g2 = engine.g1, engine.g2
    fr = g1.scalar_field
    p = fr.modulus
    ni = compiled.num_inputs
    if isinstance(assignment, (list, tuple)):
        z = torch.from_numpy(fpmod.fp_from_ints(fr, assignment)).to(device)
    else:
        z = assignment

    full, h = _sap_witness_core(compiled, sap_domain(compiled), z,
                                _blind(fr, d1, d2, device))
    rm = torch.from_numpy(fpmod.fp_from_int(fr, r % p)).to(device)
    # r * full for the c2 query, whose index 0 takes r itself (prover.rs
    # r_c0); d2 * g_gamma2_z_t[0] as d2 added to h's first coefficient
    r_full = fpmod.mont_mul(fr, full, rm)
    r_full[0] = rm
    h[0] = fpmod.add_mod(fr, h[0], torch.from_numpy(
        fpmod.fp_from_int(fr, d2 % p)).to(device))
    std = fpmod.from_mont(fr, torch.cat([full, r_full, h]))
    nv = full.shape[0]
    full_s, r_full_s, h_s = std.split([nv, nv, h.shape[0]])
    singles = _scalar_digits(fr, [r + d1, r * r + 2 * d1 * r], device)

    def job(queries, scalars):
        """One MSM over the concatenated queries: (xs, ys, inf) triples or
        single affine points."""
        parts = [q if len(q) == 3 else (q[0][None], q[1][None], None)
                 for q in queries]
        inf = torch.cat([
            q[2] if q[2] is not None else torch.zeros(
                1, dtype=torch.bool, device=device) for q in parts])
        return (torch.cat([q[0] for q in parts]),
                torch.cat([q[1] for q in parts]), torch.cat(scalars), inf)

    g_a, g_c = msm_mod.msm_batched(g1, [
        job([params.a_query, params.g_gamma_z], [full_s, singles[:1]]),
        job([params.c_query_1, params.c_query_2, params.g_gamma2_z_t,
             params.g_gamma2_z2, params.g_ab_gamma_z],
            [full_s[ni:], r_full_s, h_s, singles[1:], singles[:1]])])
    g_b, = msm_mod.msm_batched(g2, [
        job([params.b_query, params.h_gamma_z], [full_s, singles[:1]])])
    # A and C share one inversion
    xs, ys = g1.to_affine(tuple(torch.stack([u, v])
                                for u, v in zip(g_a, g_c)))
    return GM17Proof(a=(xs[0], ys[0]), b=g2.to_affine(g_b), c=(xs[1], ys[1]))


# ---------------------------------------------------------------------------
# verification
# ---------------------------------------------------------------------------

def verify_proof(engine, vk: GM17VerifyingKey, proof: GM17Proof,
                 public_inputs) -> bool:
    """The two pairing-product equations (gm17/verifier.rs):
        e(A + alpha, B + beta) = e(alpha, beta) e(psi, gamma_h2) e(C, h)
        e(A, gamma_h2)         = e(gamma_g1, B)
    with psi the sum of the query's points times (1, public_inputs...);
    public_inputs: python ints, without the leading one."""
    if vk.g_alpha_h_beta is None:
        raise ValueError("verifying key has no g_alpha_h_beta")
    g1, g2 = engine.g1, engine.g2
    if vk.query[0].shape[0] != len(public_inputs) + 1:
        raise ValueError("malformed verifying key")
    g_psi = accumulate_inputs(g1, vk.query, public_inputs)

    def plus(curve, a, b):
        return curve.to_affine(curve.add(curve.from_affine(*a),
                                         curve.from_affine(*b)))

    def neg(curve, xy):
        return (xy[0], curve.F.neg(xy[1]))

    def pairs(*pts):
        return tuple(torch.stack(c) for c in zip(*pts))

    gt1 = engine.product_of_pairings(
        pairs(plus(g1, proof.a, vk.g_alpha_g1), g_psi, proof.c),
        pairs(plus(g2, proof.b, vk.h_beta_g2), neg(g2, vk.h_gamma_g2),
              neg(g2, vk.h_g2)))
    if not torch.equal(gt1, vk.g_alpha_h_beta):
        return False
    gt2 = engine.product_of_pairings(pairs(proof.a, neg(g1, vk.g_gamma_g1)),
                                     pairs(vk.h_gamma_g2, proof.b))
    return bool(torch.equal(gt2, engine.fqk.tensor("one", gt2.device)))

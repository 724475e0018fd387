"""Groth16 zk-SNARK: setup, prove and verify on the device.

Counterpart of ``gingerlib_tpu/proofs/groth16.py`` and the same dataflow.
Randomness (alpha..delta, t, r, s) enters as explicit python ints, so
proofs are reproducible.

Setup runs on the device: the Lagrange coefficients at the toxic point
through one shared inversion (``Domain.evaluate_all_lagrange_coefficients``),
the per-variable QAP values as column sums of the constraint matrices
(``r1cs.eval_matrix_transposed``), the query scalars by constant
multiplies, and every query and single element (alpha, beta, gamma, delta)
through a windowed fixed-base table of the curve's generator (w = 8:
``msm.fixed_base_table`` / ``fixed_base_msm_windowed``, ginger-lib's
``fixed_base.rs``), one table a curve, built on first use and kept for that
curve and device.

Batching: in eager PyTorch a 768-step double-and-add loop takes about the
same wall time for one lane as for thousands, so independent lanes of one
group share a loop.  The prover hands its MSMs to
``ops.msm.msm_batched``: a query below 2^12 points is multiplied out in a
loop shared with the other small jobs of its group (the three multiples of
delta are always among them); a query of 2^12 points or more goes to
Pippenger on its own -- ``msm_hybrid`` with the fused curve kernels for the
G1 queries (a, b1, l, h), ``msm_affine`` for the G2 query (b2).  A second,
two-lane loop over G1 gives s*A + r*B1.  The results are those of the JAX
package's one-after-another calls.

Verification follows the JAX package's ``verify_proof``: the input
accumulation (``msm_naive`` below 64 inputs, ``msm_bucketed`` from 64),
then the product of the three pairs, the engine's
``product_of_pairings``: ONE Miller loop over the batch of three pairs
(over MNT after one host affine ladder for each of B, -gamma and -delta;
over BLS12 with the G2 lines on the device) and one final
exponentiation, and the compare in GT with ``vk.alpha_g1_beta_g2``, which
setup fills in with the engine's ``pairing``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..fields import fp as fpmod
from ..ops import limbs
from ..ops import msm as msm_mod
from ..ops.fft import Domain
from ..relations.r1cs import (ConstraintSystem, CompiledR1CS,
                              _compile_matrix, domain_size_for, eval_matrix,
                              eval_matrix_transposed)


@dataclass
class VerifyingKey:
    alpha_g1_beta_g2: torch.Tensor | None   # GT element [K, nd]; None
    #                                         only in a key carried across
    #                                         without it (utils.convert)
    gamma_g2: tuple                         # G2 affine (x, y)
    delta_g2: tuple
    gamma_abc_g1: tuple                     # (xs, ys) [num_inputs, 1, nd]


@dataclass
class Parameters:
    vk: VerifyingKey
    alpha_g1: tuple       # affine (x, y), each [K, nd]
    beta_g1: tuple
    beta_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    a_query: tuple        # (xs, ys, inf) over all variables
    b_g1_query: tuple
    b_g2_query: tuple
    h_query: tuple        # length domain_size - 1
    l_query: tuple        # aux variables only
    num_inputs: int = 0
    domain_size: int = 0


@dataclass
class Proof:
    a: tuple  # G1 affine (x, y)
    b: tuple  # G2 affine
    c: tuple  # G1 affine


def _engine_device(engine, device) -> torch.device:
    device = resolve_device(device)
    for g in (engine.g1, engine.g2):
        if g.device != device:
            raise ValueError(f"{g.name} lives on {g.device}, not on the "
                             f"requested device {device}")
    return device


def _scalar_digits(fr, ks, device):
    return torch.from_numpy(limbs.to_digits_batch(
        [k % fr.modulus for k in ks], fr.n_digits)).to(device)


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------

# window width of setup's fixed-base tables, the JAX package's
SETUP_WINDOW = 8


@functools.lru_cache(maxsize=None)
def setup_table(curve):
    """The windowed table of ``curve``'s generator, built on first use and
    kept for the curve (one object a device)."""
    return msm_mod.fixed_base_table(curve, curve.generator_affine,
                                    SETUP_WINDOW,
                                    curve.scalar_field.modulus_bits)


def _fixed_base_affine(curve, groups):
    """[k]G, affine, for every scalar of every group (standard-form digit
    tensors [n, nd_r]) through the curve's table.  Returns one
    (xs, ys, inf) a group, inf marking k == 0."""
    (xs, ys), inf = msm_mod.fixed_base_msm_windowed(
        curve, setup_table(curve), torch.cat(groups), SETUP_WINDOW,
        curve.scalar_field.modulus_bits)
    sizes = [g.shape[0] for g in groups]
    return list(zip(xs.split(sizes), ys.split(sizes), inf.split(sizes)))


def qap_at_device(cs: ConstraintSystem, t: int, device=None):
    """(a, b, c, Z(t), domain): the per-variable QAP values a_i(t),
    b_i(t), c_i(t) as Montgomery digits [num_variables, nd] on the device,
    the vanishing value and the evaluation ``Domain`` (its size is
    ``groth16_host.qap_at``'s m) -- ``qap_at`` on the device: a_i(t) =
    sum_j A[j][i] l_j(t) (likewise b, c), plus l_(nc+i)(t) for each input i
    (its consistency row)."""
    device = resolve_device(device)
    fr = cs.field
    m = domain_size_for(cs)
    if pow(t, m, fr.modulus) == 1:
        raise ValueError("t lies in the evaluation domain")
    domain = Domain(fr, m, device=device)
    u = domain.evaluate_all_lagrange_coefficients(t)           # [m, nd]
    nv, nc, ni = cs.num_variables, cs.num_constraints, cs.num_inputs
    a, b, c = (eval_matrix_transposed(
        fr, _compile_matrix(fr, mat, m, device), u, nv)
        for mat in (cs.at, cs.bt, cs.ct))
    a[:ni] = fpmod.add_mod(fr, a[:ni], u[nc:nc + ni])
    return a, b, c, domain.evaluate_vanishing_polynomial(t), domain


def generate_parameters(engine, cs: ConstraintSystem,
                        alpha: int, beta: int, gamma: int, delta: int,
                        t: int, device=None) -> Parameters:
    """CRS generation with explicit toxic waste."""
    device = _engine_device(engine, device)
    g1, g2 = engine.g1, engine.g2
    fr = g1.scalar_field
    p = fr.modulus
    ni = cs.num_inputs

    def const(v):
        return torch.from_numpy(fpmod.fp_from_int(fr, v % p)).to(device)

    a, b, c, zt, domain = qap_at_device(cs, t, device)
    m = domain.size
    # (beta a_i + alpha b_i + c_i) / gamma for the inputs, / delta for the
    # rest; h_i = Z(t) t^i / delta for i < m - 1
    s = fpmod.add_mod(fr, fpmod.add_mod(
        fr, fpmod.mont_mul(fr, a, const(beta)),
        fpmod.mont_mul(fr, b, const(alpha))), c)
    gamma_abc = fpmod.mont_mul(fr, s[:ni], const(pow(gamma, -1, p)))
    l = fpmod.mont_mul(fr, s[ni:], const(pow(delta, -1, p)))
    h = domain.distribute_powers(
        const(zt * pow(delta, -1, p)).expand(m, fr.n_digits), t)[:m - 1]
    # standard form for the window digits, one conversion for all
    nv = cs.num_variables
    std = fpmod.from_mont(fr, torch.cat([a, b, h, l, gamma_abc]))
    a_s, b_s, h_s, l_s, abc_s = std.split([nv, nv, m - 1, nv - ni, ni])

    a_q, b1_q, h_q, l_q, abc_q, single1 = _fixed_base_affine(
        g1, [a_s, b_s, h_s, l_s, abc_s,
             _scalar_digits(fr, [alpha, beta, delta], device)])
    b2_q, single2 = _fixed_base_affine(
        g2, [b_s, _scalar_digits(fr, [beta, gamma, delta], device)])
    def pick(group, i):
        return (group[0][i], group[1][i])

    vk = VerifyingKey(
        alpha_g1_beta_g2=engine.pairing(pick(single1, 0),
                                        pick(single2, 0)),
        gamma_g2=pick(single2, 1),
        delta_g2=pick(single2, 2),
        gamma_abc_g1=(abc_q[0], abc_q[1]),
    )
    return Parameters(
        vk=vk, alpha_g1=pick(single1, 0), beta_g1=pick(single1, 1),
        beta_g2=pick(single2, 0), delta_g1=pick(single1, 2),
        delta_g2=pick(single2, 2),
        a_query=a_q, b_g1_query=b1_q, b_g2_query=b2_q,
        h_query=h_q, l_query=l_q,
        num_inputs=ni, domain_size=m,
    )


# ---------------------------------------------------------------------------
# proving
# ---------------------------------------------------------------------------

def _blind(fr, d1: int, d2: int, d3: int, device):
    if not (d1 or d2 or d3):
        return None
    return tuple(
        torch.from_numpy(fpmod.fp_from_int(fr, v % fr.modulus)).to(device)
        for v in (d1, d2, d3 + d1 * d2))


def witness_map(compiled: CompiledR1CS, z, d1: int = 0, d2: int = 0,
                d3: int = 0):
    """QAP witness map -> h coefficients [m-1, nd], Montgomery
    (d1 = d2 = d3 = 0 in an ordinary proof)."""
    return _witness_map_core(
        compiled, z, _blind(compiled.field, d1, d2, d3, z.device))


def _witness_map_core(compiled: CompiledR1CS, z, blind):
    """blind: None or (d1, d2, d3 + d1*d2) as Montgomery tensors;
    h_extra(x) = d2*a(x) + d1*b(x) - (d3 + d1*d2)."""
    fr = compiled.field
    domain = compiled.domain()
    m = domain.size
    nc = compiled.num_constraints
    ni = compiled.num_inputs

    a_ev = eval_matrix(fr, compiled.a, z)   # [m, nd]
    b_ev = eval_matrix(fr, compiled.b, z)
    a_ev[nc:nc + ni] = z[:ni]               # input consistency rows

    a_poly = domain.ifft(a_ev)
    b_poly = domain.ifft(b_ev)
    ab = domain.mul_in_evaluation_domain(domain.coset_fft(a_poly),
                                         domain.coset_fft(b_poly))

    c_cos = domain.coset_fft(domain.ifft(eval_matrix(fr, compiled.c, z)))
    ab = fpmod.sub_mod(fr, ab, c_cos)
    ab = domain.divide_by_vanishing_poly_on_coset(ab)
    h = domain.coset_ifft(ab)  # [m, nd]; the top coefficient is zero

    if blind is not None:
        d1d, d2d, corr = blind
        extra = fpmod.add_mod(fr, fpmod.mont_mul(fr, a_poly, d2d),
                              fpmod.mont_mul(fr, b_poly, d1d))
        extra[0] = fpmod.sub_mod(fr, extra[0], corr)
        h = fpmod.add_mod(fr, h, extra)
    return h[:m - 1]


def create_proof(engine, params: Parameters,
                 compiled: CompiledR1CS, assignment, r: int, s: int,
                 d1: int = 0, d2: int = 0, d3: int = 0,
                 device=None) -> Proof:
    """assignment: the full value list (python ints) or a Montgomery tensor
    [nvars, nd] on the device.  r, s: blinding scalars (ints; pin them for a
    reproducible proof)."""
    device = _engine_device(engine, device)
    if compiled.device != device:
        raise ValueError(f"compiled circuit lives on {compiled.device}, "
                         f"not on {device}")
    fr = engine.g1.scalar_field
    if isinstance(assignment, (list, tuple)):
        z = torch.from_numpy(fpmod.fp_from_ints(fr, assignment)).to(device)
    else:
        z = assignment
    rd, sd, rsd = _scalar_digits(fr, [r, s, r * s], device).split(1)
    a, b, c = _create_proof_device(engine, compiled, params, z, rd, sd, rsd,
                                   _blind(fr, d1, d2, d3, device))
    return Proof(a=a, b=b, c=c)


def _create_proof_device(engine, compiled, params: Parameters, z, rd, sd,
                         rsd, blind):
    g1, g2 = engine.g1, engine.g2
    fr = g1.scalar_field
    ni = compiled.num_inputs

    h = _witness_map_core(compiled, z, blind)

    # scalars to standard form for the MSMs
    z_std = fpmod.from_mont(fr, z)
    h_std = fpmod.from_mont(fr, h)
    aux_std = z_std[ni:]

    def job(query, scalars):
        xs, ys, inf = query
        return (xs, ys, scalars, inf)

    def single(affine, kd):
        return (affine[0][None], affine[1][None], kd, None)

    # G1: a, b1, l, h queries and the three multiples of delta (small jobs
    # share one loop, large ones take Pippenger)
    a_acc, b1_acc, l_acc, h_acc, r_delta, s_delta, rs_delta = \
        msm_mod.msm_batched(g1, [
            job(params.a_query, z_std), job(params.b_g1_query, z_std),
            job(params.l_query, aux_std), job(params.h_query, h_std),
            single(params.delta_g1, rd), single(params.delta_g1, sd),
            single(params.delta_g1, rsd)])
    # G2: b2 query and s*delta, likewise
    b2_acc, s_delta2 = msm_mod.msm_batched(g2, [
        job(params.b_g2_query, z_std), single(params.delta_g2, sd)])

    g_a = g1.add_mixed(g1.add(a_acc, r_delta), params.alpha_g1)
    g1_b = g1.add_mixed(g1.add(b1_acc, s_delta), params.beta_g1)
    g2_b = g2.add_mixed(g2.add(b2_acc, s_delta2), params.beta_g2)

    # s*A + r*B1: two lanes, one loop
    pair = tuple(torch.stack([u, v]) for u, v in zip(g_a, g1_b))
    prod = g1.mul_scalar_digits(pair, torch.cat([sd, rd], dim=0))
    s_ga = tuple(c[0] for c in prod)
    r_g1b = tuple(c[1] for c in prod)
    g_c = g1.add(s_ga, r_g1b)
    g_c = g1.add(g_c, g1.neg(rs_delta))
    g_c = g1.add(g_c, l_acc)
    g_c = g1.add(g_c, h_acc)

    # A and C share one inversion
    xs, ys = g1.to_affine(tuple(torch.stack([u, v])
                                for u, v in zip(g_a, g_c)))
    return (xs[0], ys[0]), g2.to_affine(g2_b), (xs[1], ys[1])


# ---------------------------------------------------------------------------
# verification
# ---------------------------------------------------------------------------

def accumulate_inputs(g1, query, public_inputs):
    """The sum of the query's points (xs, ys, inf or None) times (1,
    public_inputs...), affine: one double-and-add loop over all inputs
    below 64 (its steps cost the same for 2 or 60 lanes), Pippenger from
    64."""
    xs, ys, inf = query
    sd = _scalar_digits(g1.scalar_field, [1] + list(public_inputs),
                        g1.device)
    msm = msm_mod.msm_bucketed if xs.shape[0] >= 64 else msm_mod.msm_naive
    return g1.to_affine(msm(g1, xs, ys, sd, inf_mask=inf))


def verify_proof(engine, vk: VerifyingKey, proof: Proof,
                 public_inputs) -> bool:
    """The three-pair product check (verifier.rs:18-44):
    e(A, B) * e(acc, -gamma) * e(C, -delta) == e(alpha, beta), where acc
    is the sum of gamma_abc[i] times (1, public_inputs...).  public_inputs:
    python ints, without the leading one."""
    g1, g2 = engine.g1, engine.g2
    xs, ys = vk.gamma_abc_g1
    if xs.shape[0] != len(public_inputs) + 1:
        raise ValueError("malformed verifying key")
    if vk.alpha_g1_beta_g2 is None:
        raise ValueError("verifying key has no alpha_g1_beta_g2")
    acc = accumulate_inputs(g1, (xs, ys, None), public_inputs)

    neg_gamma = (vk.gamma_g2[0], g2.F.neg(vk.gamma_g2[1]))
    neg_delta = (vk.delta_g2[0], g2.F.neg(vk.delta_g2[1]))
    p_batch = tuple(torch.stack([a, b, c])
                    for a, b, c in zip(proof.a, acc, proof.c))
    q_batch = tuple(torch.stack([b, g, d])
                    for b, g, d in zip(proof.b, neg_gamma, neg_delta))
    gt = engine.product_of_pairings(p_batch, q_batch)
    return bool(torch.equal(gt, vk.alpha_g1_beta_g2))


# ---------------------------------------------------------------------------
# host views
# ---------------------------------------------------------------------------

def affine_to_ints(curve, xy):
    """Device affine point (x, y) [K, nd] -> ([x comps], [y comps]) in
    standard form, or None for the (0, 0) encoding of infinity."""
    x = fpmod.fp_to_ints(curve.fp, xy[0])
    y = fpmod.fp_to_ints(curve.fp, xy[1])
    if not any(x) and not any(y):
        return None
    return (x, y)


def proof_to_ints(engine, proof: Proof) -> dict:
    """The proof in the host oracle's form."""
    return {"a": affine_to_ints(engine.g1, proof.a),
            "b": affine_to_ints(engine.g2, proof.b),
            "c": affine_to_ints(engine.g1, proof.c)}

"""Carrying proving keys and compiled circuits across from other
representations into the port's tensors.

Takes numpy arrays and python ints only.  Two sources are understood:

* array form: a parameters object whose points are digit arrays
  ``[..., K, nd]`` in Montgomery form (any integer dtype; the JAX package's
  ``groth16.Parameters`` after ``np.asarray``) -- a cast and an upload;
* host form: python-int affine points ``([x comps], [y comps])`` or ``None``
  for infinity (the JAX package's ``HostParams``) -- converted to Montgomery
  digits here.

Both are read by attribute name, so nothing of the other package is
imported.  ``params_from_numpy`` takes Groth16 proving keys
(``groth16.Parameters``), ``gm17_params_from_numpy`` GM17 ones (the JAX
package's ``GM17Parameters`` and ``HostGM17Params``); either carries G2
over Fq2 or Fq3 (K = 2, 3) and a GT element of any degree.

``points_from_numpy`` / ``points_to_numpy`` carry point batches across: an
affine batch ``((x, y), inf)`` or a projective triple ``(X, Y, Z)`` of numpy
arrays becomes the same nesting of tensors (digits int64, flags bool) and
back, so that one set of seeded inputs can go through both packages.

``pedersen_crh_from_numpy``, ``bowe_hopwood_from_numpy`` and
``pedersen_commitment_from_numpy`` carry a Pedersen CRH's generator powers
(``params``, and its windows' affine generators), a Bowe-Hopwood hash's and
a commitment's (the CRH's and ``rand_powers``) across onto a port curve, so
that both packages hash and commit with the same generators; a single
point (a Schnorr or VRF key) is a projective triple for
``points_from_numpy``.

``poseidon_params_from_numpy`` carries a Poseidon parameter set across (the
JAX package's ``PoseidonParams``, its arrays read as numpy), reduced-round
sets included, so that both packages hash with the same constants.

``rns_from_numpy`` / ``rns_to_numpy`` carry packed RNS residues across: the
JAX package's tile ``[128, N]`` uint32 (``pallas_rns.pack_rns``) is the
transpose of the port's ``[N, 128]`` int32 (``ops/rns_kernels.py``).

The other way, ``groth16_vk_to_host``, ``gm17_vk_to_host`` and
``proof_to_host`` turn a verifying key and a proof made on the device into
the host dicts the verifier gadgets allocate from (``gadgets/crypto/
nizk.py``): points as python-int affine ``([x comps], [y comps])``, GT
elements as flat lists of ints, all in standard form.  They run once a
proof, on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..fields import fp as fpmod
from ..ops.limbs import NP_DTYPE
from ..ops.rns_kernels import LANES as RNS_LANES
from ..params import ALL_FIELDS
from ..primitives.commitment import PedersenCommitment
from ..primitives.pedersen import (BoweHopwoodCRH, PedersenCRH,
                                   PedersenWindow)
from ..primitives.poseidon import PoseidonParams
from ..proofs.gm17 import GM17Parameters, GM17VerifyingKey
from ..proofs.groth16 import (Parameters, VerifyingKey,
                              affine_to_ints, proof_to_ints)
from ..relations.r1cs import CompiledR1CS, CooMatrix

_SINGLES = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2")
_QUERIES = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")


def _upload(arr, device, dtype=NP_DTYPE):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(arr).astype(dtype))).to(device)


def _host_points(curve, pts, device):
    """List of host affine points (or None) -> (xs, ys, inf) tensors."""
    K = curve.F.K
    flat_x, flat_y, inf = [], [], []
    for pt in pts:
        inf.append(pt is None)
        x, y = pt if pt is not None else ([0] * K, [0] * K)
        flat_x.extend(x)
        flat_y.extend(y)
    shape = (len(pts), K, curve.fp.n_digits)
    xs = fpmod.fp_from_ints(curve.fp, flat_x).reshape(shape)
    ys = fpmod.fp_from_ints(curve.fp, flat_y).reshape(shape)
    return (_upload(xs, device), _upload(ys, device),
            torch.tensor(inf, dtype=torch.bool, device=device))


def points_from_numpy(pt, device=None):
    """A point batch as nested tuples of numpy arrays (digit arrays of any
    integer dtype, bool flags) -> the same nesting of tensors on
    ``device``: digits int64, flags bool."""
    device = resolve_device(device)

    def walk(v):
        if isinstance(v, (tuple, list)):
            return tuple(walk(c) for c in v)
        a = np.asarray(v)
        return _upload(a, device, np.bool_ if a.dtype == np.bool_
                       else NP_DTYPE)

    return walk(pt)


def points_to_numpy(pt, dtype=np.uint32):
    """The inverse of ``points_from_numpy``: digit tensors come back as
    ``dtype`` (the JAX package keeps uint32), flags as bool."""
    if isinstance(pt, (tuple, list)):
        return tuple(points_to_numpy(c, dtype) for c in pt)
    a = pt.detach().cpu().numpy()
    return a if a.dtype == np.bool_ else a.astype(dtype)


def _powers(curve, triple):
    """A projective triple of digit arrays [N, 1, nd] -> tensors on the
    curve's device."""
    return points_from_numpy(tuple(np.asarray(c) for c in triple),
                             curve.device)


def _window(src) -> PedersenWindow:
    return PedersenWindow(src.w.window_size, src.w.num_windows)


def _host_pairs(pairs):
    return None if pairs is None else [(int(x), int(y)) for x, y in pairs]


def pedersen_crh_from_numpy(curve, src) -> PedersenCRH:
    """A Pedersen CRH (``w``, ``params`` as numpy digit arrays,
    ``generators_host``) -> the port's ``PedersenCRH`` over ``curve`` with
    the same generators."""
    crh = PedersenCRH(curve, _window(src))
    crh.params = _powers(curve, src.params)
    crh.generators_host = _host_pairs(getattr(src, "generators_host", None))
    return crh


def bowe_hopwood_from_numpy(curve, src) -> BoweHopwoodCRH:
    """A Bowe-Hopwood CRH (``w``, ``params``) -> the port's over
    ``curve``."""
    crh = BoweHopwoodCRH(curve, _window(src))
    crh.params = _powers(curve, src.params)
    return crh


def pedersen_commitment_from_numpy(curve, src) -> PedersenCommitment:
    """A Pedersen commitment (its ``crh``, ``rand_powers``,
    ``rand_base_host``) -> the port's over ``curve``."""
    comm = PedersenCommitment(curve, _window(src.crh))
    comm.crh = pedersen_crh_from_numpy(curve, src.crh)
    comm.rand_powers = _powers(curve, src.rand_powers)
    base = getattr(src, "rand_base_host", None)
    comm.rand_base_host = None if base is None else tuple(int(v)
                                                          for v in base)
    return comm


def params_from_numpy(engine, src, device=None) -> Parameters:
    """Proving key ``src`` (array form or host form, see the module
    docstring) -> the port's ``Parameters`` on ``device``.  The verifying
    key's GT element ``alpha_g1_beta_g2`` comes across where the source has
    one: in the array form Montgomery digits ``[K, nd]``, in the host form
    K standard-form ints."""
    device = resolve_device(device)

    def curve_of(name):
        return engine.g2 if "g2" in name else engine.g1

    host_form = isinstance(getattr(src, "a_query"), list)
    out = {}
    if host_form:
        for name in _SINGLES:
            xs, ys, _ = _host_points(curve_of(name), [getattr(src, name)],
                                     device)
            out[name] = (xs[0], ys[0])
        for name in _QUERIES:
            out[name] = _host_points(curve_of(name), getattr(src, name),
                                     device)
        vk_src = src.vk
        gx, gy, _ = _host_points(engine.g2, [vk_src["gamma_g2"],
                                             vk_src["delta_g2"]], device)
        abc = _host_points(engine.g1, vk_src["gamma_abc"], device)
        gt = vk_src.get("alpha_g1_beta_g2")
        vk = VerifyingKey(alpha_g1_beta_g2=None if gt is None else _upload(
                              fpmod.fp_from_ints(engine.g1.fp, gt), device),
                          gamma_g2=(gx[0], gy[0]), delta_g2=(gx[1], gy[1]),
                          gamma_abc_g1=(abc[0], abc[1]))
    else:
        for name in _SINGLES:
            x, y = getattr(src, name)
            out[name] = (_upload(x, device), _upload(y, device))
        for name in _QUERIES:
            xs, ys, inf = getattr(src, name)
            out[name] = (_upload(xs, device), _upload(ys, device),
                         _upload(inf, device, np.bool_))
        v = src.vk
        gt = getattr(v, "alpha_g1_beta_g2", None)
        vk = VerifyingKey(
            alpha_g1_beta_g2=None if gt is None else _upload(
                np.asarray(gt).reshape(-1, engine.g1.fp.n_digits), device),
            gamma_g2=tuple(_upload(c, device) for c in v.gamma_g2),
            delta_g2=tuple(_upload(c, device) for c in v.delta_g2),
            gamma_abc_g1=tuple(_upload(c, device) for c in v.gamma_abc_g1))
    return Parameters(vk=vk, num_inputs=int(src.num_inputs),
                      domain_size=int(src.domain_size), **out)


_GM17_SINGLES = ("g_gamma_z", "h_gamma_z", "g_ab_gamma_z", "g_gamma2_z2")
_GM17_QUERIES = ("a_query", "b_query", "c_query_1", "c_query_2",
                 "g_gamma2_z_t")
_GM17_VK_POINTS = ("h_g2", "g_alpha_g1", "h_beta_g2", "g_gamma_g1",
                   "h_gamma_g2")


def gm17_params_from_numpy(engine, src, device=None) -> GM17Parameters:
    """GM17 proving key ``src`` (array form or host form, see the module
    docstring) -> the port's ``GM17Parameters`` on ``device``.  The vk's
    GT element ``g_alpha_h_beta`` comes across where the source has one
    (Montgomery digits [K, nd] in the array form, K standard-form ints in
    a host vk's dict); the JAX package's host setup leaves it out."""
    device = resolve_device(device)

    def curve_of(name):
        return engine.g2 if name.startswith("h_") or name == "b_query" \
            else engine.g1

    def point(name, pt):
        if isinstance(pt, tuple) and isinstance(pt[0], list):
            xs, ys, _ = _host_points(curve_of(name), [pt], device)
            return (xs[0], ys[0])
        return tuple(_upload(c, device) for c in pt)

    def query(name, q):
        if isinstance(q, list):
            return _host_points(curve_of(name), q, device)
        xs, ys, inf = q
        return (_upload(xs, device), _upload(ys, device),
                _upload(inf, device, np.bool_))

    v = src.vk
    get = v.get if isinstance(v, dict) else lambda k: getattr(v, k, None)
    gt = get("g_alpha_h_beta")
    if gt is not None:
        gt = _upload(fpmod.fp_from_ints(engine.g1.fp, gt)
                     if isinstance(gt, list) else
                     np.asarray(gt).reshape(-1, engine.g1.fp.n_digits),
                     device)
    vk = GM17VerifyingKey(
        query=query("query", get("query")), g_alpha_h_beta=gt,
        **{name: point(name, get(name)) for name in _GM17_VK_POINTS})
    return GM17Parameters(
        vk=vk, num_inputs=int(src.num_inputs),
        domain_size=int(src.domain_size),
        **{name: point(name, getattr(src, name)) for name in _GM17_SINGLES},
        **{name: query(name, getattr(src, name)) for name in _GM17_QUERIES})


def compiled_from_numpy(field, src, device=None) -> CompiledR1CS:
    """A compiled R1CS whose COO matrices are numpy arrays (the JAX
    package's ``CompiledR1CS``) -> the port's, on ``device``.  ``field`` is
    the port's own ``FpParams`` of the scalar field."""
    device = resolve_device(device)

    def coo(m):
        return CooMatrix(rows=_upload(m.rows, device),
                         cols=_upload(m.cols, device),
                         coeffs=_upload(m.coeffs, device),
                         num_rows=int(m.num_rows),
                         max_row_nnz=int(m.max_row_nnz))

    return CompiledR1CS(field=field, num_inputs=int(src.num_inputs),
                        num_aux=int(src.num_aux),
                        num_constraints=int(src.num_constraints),
                        domain_size=int(src.domain_size),
                        a=coo(src.a), b=coo(src.b), c=coo(src.c))


def poseidon_params_from_numpy(src, device=None) -> PoseidonParams:
    """A Poseidon parameter set with Montgomery digit arrays ``rc_full1``
    [R_F, t, nd], ``rc_partial`` [R_P, t, nd], ``rc_full2`` [R_F - 1, t,
    nd], ``rc_last`` [t, nd], ``mds`` [t, t, nd], ``after_zero_perm`` [t,
    nd] and ``c2`` [nd] (any integer dtype), round counts ``t``, ``r_f``,
    ``r_p``, ``rate`` and a ``field`` with a ``name`` -> the port's
    ``PoseidonParams`` over the port's field of that name, on ``device``."""
    device = resolve_device(device)
    field = ALL_FIELDS[src.field.name]
    t = int(src.t)
    rc = np.concatenate([
        np.asarray(getattr(src, name)).reshape(-1, t, field.n_digits)
        for name in ("rc_full1", "rc_partial", "rc_full2", "rc_last")])
    return PoseidonParams.from_digits(
        field, t, int(src.r_f), int(src.r_p), int(src.rate),
        np.asarray(src.c2), rc, np.asarray(src.mds),
        np.asarray(src.after_zero_perm), device=device)


def rns_from_numpy(tile, device=None) -> torch.Tensor:
    """Packed residues as the JAX package keeps them, ``[128, N]`` of any
    integer dtype -> the port's ``[N, 128]`` int32 on ``device``."""
    device = resolve_device(device)
    a = np.asarray(tile)
    if a.ndim != 2 or a.shape[0] != RNS_LANES:
        raise ValueError(f"expected a [{RNS_LANES}, N] residue tile, got "
                         f"{a.shape}")
    return _upload(a.T, device, np.int32)


def rns_to_numpy(packed, dtype=np.uint32) -> np.ndarray:
    """The inverse of ``rns_from_numpy``: ``[N, 128]`` -> ``[128, N]``."""
    return np.ascontiguousarray(packed.detach().cpu().numpy().T.astype(dtype))


# ---------------------------------------------------------------------------
# the device's keys and proofs as the verifier gadgets' host dicts
# ---------------------------------------------------------------------------

def _query_to_host(curve, query):
    """(xs, ys[, inf]) [n, K, nd] -> list of host affine points."""
    xs, ys = query[0], query[1]
    return [affine_to_ints(curve, (x, y)) for x, y in zip(xs, ys)]


def groth16_vk_to_host(engine, vk: VerifyingKey) -> dict:
    """A device Groth16 verifying key as ``Groth16VerifierGadget.alloc_vk``
    takes it."""
    if vk.alpha_g1_beta_g2 is None:
        raise ValueError("verifying key has no alpha_g1_beta_g2")
    return {
        "alpha_g1_beta_g2": fpmod.fp_to_ints(engine.g1.fp,
                                             vk.alpha_g1_beta_g2),
        "gamma_g2": affine_to_ints(engine.g2, vk.gamma_g2),
        "delta_g2": affine_to_ints(engine.g2, vk.delta_g2),
        "gamma_abc": _query_to_host(engine.g1, vk.gamma_abc_g1)}


def gm17_vk_to_host(engine, vk: GM17VerifyingKey) -> dict:
    """A device GM17 verifying key as ``Gm17VerifierGadget.alloc_vk``
    takes it."""
    if vk.g_alpha_h_beta is None:
        raise ValueError("verifying key has no g_alpha_h_beta")
    g1, g2 = engine.g1, engine.g2
    return {
        "h_g2": affine_to_ints(g2, vk.h_g2),
        "g_alpha_g1": affine_to_ints(g1, vk.g_alpha_g1),
        "h_beta_g2": affine_to_ints(g2, vk.h_beta_g2),
        "g_gamma_g1": affine_to_ints(g1, vk.g_gamma_g1),
        "h_gamma_g2": affine_to_ints(g2, vk.h_gamma_g2),
        "query": _query_to_host(g1, vk.query),
        "g_alpha_h_beta": fpmod.fp_to_ints(g1.fp, vk.g_alpha_h_beta)}


# a device proof, Groth16's or GM17's, as the verifier gadgets'
# ``alloc_proof`` takes it ({"a", "b", "c"}): ``proof_to_ints`` under the
# bridge's name
proof_to_host = proof_to_ints

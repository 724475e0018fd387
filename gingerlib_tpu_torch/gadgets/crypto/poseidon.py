"""In-circuit Poseidon (r1cs/gadgets/crypto/src/crh/poseidon/mod.rs).

Counterpart of ``gingerlib_tpu/gadgets/crypto/poseidon.py``: the round
schedule of ``primitives/poseidon.py``; the x^-1 S-box costs 3 constraints
(mod_inv_sbox, mod.rs:39-71): booleanity of b, x y == b, (1 - b)(x - y)
== 0.  The MDS mix and the round constants are free (linear combinations).
"""

from __future__ import annotations

from ...relations.r1cs import ConstraintSystem, LinearCombination, ONE
from ..std.boolean import Boolean
from ..std.fp import FpG


class PoseidonGadget:
    def __init__(self, poseidon_dict: dict, field):
        """poseidon_dict: the raw parameters (``params/_gen/poseidon_gen``
        entries), T = 3 and rate 2."""
        if poseidon_dict["t"] != 3 or poseidon_dict["rate"] != 2:
            raise ValueError("the Poseidon gadget takes T = 3, rate 2")
        self.d = poseidon_dict
        self.field = field

    @staticmethod
    def mnt4753():
        from ... import params as PP
        from ...params._gen.poseidon_gen import POSEIDON_MNT4753
        return PoseidonGadget(POSEIDON_MNT4753, PP.MNT4753_FR)

    @staticmethod
    def mnt6753():
        from ... import params as PP
        from ...params._gen.poseidon_gen import POSEIDON_MNT6753
        return PoseidonGadget(POSEIDON_MNT6753, PP.MNT6753_FR)

    # ------------------------------------------------------------------

    def _sbox(self, cs: ConstraintSystem, x: FpG, name: str) -> FpG:
        p = self.field.modulus
        b_val = y_val = None
        if x.value is not None:
            xv = x.value % p
            b_val = 0 if xv == 0 else 1
            y_val = 0 if xv == 0 else pow(xv, -1, p)
        b = Boolean.alloc(cs, b_val, f"{name}/b")
        y = FpG.alloc(cs, y_val, f"{name}/y")
        cs.enforce(x.lc, y.lc, b.lc(), f"{name}/xy=b")
        one = LinearCombination.of(ONE)
        cs.enforce(one - b.lc(), x.lc - y.lc, LinearCombination(),
                   f"{name}/zero_case")
        return y

    def _mix(self, cs, state):
        mds = self.d["mds"]
        out = []
        for i in range(3):
            acc = state[0].mul_by_constant(mds[3 * i])
            acc = acc.add(state[1].mul_by_constant(mds[3 * i + 1]))
            acc = acc.add(state[2].mul_by_constant(mds[3 * i + 2]))
            out.append(acc)
        return out

    def permute(self, cs: ConstraintSystem, state, name="poseidon"):
        d = self.d
        rc = d["round_cst"]
        idx = 0

        def add_rc(state, idx):
            return [s.add_constant(rc[idx + j]) for j, s in
                    enumerate(state)], idx + 3

        for r in range(d["r_f"]):
            state, idx = add_rc(state, idx)
            state = [self._sbox(cs, s, f"{name}/f1r{r}s{j}")
                     for j, s in enumerate(state)]
            state = self._mix(cs, state)
        for r in range(d["r_p"]):
            state, idx = add_rc(state, idx)
            state = [self._sbox(cs, state[0], f"{name}/pr{r}")] + state[1:]
            state = self._mix(cs, state)
        for r in range(d["r_f"] - 1):
            state, idx = add_rc(state, idx)
            state = [self._sbox(cs, s, f"{name}/f2r{r}s{j}")
                     for j, s in enumerate(state)]
            state = self._mix(cs, state)
        state, idx = add_rc(state, idx)
        state = [self._sbox(cs, s, f"{name}/lasts{j}")
                 for j, s in enumerate(state)]
        return state

    def evaluate(self, cs: ConstraintSystem, inputs, name="poseidon") -> FpG:
        """inputs: FpG wires; returns the digest wire (state[0])."""
        d = self.d
        azp = d["after_zero_perm"]
        state = [FpG.constant(cs, azp[j]) for j in range(3)]
        rate = d["rate"]
        full, rem = divmod(len(inputs), rate)
        chunk_i = 0
        for c in range(full):
            for j in range(rate):
                state[j] = state[j].add(inputs[chunk_i])
                chunk_i += 1
            state[rate] = state[rate].add_constant(d["c2"])
            state = self.permute(cs, state, f"{name}/perm{c}")
        if rem:
            state[0] = state[0].add(inputs[chunk_i])
            state[rate] = state[rate].add_constant(d["c2"])
            state = self.permute(cs, state, f"{name}/perm_rem")
        return state[0]

    def hash_2_1(self, cs, left: FpG, right: FpG, name="h2_1") -> FpG:
        return self.evaluate(cs, [left, right], name)

"""Host (python-int) Poseidon model: the exact oracle that the tests and
``chip_smoke.py`` hold the port's Poseidon and Merkle tree against (same
schedule as ``primitives/poseidon.py``).  The port's own copy of
``gingerlib_tpu/primitives/poseidon_host.py``."""

from __future__ import annotations


class PoseidonHost:
    def __init__(self, d: dict, modulus: int):
        self.d = d
        self.p = modulus

    @staticmethod
    def mnt4753():
        from ..params._gen.poseidon_gen import POSEIDON_MNT4753
        from .. import params as PP
        return PoseidonHost(POSEIDON_MNT4753, PP.MNT4753_FR.modulus)

    @staticmethod
    def mnt6753():
        from ..params._gen.poseidon_gen import POSEIDON_MNT6753
        from .. import params as PP
        return PoseidonHost(POSEIDON_MNT6753, PP.MNT6753_FR.modulus)

    def _sbox(self, x):
        return 0 if x == 0 else pow(x, -1, self.p)

    def _mix(self, s):
        m = self.d["mds"]
        p = self.p
        return [sum(m[3 * i + j] * s[j] for j in range(3)) % p
                for i in range(3)]

    def permute(self, state):
        d, p = self.d, self.p
        rc = d["round_cst"]
        s = list(state)
        idx = 0
        for _ in range(d["r_f"]):
            s = [(x + rc[idx + j]) % p for j, x in enumerate(s)]
            idx += 3
            s = [self._sbox(x) for x in s]
            s = self._mix(s)
        for _ in range(d["r_p"]):
            s = [(x + rc[idx + j]) % p for j, x in enumerate(s)]
            idx += 3
            s = [self._sbox(s[0])] + s[1:]
            s = self._mix(s)
        for _ in range(d["r_f"] - 1):
            s = [(x + rc[idx + j]) % p for j, x in enumerate(s)]
            idx += 3
            s = [self._sbox(x) for x in s]
            s = self._mix(s)
        s = [(x + rc[idx + j]) % p for j, x in enumerate(s)]
        s = [self._sbox(x) for x in s]
        return s

    def evaluate(self, inputs):
        d, p = self.d, self.p
        state = list(d["after_zero_perm"])
        rate = d["rate"]
        full, rem = divmod(len(inputs), rate)
        k = 0
        for _ in range(full):
            for j in range(rate):
                state[j] = (state[j] + inputs[k]) % p
                k += 1
            state[rate] = (state[rate] + d["c2"]) % p
            state = self.permute(state)
        if rem:
            state[0] = (state[0] + inputs[k]) % p
            state[rate] = (state[rate] + d["c2"]) % p
            state = self.permute(state)
        return state[0]

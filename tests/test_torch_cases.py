"""Cases shared by the port's tests; imports torch and the port only (no
jax) and holds no test of its own.

* Operands for the curve-kernel tests: pairs (P, Q) with one lane of every
  special kind.  Used by tests/test_torch_ec_kernels.py (CPU, against the
  JAX package) and tests/test_torch_gpu_kernels.py (GPU, kernels against
  their plain versions).
* The inputs of the Pippenger tests (``msm_case``: 16 multiples of the
  generator with a duplicated point in one bucket, a zero scalar and a
  masked point).  Used by tests/test_torch_msm_pippenger.py and
  tests/test_torch_ec_rns.py.
* Poseidon at a reduced round count (R_F = R_P = 1: a full round, a partial
  one and the last one, so three inversions a permutation) with the real
  constants, its seeded inputs, and the digits the JAX package's
  ``PoseidonHash`` and ``FieldBasedMerkleTree`` returned for them
  (``JAX_POSEIDON``, ``JAX_MERKLE``).  Used by tests/test_torch_poseidon.py,
  tests/test_torch_merkle.py and tests/test_torch_gpu_kernels.py.
* The inputs of the inverse that keep it longest (``INV_LONGEST``) or make
  it negate a row (``INV_NEGATIVE_ROWS``), and the other inputs every test
  of it runs (``inv_inputs``).  Used by
  tests/test_torch_inv_divsteps.py (the header compiled for the host),
  tests/test_torch_gpu_kernels.py and chip_smoke.py (the kernel).
"""

import random

import numpy as np
import torch

# lane -> kind of the pair (P, Q) it holds; lanes 8.. are ordinary
LANES = {"equal": 0, "opposite": 1, "q_infinity": 2, "p_infinity": 3,
         "both_infinity": 4, "y_zero_doubling": 5, "ordinary": 8}
PROJ_LANES = dict(LANES, equal_in_two_forms=6)


def proj_pairs(curve, proj):
    """(P, Q) for the projective addition from >= 9 distinct projective
    points, the special lanes first."""
    n = proj[0].shape[0]
    P = tuple(c.clone() for c in proj)
    Q = tuple(c.roll(1, 0).clone() for c in proj)
    zero = curve.zero((1,))
    negP = curve.neg(P)
    lam = proj[0][n - 1]              # any non-zero field element
    for k in range(3):
        Q[k][0] = P[k][0]
        Q[k][1] = negP[k][1]
        Q[k][2] = zero[k][0]
        P[k][3] = zero[k][0]
        P[k][4] = zero[k][0]
        Q[k][4] = zero[k][0]
        Q[k][6] = curve.F.mul(P[k][6], lam)
    P[1][5] = 0                       # fabricated: no such point exists
    for k in range(3):
        Q[k][5] = P[k][5]
    return P, Q


def affine_pairs(curve, aff):
    """(a_pt, b_pt) for the batched affine addition, each ((x, y), inf),
    from >= 9 distinct affine points."""
    n = aff[0].shape[0]
    x1, y1 = aff[0].clone(), aff[1].clone()
    x2, y2 = aff[0].roll(1, 0).clone(), aff[1].roll(1, 0).clone()
    inf1 = torch.zeros(n, dtype=torch.bool, device=x1.device)
    inf2 = torch.zeros(n, dtype=torch.bool, device=x1.device)
    x2[0], y2[0] = x1[0], y1[0]
    x2[1], y2[1] = x1[1], curve.F.neg(y1[1])
    inf2[2] = inf1[3] = inf1[4] = inf2[4] = True
    x2[2] = y2[2] = x1[3] = y1[3] = 0
    for t in (x1, y1, x2, y2):
        t[4] = 0
    y1[5] = 0
    x2[5], y2[5] = x1[5].clone(), y1[5].clone()
    return ((x1, y1), inf1), ((x2, y2), inf2)


# ---------------------------------------------------------------------------
# Pippenger inputs
# ---------------------------------------------------------------------------

MSM_N = 16


def multiples(curve, ks):
    """Affine [k]G for the python ints ``ks`` (two digits each)."""
    from gingerlib_tpu_torch.ops import limbs
    kd = torch.from_numpy(limbs.to_digits_batch(ks, 2)).to(curve.device)
    return curve.to_affine(
        curve.mul_scalar_digits(curve.generator((len(ks),)), kd))


def scalar_multiple(curve, k):
    return curve.mul_const(curve.generator(()), k % curve.scalar_field.modulus)


def msm_case(g1):
    """The inputs of the JAX package's
    tests/test_msm.py::test_msm_hybrid_matches_naive on ``g1``: xs, ys,
    scalar digits ``sd``, the infinity mask ``inf`` and the scalar
    combination ``total`` = sum k_i s_i over the unmasked points."""
    from gingerlib_tpu_torch.ops import limbs
    n = MSM_N
    rng = random.Random(77)
    ks = [rng.randrange(1, 1000) for _ in range(n)]
    ks = [ks[0]] + ks[:n - 1]            # the same point twice ...
    xs, ys = multiples(g1, ks)
    rng = random.Random(31)
    sc = [rng.randrange(1 << 12) for _ in range(n)]
    sc[2] = 0
    sc[0] = sc[1]                        # ... in the same bucket
    sd = torch.from_numpy(limbs.to_digits_batch(
        sc, g1.scalar_field.n_digits)).to(g1.device)
    inf = torch.zeros(n, dtype=torch.bool, device=g1.device)
    inf[5] = True
    total = sum(k * s for i, (k, s) in enumerate(zip(ks, sc)) if i != 5)
    return dict(xs=xs, ys=ys, sd=sd, inf=inf, total=total)


# ---------------------------------------------------------------------------
# Poseidon at a reduced round count
# ---------------------------------------------------------------------------

def rand_below(bound: int, n: int, seed: int) -> list:
    """n integers below ``bound`` from numpy's generator."""
    rng = np.random.default_rng(seed)
    nbytes = (bound.bit_length() + 7) // 8 + 8
    return [int.from_bytes(rng.bytes(nbytes), "little") % bound
            for _ in range(n)]


def poseidon_modulus(name: str) -> int:
    from gingerlib_tpu_torch import params as TP
    return (TP.MNT4753_FR if name == "mnt4753" else TP.MNT6753_FR).modulus


def reduced_poseidon(name: str) -> dict:
    """The parameter dict POSEIDON_<name> cut to R_F = R_P = 1, its first
    three rounds' constants, and as ``after_zero_perm`` (the sponge's start)
    the cut permutation of the zero state, by the python-int oracle."""
    from gingerlib_tpu_torch.params._gen import poseidon_gen
    from gingerlib_tpu_torch.primitives.poseidon_host import PoseidonHost
    d = dict(getattr(poseidon_gen, "POSEIDON_" + name.upper()))
    d.update(r_f=1, r_p=1, round_cst=d["round_cst"][:9])
    d["after_zero_perm"] = PoseidonHost(d, poseidon_modulus(name)).permute(
        [0, 0, 0])
    return d


def poseidon_states(name: str) -> list:
    """Four sponge states as python ints: all zero; zero after the first
    round-constant add; a zero element; p - 1 and random values."""
    p = poseidon_modulus(name)
    rc0 = reduced_poseidon(name)["round_cst"][:3]
    r = rand_below(p, 3, seed=61)
    return [[0, 0, 0], [(-c) % p for c in rc0], [r[0], 0, r[1]],
            [r[2], p - 1, 1]]


def pow_edge_exponents() -> dict:
    """{name: MSB-first bit array} of the pow kernel's edge exponents: no
    bits, zeros, 1 (also with leading zeros), 2^w - 1 and 2^w at the
    widest window, all ones (753 bits and the longest exponent the kernel
    takes), a single set bit at the top and in the middle, a short one."""
    from gingerlib_tpu_torch.fields import fp
    from gingerlib_tpu_torch.ops import limbs
    w, top = fp.POW_MAX_WINDOW, fp.POW_MAX_BITS
    return {
        "no_bits": np.zeros(0, np.uint8),
        "zeros": np.zeros(7, np.uint8),
        "one": limbs.bits_msb_first(1, 1),
        "one_padded": limbs.bits_msb_first(1, 9),
        "2^w-1": limbs.bits_msb_first((1 << w) - 1, w),
        "2^w": limbs.bits_msb_first(1 << w, w + 1),
        "all_ones_753": np.ones(753, np.uint8),
        "all_ones_max": np.ones(top, np.uint8),
        "single_top_bit": limbs.bits_msb_first(1 << (top - 1), top),
        "single_mid_bit": limbs.bits_msb_first(1 << 300, 753),
        "short": limbs.bits_msb_first(0x9E3779B9, 32),
    }


def poseidon_rows(name: str, length: int) -> list:
    """Two seeded hash inputs of ``length`` field elements each."""
    return [rand_below(poseidon_modulus(name), length, seed=70 + 2 * length + i)
            for i in range(2)]


# What the JAX package's PoseidonHash (with the reduced parameters of
# ``reduced_poseidon``) returned: ``permute`` of ``poseidon_states`` and
# ``evaluate`` of ``poseidon_rows`` at each length, as the integers their
# Montgomery-form digits spell, sponge by sponge (permute: element by
# element).  tests/test_torch_poseidon.py::test_jax_gives_the_recorded_digits
# (slow) holds the JAX functions to these very values.
JAX_POSEIDON = {
    ('mnt4753', 'evaluate_1'): [
        0x1703fb937ded9947882fd311265b207e1430dd94a65b0fa2068d0c4347825b7132a5ce667d826f7ad9676702502b2baec5c8628d2bf174007360cf3c9f9b6a7a2e9c94db67fafe05cf4464ce730543191b80b0142603e4eaf485947b3bd94,
        0x11c582af5ba6f44ea39fc7e6c3ec001b3e09daf848af9a6a9d46fbd1cea8d1c6b0b801ec1a908b1e3f4d756d01ab4eef8f68cbe5179e17dd9ffe655872a00cc057620c492b6a43bf33ce834ae586dce48011ab7826eb1cc9b4d05f2c31b95,
    ],
    ('mnt4753', 'evaluate_2'): [
        0x1a1fa13a265faf6daa6d2dfa3c5a0a0a0567c4e7db611c07d331df934f153edd3741c28e1b6d1e706fa8642c952615228d3b3160b4299ec52cc6011a10c730ed88ba8dd16e046b2318dfeffb9caf44322b978e0436fe2f171e9b492374bf3,
        0x10fe51b74b265a0ed1b7c527680ef07512a17ec671d0991cd91fa68e9e110925935cd8ba23065c322067ea1ff689c9504740c4680dc2e90aadb2c45934233d3f9268bb4bfbd72f8eb12654d697b132fd93145ecfd4cc8b71d699e8f5a306a,
    ],
    ('mnt4753', 'evaluate_3'): [
        0xbd8ba182eb118023cee260b95670ec1bcaa5c31b2e6a17546009b990775fe95569aa9485216171105eb6a697dc09ce15c670b072d41296b4c542ca4f6789f3090569dbe5b30f9b30461f20968d612452f0678fea6e2692f97617d8dbc886,
        0xcc4b3eac4e32a2b8fce978c993293d7603d70b7e998d9251ac842ac3c2678a31379c6c19a1294c1f18945fd8d6c0e7842568d48bf6c36255ba16e122ba1a3caed7080dd9b2696044d9334d9c5303f7f2d625492d80bf56ba2d27cb595da6,
    ],
    ('mnt4753', 'permute'): [
        0xa326fb4d25e5ec376cfa48cba656e8e0d937fe1cdd9ac2f0a42afa1949ed7ded36e942fa627181fa559d7b5b543ea8ae6b37846183c937c491f8f6634c3cfa3dfafc43a9a6c2976a8d5c92e6b1bb28f5093578c3ae4aa776e417efe12cbf,
        0xdea44eb66a3091b9538297d41a40c2b85e684ac50cd23c58d7f82d0f24d18b77a3baad8f4411b677872fca2a0f7ff056f17392629fe4e60bf39fa68512b1c2aeacf17b9fa2c4ae54903e8d554e3d42c5ea842f1ffe51018e661664b16f80,
        0x4559716ac37e47a0de65ea7ad879bc358197b844481a5674ebad38c876b67162a7165e235202fc0cd02a3e48bead7376424017409903b89deacac3cffdc9c283be9bdd6fc24da4840757380d9c7664115d998349564e06736a37869dbc69,
        0x12b9d322b4e32b4fa9663cba6a02a21157b17a350b0c8d7e5c084cb4383fb174ff8578ca45bb81072494180e21fa5382de75173ae6bceccaddde387eab70caed3d36d6d597c71d818bf05dfc27b78e7108ba72c9ba98056aaf6a4d5b85abf,
        0x4eb4e1e4caad820646567ab694efcb9ad6a81a5a3481745899523542779bb774f3b2e71ee449d8c98ea3fd0019cbf58b36ff976ef49206abbe71bfb61ed4483a564f8e0ee734a93f1849ee2b1e6a873f55beb72db0db3c1264fed16cdced,
        0x1643be975a97da84df9fa5ee3865843759920091a80430b8c635c175cf0605a6b06d1b34141d6772687d38342414374610d93e7c654246fc9b02486462c8e4538b272e63a0469ca3ecc7bd4b90c477e9472eba9bf390e0298a370c66edf58,
        0x1380cd30408d8b07b21c3eca395a186148243434bf4f87c7e68bbe64598c0f6b0cb5e1226cd0c6f9570b078242cec79e9ef52ae27e8ba8e82c32a63ba06c8b9b074834dd47cd18540b17593d21c53d18f75062abb7935a85965fe4b6caaee,
        0x7cbaaf102a277f949d1b0b14f60a5c3257d3227b78ce6900a06fceec766b3d4a9916400830324db78f0d733553b166d4adc8a955bd0c9fbe0f25352228ce3e7342dbe2455b297d15a202c6f4a8060281cd0bd6c0f988afc208f89da0747c,
        0x36730131773e81496108cee0c6dd8dfcc852ca026a41c0c0133be8169c4d922ebe348c2122cf5f2f2f2eb83725fb98d87daecd45ff0e366b1020ce46e6ee6b9e2443669c5acf13b90262ceefb952516d8487633ecf7295e145c9e6bcfbc2,
        0x171a9bb438c0c62a7832c4763f8249cbb9e2cae06d5931ceedd3ac9f3da940a55602a69262b5170ad2a2378af47bb26f7013a607d629e39f22d1dcc03a9a0d448af9f3522e62e0525de2fba2bf9ed3f25f538fe81e3f879eb8454521a40c9,
        0x17afc5206085a5998f8f6e94d4ab5aeb30a6bb870cc87aad5994cfc79716c27f4eb4a3ef89c1ca571491e936855a58ed46a62c42e7bafb33ea2cd897bdc5b19078358d52e0d9a3d8364cf667e610d4d5c444997973e66e629b2959e7678fb,
        0x3fda7fe64fc9bd7cc17b5695bd077a9e9f179445400daf8d9bd381358ec2c0d15731aeef24d1680bf47c688a4e00fab92bda516cc8820e2a24602534424c54fe08f0e4bb2804590dbc79e7524d7e820b7a9565b52b8f1321a8a56e2585d5,
    ],
    ('mnt6753', 'evaluate_2'): [
        0x153ef808a120ca290e64212170bda870e6d871d83a29bfb059984e8122163b37221501cf5169d22f512f4a683600d1fb11f2767d07ee3095fac8ee1b25ac7e57d97b82d9063f8c65b6e0a2c5d9601deb16843f0c1623c97705250ef6f8b5e,
        0xd49c497e6990b9ec9a97e863380977c45b7350b3c393f9b34eeb9e11c2945fe9787a7ad903c77983b8e971c93dfd484001548c9f3549acd9aec2b3755d8d5780b79bfd5ee8acb1f9b2ad4b6d09dc9a5925e4c1fd8e1c9dd81a0cff621523,
    ],
    ('mnt6753', 'permute'): [
        0x1bd2e0d3fd01e10b9b31812cfa4bd5fa1e4f57cc87ebb8a6d6d2dbe8f840f8121f3dd9cdf036b6e1319de612aa047eb4a7e59c62fa8439d122895fdcf430fd1b889d71b54f86bde9f43c6442c30ca043cfd17130362f9eb42d0c092dcc089,
        0xffd0cde41dad55d5bc13fa2512c0b04b568a5c9470842b86f604938dbc451c5a7a7152dd6c97b006a5b43212534edbb5cf16a4f1bd467e72ad5da84d7d853073eef524151a1723fe3185e8b3beb5c10a7c56f1d7c7c14d01118daa3b2a37,
        0x12dee3f17285783a9524135c87ba648356a447dd9f95b0b6a1ff82ef8b2dbe74ac1aaca90b202979f817a4b0989b47c726672adcc84dac3def1f2a2f8133f8cd276cca2562f9a7e8dcf92a64908f025594a671e45b1aa385a2073ac330f4c,
        0xb3db7586a27c7971b9298b92268db98e13af2742748ed7e36aab1999f7b2b54c5679df5e70077537b9d76936ab26727dbb18c6b2b2e9aa86dabb76eda2003cc6120811f55b552b9ff9711810bc3c1ecc0978091c2cf8a20bc1b425a361a5,
        0xee76438f956299b285a76ddc62ab645fc944e3093301b797653f16894a3826e304141cdd5c5d144d5d28b39dee1ae8e481e18a06e9e1e2254e871e3f3e4ada89241d10590cfcd3efeced11f30d3780ac41b57ae54a50e79de41777c039d5,
        0x1936bd83cfb4274672271a9abbf954ee64b941c35d3ab71462ded154bf23f2c619a0b5cae35362478378a2d6d63d821e600aaef724f41021eab50fff6ff0d872b5da4bbc329cb8d6f413f0f38ee710ca25d922e4fed840d909bf0aa8ca1f8,
        0x7d9b7ce5515c2c43734e4091c96e193064261d0a025f23b9a1e0cac93e4ed9f47233df78b853b1c03745fb8813a0a6feebdd4bfa05b3586b9eae82fda9976261d831b4ed4d0b88cb9ab133d92a8e3dbf5b2f28bd2399c64dca66ec85e222,
        0x1288fae745c25cbba95b418480cf3408fa770e8b91cea6349d30a5307ca3ed3b79a09c316d93cfaf67f85a6b230d9d22b55cb5fa6575d80bdbb6ed916f8f39034b89c693cadecd49a9ffadafe1b4dc6fbf071203a94acad4eafc4a251716c,
        0x17ce95a22c9e272b24ffabac83b7b1285eb9bca5ce994a0f000adf981ec34b62847c4909ce73b92ffc866828c6e7b22d51f0f1742111b30bee9c8a7fa646052cb3c66b8478a74ac6bb33a722028598b28f3097b8af6fd8e5bf5917fb22de7,
        0x527d3eb6ae4c8ebac154dc580c971429218ac9f0a5eb7e00d47064ad6c9a46d7549c3547a2562a7392f5dc69c1a01ad6b49bee50d223b62ad1b1834b44266ce85d0a6e270fffedecc3d5da615713134f2333d2ba53a2c5d2cbe8b3813b36,
        0xebb63fff5d4c659e15203459e5086fe3ce7d106011ed1940655c4cc712e8dd1a6c58ed66b1a80c41632ec07ae6724f2ae972f0c209c3ec09d113a2fb8007e6b4ac61dee234fc591ef26bd1ae0c8a6178da9b649e4525cf09bfd5dad76e68,
        0x2338822d86f77b4be2f01fcc5974eebbd43374f8ede73ed93527c671565fbc2568a2f6bb2d680824afd064b642b18f05a8529730092b5fc76f5de1a2bb6688e8fa6c67d0934c9384f94a4da13a986e35f464b06661510b4984be0a72f3c5,
    ],
}

# What the JAX package's FieldBasedMerkleTree at height 4 returned for the
# first four (and three) of ``merkle_leaves()``: every level, the leaves
# first, then the padding chain's root, as the integers their digits spell.
# tests/test_torch_merkle.py::test_jax_tree_gives_the_recorded_digits (slow)
# holds the JAX tree to them.
JAX_MERKLE = {
    3: [
        [0xf702484f1399ff97e53e4f7fdfefa4d109d0c1d0dc82bcc97b9bfaa8b96554283d1e62063bb9f65225b41581521fad5b99e164e4a8af9982aac0d2f1721e80752ece548ae9d63486fa67b793525269257b8d4440b80b3d9589648e02ea0b,
         0xc049d10dffe0d88573761562b8a3a1f5096cd19022835c0e604da5200fcb5c96f48d6e32442ee7f52174f87930bab4d444a1816532759f015d5c319df54e6c1b20e5c8646888b2ac8190d5bd96b32d7563281efe9326779551fa5fcc0d1a,
         0x85c4328bb0d68141ec65f929214cfeed299c7d6b7b21a16dfb6dccf8d48b7350cd71a233907fa6bc80a0bcc5d2bb8da75de6478cdbf65150e45ba3805e6912008184c4dafd7ddafaae17475bdbb3d4b2d3a9c269e768cba7e5d1b88454eb,
         0x1291486d1b9ef4f8943e8a2715f4fe4f4ccee0b73be0332c382229a8e239e7d6f3d0a2296c726a4ebc978c4eb25a779e9358b811b01040e54734507c9c0de0ed5393309f9675244485a848454f2bd4150eac82898df78ceb49da19e7ddae3],
        [0x89d39e639c3a96dcc5714f9b5918f9ef4fa83f105e1d89d0cb9a6a73759cea31239d2ee0ed84ccec0ae3de37ead1b07c07f07b6c233f382f13cfdc9c77efe2cd0f2b917e3726454fee62f784a7b989f269f70b9310ac46b887538e704937,
         0x3fcd8b19b43556a34eb97fbd7ab3d418cf98786c03fcf8c751d608618999c7f826fd04a4662ea2f3d0cae7c7df63b16435f8164d1cd60858d60d5bf3f1b3a705c2d662c3f541261f5df4a1107cff02947f9ef33f68dbc0630c42116cc987],
        [0x10db4d47991623317fe83bbee1c659eb09ec31ee7805db7ab3e47266415914206251b29ab03e2c91e96a33f71b93c65d44fef378933760d6bad23f3f20bdac7e98093c29d289b859e5b09e7b41db4315d36638f03a41925972ad9498a5998],
        [0x907e82384a0ef237b2efd7193bd7667d46772814a133be182cc4924fd5a8c818d60635e414de95657b088005074619b30d443dd495f14e7ff11ea80b3192ab6423e84c7d79a3085f2ea2b492bd94e2121beda1e3b755c0574fa8f3e60372],
    ],
    4: [
        [0xf702484f1399ff97e53e4f7fdfefa4d109d0c1d0dc82bcc97b9bfaa8b96554283d1e62063bb9f65225b41581521fad5b99e164e4a8af9982aac0d2f1721e80752ece548ae9d63486fa67b793525269257b8d4440b80b3d9589648e02ea0b,
         0xc049d10dffe0d88573761562b8a3a1f5096cd19022835c0e604da5200fcb5c96f48d6e32442ee7f52174f87930bab4d444a1816532759f015d5c319df54e6c1b20e5c8646888b2ac8190d5bd96b32d7563281efe9326779551fa5fcc0d1a,
         0x85c4328bb0d68141ec65f929214cfeed299c7d6b7b21a16dfb6dccf8d48b7350cd71a233907fa6bc80a0bcc5d2bb8da75de6478cdbf65150e45ba3805e6912008184c4dafd7ddafaae17475bdbb3d4b2d3a9c269e768cba7e5d1b88454eb,
         0x14f00c8b27cdb58508b0bf3a478952d65d1fa5f65ea9a462877475985834bf4509b65def1057d30b60777cb57d0703108604046c256f9ba6ab0a2aa6731aff0cbbf069743d21b523d1a78af742504189f6ffe272969fd6aaf43d18778fefb],
        [0x89d39e639c3a96dcc5714f9b5918f9ef4fa83f105e1d89d0cb9a6a73759cea31239d2ee0ed84ccec0ae3de37ead1b07c07f07b6c233f382f13cfdc9c77efe2cd0f2b917e3726454fee62f784a7b989f269f70b9310ac46b887538e704937,
         0x112682700dffb800dd157d67a3bb5164a11210bfb9bb22bf7bbc2544350a6fa8f7b7c2238902821c3039f3e744e8e71ee80e15062f99afe743bc12b3d2885c8389c441128888fd139c139e47f161262c96cbc26345d82d221e729ed0ff720],
        [0x14177ac1eef38d5c1caef3aba16a0db558d1caacb7eec703c3389c4a5c9d62cc86b9f9801bc3c5edfd1f7e11502bc3aa315175f20124f27e9178fe3c2c62e2aedc66fd7263c14f06c65d14ff3afde9f6c665aca19becbb9985a241d8a658],
        [0x3ffac563e71ee3d1dfefc6676ee523da57bea5a046afa3bf221b52cb08d821d3bcb3908728605d34fdbce0b7173d80b1123c40c643681c6667027c067bf38693e423a0bba7cbf1941e0968cdcddfe3ca9cad67864bfe7256b5354d13f6bf],
    ],
}


def merkle_leaves() -> list:
    return rand_below(poseidon_modulus("mnt4753"), 4, seed=81)


# ---------------------------------------------------------------------------
# Inputs of the inverse (csrc/fp_inv.cuh)
# ---------------------------------------------------------------------------

# What ``python3 tools/divsteps_model.py`` (seed 7, 6000 model runs a field)
# printed, by field name.  INV_LONGEST: the inputs other than powers of two
# that take the most passes of the kernel's inverse, then the most
# divsteps; every one takes the field's bound of passes, as 2^k near the
# top of p does.  INV_NEGATIVE_ROWS: inputs whose passes give a negative x
# row and a negative y row, which the kernel negates back (rare at random).
INV_LONGEST = {
    # 253 bits, bound 17 passes; (a, passes, divsteps)
    "bls12_377_fr": [
        (0xe10000000000000000000000000000000000000000000000000000000000000,
         17, 502),
        (0x1010420000000000000000000000000000000000000000000000000000000000,
         17, 498),
        (0xe14000000000000000000000000000000000000000000000000000000000000,
         17, 498),
        (0xe04000000000000000000000000000000000000000000000000000000000000,
         17, 498),
    ],
    # 377 bits, bound 25 passes; (a, passes, divsteps)
    "bls12_377_fq": [
        (0x14000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000,
         25, 751),
        (0x14ac0000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000,
         25, 750),
        (0x14a60000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000,
         25, 750),
        (0x14a40000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000,
         25, 750),
    ],
    # 753 bits, bound 49 passes; (a, passes, divsteps)
    "mnt4753_fq": [
        (0x110000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000,
         49, 1503),
        (0x108000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000,
         49, 1503),
        (0x110880000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000,
         49, 1501),
        (0x108800000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000,
         49, 1501),
    ],
    # 753 bits, bound 49 passes; (a, passes, divsteps)
    "mnt6753_fq": [
        (0x110000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000,
         49, 1502),
        (0x108800000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000,
         49, 1502),
        (0x108000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000,
         49, 1502),
        (0x110000400000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000,
         49, 1500),
    ],
}
INV_NEGATIVE_ROWS = {
    # 253 bits, bound 17 passes; (a, passes with a negative x row, with a negative y row)
    "bls12_377_fr": [
        (0x12ab655e9a2ca55660b44d1e5c37b00159aa76fed00000010a117f2becc19ead,
         1, 1),
        (0x12ab655e9a2ca55660b44d154258d4b84b63aa4b543e42400dcc9eb43d04843d,
         1, 1),
        (0x12ab655e9a2ca55660b44d1e5c3549ad22b401324e18b10b212f226bf126fb8b,
         0, 1),
        (0x12ab655e9a2ca55660b44d1e5c37b00159aa76fed00000010a117fffffc87e4d,
         0, 1),
    ],
    # 377 bits, bound 25 passes; (a, passes with a negative x row, with a negative y row)
    "bls12_377_fq": [
        (0x1ae3a460a11ae1dbf8daa9b664b58ff7acde7005f44afae88c87c41a7cf474dc7d96e3ff083213c25fde9320fd4db0b,
         1, 0),
        (0x1ae3a4607e5c7a637daa21c04b72c325a89fbd312acadbb85db585ac55eef417416d840bbef5b99674a3eca8234c3b0,
         1, 0),
        (0x1ae3a4617c510eac63b05c06ca099361089891ac9fe9dc29d0c1339d126ea6c083258ce9ace67a3276af607e7e717ef,
         0, 1),
        (0x1ae3a4617c510eac63b05c06ca1493b1a22d9f2f96424b3b24618092cf7d931ffd2656af263e8dc7326b47094f2ab65,
         0, 1),
    ],
    # 753 bits, bound 49 passes; (a, passes with a negative x row, with a negative y row)
    "mnt4753_fq": [
        (0x1c4c62d92c41110229022eee2cdadb7f997505b8fafed5eb7e8f96c97d87307fdb925e8a0ed8d99d124d9a15af79db117e776f218059db80f0da5cb537e315589de971f4978e76c483cc6aac8c32d3af24e299fbd0234cc2872096a587187,
         1, 1),
        (0x1c4c62d92c41110229022eee2cdadb7f997505b8fafed5eb7e8f96c97d87307fdb925e8a0ed8d99d124d9a15af79db117e776f218059db80f0da5cb537e38685acce97672514db543f24f11a6acb3c2250088efe28260d88f93bd71050115,
         1, 1),
        (0x1c4c62d92c41110229022eee2cdadb7f997505b8fafed5eb7e8f96c97d87307fdb925e8a0ed8d99d124d9a15af79db117e776f218059db80f0da5cb537e38685acce9767254a4638810719ac41d0856c223f24faefb95f059b92d52a22d27,
         0, 1),
        (0x1c4c62d92b34cc7f5f366ab9f70e8894b9180c4bee38d89f55ccaf07153f404e72887ace503a2f13c985065f971278a5c69b9c4fb6aada2d0917ba4b0bd7b2d4844e981447547022376a7b869afeb34d6642dd104a45e62074893ba0da0b3,
         0, 1),
    ],
    # 753 bits, bound 49 passes; (a, passes with a negative x row, with a negative y row)
    "mnt6753_fq": [
        (0x1c4c62d92c4111005f07827a324a5943218d59bcb6ff57b3592660d14a9bc2a1a44544a40d89daab80af58d7126e179f63e60f324e913516f6cf400f2deaab0a7da7b6817d74ea4d12ff955610d0497046db397d90cfad5ccca0b5b9ac2cb,
         1, 1),
        (0x1c4c62d92c41110229022eee2cdadb7f997505b8fafed5eb7e8f96c97d87307fdb925e8a0ed8d99d124d9a15af79db26c5c28c859a99b3eebca9429212636b9dff96a1445a08c45b134a8ed24f3337a1bd96a516d0d6f67be5042940052cf,
         1, 0),
        (0x1c4c62d92c41110229022eee2cdadb7f997505b8fafed5eb7e8f96c97d87307fdb925e8a0ed8d99d124d9a15af79db26c5c28c859a99b3eebca9429212636b9dff97634993aa4d6c381bc3f004eaec1c568b7327324466ad0cc316e43ad27,
         0, 1),
        (0x1c4c62d92b34cc7f5f366ab9f70e8894b9180c4bee38d89f55ccaf07153f404e72887ace503a2f13c985065f971278bb0de6b9b3d0eab29ad4e6a027e65797ecd71763f6b5b47755ee7f25ca5e1919fd9a8f2b3c8cd0edc7e5b97d5af20b3,
         0, 1),
    ],
}


def inv_inputs(modulus: int, name: str, seed: int = 11) -> dict:
    """{kind: [plain integers below the modulus]} for a test of the inverse:
    seeded random values, the edge values, 2^k for every k below bits(p),
    runs of all-ones 32-bit limbs (every start and length below p) and of
    ones bits (every 8th length, every 29th shift), and ``INV_LONGEST`` and
    ``INV_NEGATIVE_ROWS`` of the field ``name``."""
    bits = modulus.bit_length()
    limbs = -(-bits // 32)
    limb_runs = [((1 << 32 * w) - 1) << 32 * s for w in range(1, limbs + 1)
                 for s in range(limbs - w + 1)]
    return {
        "random": rand_below(modulus, 64, seed),
        "edges": [0, 1, 2, modulus - 1, (modulus - 1) // 2],
        "powers_of_two": [1 << k for k in range(bits)],
        "ones_runs": [v for v in limb_runs if v < modulus] + [
            ((1 << w) - 1) << s for w in range(1, bits, 8)
            for s in range(0, bits - w, 29)],
        "longest": [a for a, _, _ in INV_LONGEST[name]],
        "negative_rows": [a for a, _, _ in INV_NEGATIVE_ROWS[name]],
    }


# ---------------------------------------------------------------------------
# the RNS kernels' constant blocks
# ---------------------------------------------------------------------------

def from_fragments(frag, K, N):
    """[K, N] from the B operand of mma.m16n8k32 with u8 elements in
    fragment order [K/32, N/8, plane, lane, register]: lane 4 g + t holds
    in register r the elements of rows 4 t + 16 r .. + 3 (of its k-step),
    column g (of its n-tile), the first in the low byte."""
    f = np.asarray(frag, np.int64).reshape(K // 32, N // 8, 2, 32, 2)
    out = np.zeros((K, N), np.int64)
    for s in range(K // 32):
        for j in range(N // 8):
            for lane in range(32):
                g, t = divmod(lane, 4)
                for r in range(2):
                    for i in range(4):
                        lo = f[s, j, 0, lane, r] >> (8 * i) & 0xFF
                        hi = f[s, j, 1, lane, r] >> (8 * i) & 0xFF
                        out[32 * s + 16 * r + 4 * t + i, 8 * j + g] = \
                            lo | hi << 8
    return out

"""Curve parameters: BN254 (alt_bn128) and BLS12-381.

Generators match arkworks' (``ark-bn254``, ``ark-bls12-381``), which are the
standard published generators -- required for proof bit-exactness with the
reference KZG (``multilinear_kzg/src/trusted_setup.rs:51-74`` uses
``P::G1::generator()``).

A copy of :mod:`tpu_zk.curves.params` (this package imports nothing of
``tpu_zk``); ``tests/test_torch_curves_kzg.py`` checks that the two agree.
"""

from ..fields.primes import BLS12_381_FQ, BLS12_381_FR, BN254_FQ, BN254_FR

# --- BN254 ------------------------------------------------------------------
BN254 = dict(
    name="bn254",
    fq="bn254_fq",
    fr="bn254_fr",
    p=BN254_FQ,
    r=BN254_FR,
    b=3,
    # G1 generator
    g1=(1, 2),
    # Fq2 non-residue for the tower (i^2 = -1), sextic twist xi = 9 + i
    xi=(9, 1),
    twist="D",  # E': y^2 = x^3 + b/xi
    # G2 generator ((x_c0, x_c1), (y_c0, y_c1)) -- arkworks/ethereum standard
    g2=(
        (
            10857046999023057135944570762232829481370756359578518086990519993285655852781,
            11559732032986387107991004021392285783925812861821192530917403151452391805634,
        ),
        (
            8495653923123431417604973247489272438418190587263600148770280649306958101930,
            4082367875863433681332203403145435568316851327593401208105741076214120093531,
        ),
    ),
    # BN parameter u and the optimal-ate loop count 6u+2
    u=4965661367192848881,
    ate_loop=6 * 4965661367192848881 + 2,
    ate_is_negative=False,
    bn_final_steps=True,  # extra Q1/Q2 Frobenius line steps after the loop
)

# --- BLS12-381 --------------------------------------------------------------
BLS12_381 = dict(
    name="bls12_381",
    fq="bls12_381_fq",
    fr="bls12_381_fr",
    p=BLS12_381_FQ,
    r=BLS12_381_FR,
    b=4,
    g1=(
        int(
            "17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
            "6c55e83ff97a1aeffb3af00adb22c6bb",
            16,
        ),
        int(
            "08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3ed"
            "d03cc744a2888ae40caa232946c5e7e1",
            16,
        ),
    ),
    xi=(1, 1),  # sextic twist xi = 1 + i
    twist="M",  # E': y^2 = x^3 + b*xi
    g2=(
        (
            int(
                "024aa2b2f08f0a91260805272dc51051c6e47ad4fa403b02b4510b647ae3d177"
                "0bac0326a805bbefd48056c8c121bdb8",
                16,
            ),
            int(
                "13e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049"
                "334cf11213945d57e5ac7d055d042b7e",
                16,
            ),
        ),
        (
            int(
                "0ce5d527727d6e118cc9cdc6da2e351aadfd9baa8cbdd3a76d429a695160d12c"
                "923ac9cc3baca289e193548608b82801",
                16,
            ),
            int(
                "0606c4a02ea734cc32acd2b02bc28b99cb3e287e85a763af267492ab572e99ab"
                "3f370d275cec1da1aaa9075ff05f79be",
                16,
            ),
        ),
    ),
    u=-0xD201000000010000,
    ate_loop=0xD201000000010000,  # |x|
    ate_is_negative=True,
    bn_final_steps=False,
)

CURVES = {"bn254": BN254, "bls12_381": BLS12_381}

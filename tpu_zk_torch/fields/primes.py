"""Prime moduli of the four fields, and their serialized byte widths.

Copied from :mod:`tpu_zk.fields.primes`: this package must not import
``tpu_zk`` (which pulls in JAX).  ``tests/test_torch_fields.py`` checks that
the two copies agree.
"""

# BN254 (alt_bn128) base field modulus
BN254_FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# BN254 scalar field modulus
BN254_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BLS12-381 base field modulus
BLS12_381_FQ = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab",
    16,
)
# BLS12-381 scalar field modulus
BLS12_381_FR = int(
    "73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001", 16
)

PRIMES = {
    "bn254_fq": BN254_FQ,
    "bn254_fr": BN254_FR,
    "bls12_381_fq": BLS12_381_FQ,
    "bls12_381_fr": BLS12_381_FR,
}

# Bytes of arkworks' ``into_bigint().to_bytes_be()`` for each field (number of
# 64-bit words * 8); transcript bytes depend on it.
SERIALIZED_BYTES = {
    "bn254_fq": 32,
    "bn254_fr": 32,
    "bls12_381_fq": 48,
    "bls12_381_fr": 32,
}

"""CKKS evaluator of the port vs the JAX package with a forced
``digit_group=2`` (two special primes): the grouped digit decomposition and
the single-shot mod-down that the next slice stands on (mirrors
tests/test_digit_group.py).  Cases: torch_eval_cases.py."""

import pytest

import torch_eval_cases as cases
from torch_eval_cases import (  # noqa: F401  (collected from this module)
    test_accumulate_bit_exact,
    test_decrypt_after_ops_is_right,
    test_errors,
    test_hoisted_key_fallback_matches_keygen_variant,
    test_key_switch_and_digits_bit_exact,
)

OPS = {**cases.OPS, **cases.GROUPED_OPS}


@pytest.fixture(scope="module")
def sides():
    return cases.build_sides(2)


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_bit_exact(sides, op):
    j, t, _ = sides
    cases.assert_same_ct(OPS[op](t), cases.run_jax(j, OPS[op]))

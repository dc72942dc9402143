"""CKKS evaluator of the port vs the JAX package, G=1 / one special prime
(the layout of every registered N=8192 context).  Cases: torch_eval_cases.py."""

import pytest

import torch_eval_cases as cases
from torch_eval_cases import (  # noqa: F401  (collected from this module)
    test_accumulate_bit_exact,
    test_accumulate_tree_rotations_match,
    test_decrypt_after_ops_is_right,
    test_errors,
    test_hoisted_key_fallback_matches_keygen_variant,
    test_key_switch_and_digits_bit_exact,
    test_lazy_ok_is_plan_lazy,
)


@pytest.fixture(scope="module")
def sides():
    return cases.build_sides(None)


@pytest.mark.parametrize("op", sorted(cases.OPS))
def test_op_bit_exact(sides, op):
    j, t, _ = sides
    cases.assert_same_ct(cases.OPS[op](t), cases.run_jax(j, cases.OPS[op]))

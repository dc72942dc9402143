"""Limb-sharded CKKS ciphertexts through the port's plain ``Evaluator`` vs
the JAX package's unsharded results, G=1, one special prime (the layout of the registered N=8192 contexts).  Cases, tolerance and collective
counts: torch_limb_cases.py.

Cold wall time of the file alone (empty JAX cache): see CHANGES.md."""

import pytest

import torch_limb_cases as cases


@pytest.fixture(scope="module")
def built():
    return cases.build(None)


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "nonlazy"])
@pytest.mark.parametrize("mesh_kind", sorted(cases.MESHES))
def test_limb_sharded_ops_bit_exact(built, mesh_kind, lazy, monkeypatch):
    cases.run(built, mesh_kind, lazy, monkeypatch)

"""The port's serving engine against the JAX engine on the reduced
granite-3-2b config (GQA, rmsnorm, swiglu): greedy tokens equal at equal
pool size and submission order, with the int8 KV cache.  Its own file so
that the JAX engine's compile time lands on its own test worker."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_serve import engine_parity  # noqa: E402


def test_engine_greedy_tokens_equal_jax_granite():
    want, got = engine_parity("granite-3-2b")
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid

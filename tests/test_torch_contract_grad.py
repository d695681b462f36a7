"""The gradient of the factored big-clique contraction.

``factored_contract_grads`` (the plain backward pass) and the
``torch.autograd.Function`` behind ``factored_masked_contract`` against
``torch.autograd.grad`` / ``gradcheck`` of the plain version in float64
(limit 1e-12 of max|grad|: the same sums in another order), through
``big_clique_sep_message`` with an expanded ``w2`` and sep-scoped masks, and
one learning step with the route taken against the JAX package (its Pallas
kernel in interpret mode for the forward value; rtol 1e-8 in float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu import learn as jlearn
from junctiontree_tpu.config import DEFAULT as JAX_DEFAULT
from junctiontree_tpu.ops import pallas_contract as jax_pc
from junctiontree_tpu_torch import learn
from junctiontree_tpu_torch.config import DEFAULT
from junctiontree_tpu_torch.ops import factored_contract as fc
from junctiontree_tpu_torch.utils.timing import TIMERS


SHAPES = [(3, 5, 2, 4), (1, 7, 1, 3), (4, 6, 40, 5), (64, 8, 1, 2),
          (2, 3, 33, 1), (5, 1, 3, 6)]


def _operands(shape, seed, dtype=torch.float64):
    R1, R2, C, B = shape
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.tensor(rng.random(s) + 0.1, dtype=dtype)
    return mk(R1, R2, C), mk(B, R1), mk(B, R2), mk(B, C)


@pytest.fixture
def backward_contractions(monkeypatch):
    """The contractions that backward passes of the Function make, as a
    list that grows by one per ``dw1`` or ``dw2``."""
    made = []
    inner = fc._contract_on_device

    def counting(pot, w1, w2, backward=False, precision="highest"):
        if backward:
            made.append(tuple(pot.shape))
        return inner(pot, w1, w2, backward, precision)

    monkeypatch.setattr(fc, "_contract_on_device", counting)
    return made


def _close(got, want, limit=1e-12):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= limit * max(scale, 1e-300)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_grads_match_autograd(shape):
    pot, w1, w2, g = _operands(shape, 0)
    leaves = [t.clone().requires_grad_(True) for t in (pot, w1, w2)]
    want = torch.autograd.grad(fc.reference_factored_contract(*leaves), leaves, g)
    got = fc.factored_contract_grads(pot, w1, w2, g)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b)


@pytest.mark.parametrize("shape", SHAPES)
def test_function_grads_match_autograd(shape, backward_contractions):
    pot, w1, w2, g = _operands(shape, 1)
    leaves = [t.clone().requires_grad_(True) for t in (pot, w1, w2)]
    want = torch.autograd.grad(fc.reference_factored_contract(*leaves), leaves, g)
    out = fc.factored_masked_contract(*leaves)
    assert type(out.grad_fn).__name__ == "_FactoredContractBackward"
    _close(out.detach(), fc.reference_factored_contract(pot, w1, w2))
    got = torch.autograd.grad(out, leaves, g)
    R1, R2, C, B = shape
    assert backward_contractions == [(C, R2, R1), (C, R1, R2)]
    # no kernel on the CPU: the launch counts stand still
    assert not TIMERS.counters()["factored_masked_contract.launches_backward"]
    for a, b in zip(got, want):
        _close(a, b)


def test_gradcheck():
    pot, w1, w2, _ = _operands((3, 4, 2, 3), 2)
    leaves = [t.requires_grad_(True) for t in (pot, w1, w2)]
    assert torch.autograd.gradcheck(fc.factored_masked_contract, leaves)
    assert torch.autograd.gradcheck(fc.reference_factored_contract, leaves)


def test_dpot_is_chunked_over_r1(monkeypatch):
    pot, w1, w2, g = _operands((7, 5, 3, 4), 3)
    whole = fc.factored_contract_grads(pot, w1, w2, g)[0]
    monkeypatch.setattr(fc, "DPOT_CHUNK_ELEMS", 2 * 4 * 3)  # two r1 a time
    _close(fc.factored_contract_grads(pot, w1, w2, g)[0], whole, 1e-15)


@pytest.mark.parametrize("needs", [(True, False, False), (False, True, False),
                                   (False, False, True), (False, True, True)])
def test_needs_input_grad_skips(needs, monkeypatch):
    """Only the gradients that an input asks for are computed: each weight
    gradient is one contraction, the potential's gradient is none."""
    pot, w1, w2, g = _operands((3, 5, 2, 4), 4)
    leaves = [t.clone().requires_grad_(n) for t, n in zip((pot, w1, w2), needs)]
    made = []
    inner = fc._contract_on_device
    monkeypatch.setattr(
        fc, "_contract_on_device",
        lambda p, a, b, backward=False, precision="highest":
        made.append(backward) or inner(p, a, b, backward, precision))
    out = fc.factored_masked_contract(*leaves)
    wanted = [t for t in leaves if t.requires_grad]
    got = torch.autograd.grad(out, wanted, g)
    assert made == [False] + [True] * (needs[1] + needs[2])
    ref = [t.clone().detach().requires_grad_(True) for t in (pot, w1, w2)]
    want = torch.autograd.grad(fc.reference_factored_contract(*ref), ref, g)
    for a, b in zip(got, [w for w, n in zip(want, needs) if n]):
        _close(a, b)


def test_no_grad_means_no_function():
    pot, w1, w2, _ = _operands((3, 5, 2, 4), 5)
    assert fc.factored_masked_contract(pot, w1, w2).grad_fn is None
    pot.requires_grad_(True)
    with torch.no_grad():
        assert fc.factored_masked_contract(pot, w1, w2).grad_fn is None


def test_bf16_input_requiring_grad_raises():
    pot, w1, w2, _ = _operands((3, 5, 2, 4), 6, torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        fc.factored_masked_contract(
            pot.to(torch.bfloat16).requires_grad_(True), w1, w2)
    # bf16 storage without a gradient still serves
    out = fc.factored_masked_contract(pot.to(torch.bfloat16), w1, w2)
    assert out.dtype == torch.float32


def _route_case(seed):
    """A clique over 6 variables, separator of 2, masks on one rest and one
    separator variable, a rest-scoped message: w2 is expanded over the
    unobserved rest variables."""
    rng = np.random.default_rng(seed)
    cvars = [0, 1, 2, 3, 4, 5]
    shape = (2, 3, 2, 2, 3, 2)
    B = 4
    pot = torch.tensor(rng.random(shape) + 0.1)
    masks = {1: torch.tensor(rng.random((B, 3)) + 0.1),
             4: torch.tensor(rng.random((B, 3)) + 0.1)}
    msg = ((0, 2), torch.tensor(rng.random((B, 2, 2)) + 0.1))
    return pot, cvars, masks, [4, 5], msg


def _route_dense(pot, cvars, masks, sep, msg):
    """The same message by one dense einsum."""
    letters = "abcdef"
    ops, subs = [pot], [letters]
    for v, m in masks.items():
        ops.append(m)
        subs.append("z" + letters[v])
    ops.append(msg[1])
    subs.append("z" + "".join(letters[v] for v in msg[0]))
    return torch.einsum(
        ",".join(subs) + "->z" + "".join(letters[v] for v in sep), *ops)


def test_gradient_through_big_clique_sep_message(backward_contractions):
    pot, cvars, masks, sep, msg = _route_case(7)
    leaves = [pot, masks[1], masks[4], msg[1]]

    def run(fn):
        ls = [t.clone().requires_grad_(True) for t in leaves]
        out = fn(ls[0], cvars, {1: ls[1], 4: ls[2]}, sep, (msg[0], ls[3]))
        return out, torch.autograd.grad(out.sum() + (out ** 2).sum(), ls)

    out, got = run(lambda p, c, m, s, g: fc.big_clique_sep_message(
        p, c, m, s, msgs=[g]))
    assert len(backward_contractions) == 2
    ref, want = run(_route_dense)
    _close(out.detach(), ref.detach())
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b)


def _dense_model(n=9, seed=0):
    """One dense factor over n binary variables plus n unaries and a
    two-variable tail on each: the big clique's messages depend on the
    parameters, so both weight gradients are taken."""
    rng = np.random.default_rng(seed)
    names = [f"v{i}" for i in range(n)]
    tails = [f"t{i}" for i in range(n)]
    factors = [names[:]] + [[x] for x in names] + [[x, t] for x, t in zip(names, tails)]
    sizes = {x: 2 for x in names + tails}
    values = [rng.random((2,) * n) + 0.1] + [rng.random(2) + 0.1 for _ in names] \
        + [rng.random((2, 2)) + 0.1 for _ in tails]
    return factors, sizes, values


@pytest.fixture
def routed(monkeypatch):
    """Both packages route cliques of >= 2^8 states; the JAX package runs
    its Pallas kernel in interpret mode."""
    monkeypatch.setattr(DEFAULT, "big_clique_min_states", 1 << 8)
    monkeypatch.setattr(JAX_DEFAULT, "pallas_min_states", 1 << 8)
    jax_pc.set_pallas_mode("interpret")
    yield
    jax_pc.set_pallas_mode("auto")


def test_learning_step_with_route_matches_jax(routed, backward_contractions):
    factors, sizes, values = _dense_model()
    plan = jt.compile_plan(factors, sizes)
    jplan = jt_jax.compile_plan(factors, sizes)
    rng = np.random.default_rng(1)
    data = rng.integers(0, 2, size=(6, plan.num_vars))
    data[rng.random(data.shape) < 0.3] = -1
    masks = learn.masks_from_data(plan, data)
    route_calls = TIMERS.counters()["big_clique_sep_message.calls"]
    counts = learn.expected_counts(plan, values, masks, device="cpu",
                                   dtype=torch.float64)
    assert TIMERS.counters()["big_clique_sep_message.calls"] > route_calls
    assert len(backward_contractions) > 0
    # forward value against the JAX package with its kernel interpreted
    thetas = [np.log(v) for v in values]
    ll = learn.marginal_log_likelihood(plan, thetas, masks, device="cpu",
                                       dtype=torch.float64)
    jll = jlearn.marginal_log_likelihood(
        jplan, [jnp.asarray(t) for t in thetas], [jnp.asarray(m) for m in masks])
    np.testing.assert_allclose(float(ll), float(jll), rtol=1e-8)
    # gradients (expected counts) against the JAX package's einsum route
    jax_pc.set_pallas_mode("auto")
    jcounts = jlearn.expected_counts(jplan, values, [jnp.asarray(m) for m in masks])
    for c, jc in zip(counts, jcounts):
        np.testing.assert_allclose(c, np.asarray(jc), rtol=1e-8, atol=1e-10)
    # and against the port's own einsum route (the route off)
    DEFAULT.big_clique_min_states = 1 << 30
    plain = learn.expected_counts(plan, values, masks, device="cpu",
                                  dtype=torch.float64)
    for c, p in zip(counts, plain):
        np.testing.assert_allclose(c, p, rtol=1e-10, atol=1e-12)

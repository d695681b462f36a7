"""The port's log-depth chain program (``scan_executor.
chain_posterior_parallel_program``) and ``Engine.shard_sequence``, case for
case with the scan tests of ``tests/test_scan_executor.py``: against the JAX
package's ``chain_posterior_parallel_program`` and the port's sequential
program in float64 (rtol 1e-9), over one block and over blocks of the step
axis on the ``["cpu"] * 8`` mesh."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu.scan_executor import ChainLayout as JaxChainLayout
from junctiontree_tpu.scan_executor import (
    chain_posterior_parallel_program as jax_parallel_program,
)
from junctiontree_tpu_torch.models import chain_bn_model, grid_mrf_model
from junctiontree_tpu_torch.parallel import make_mesh
from junctiontree_tpu_torch.scan_executor import (
    ChainLayout,
    StackedPosteriors,
    _scan_products,
    chain_posterior_parallel_program,
    chain_posterior_program,
    stack_chain_potentials,
)

CPU8 = ["cpu"] * 8


def _programs(n, card, seed):
    factors, sizes, values = chain_bn_model(n, card=card, seed=seed)
    plan = jt.compile_plan(factors, sizes)
    eng = jt.Engine(plan, device="cpu", dtype=torch.float64).set_potentials(values)
    layout = ChainLayout.detect(plan)
    A = stack_chain_potentials(layout, eng._pots_np)
    return factors, sizes, values, plan, layout, A


def _close(post, logz, ref_post, ref_logz, rtol=1e-9):
    ref_post, ref_logz = np.asarray(ref_post), np.asarray(ref_logz)
    np.testing.assert_array_equal(np.isneginf(logz.numpy()), np.isneginf(ref_logz))
    fin = np.isfinite(ref_logz)
    np.testing.assert_allclose(logz.numpy()[fin], ref_logz[fin], rtol=rtol)
    np.testing.assert_allclose(post.numpy(), ref_post, rtol=rtol, atol=1e-14)


@pytest.mark.parametrize("n,card,blocks", [(30, 2, 1), (17, 3, 1), (65, 2, 8),
                                           (30, 2, 3), (17, 3, 5)])
def test_parallel_program_matches_jax_and_sequential(n, card, blocks):
    """Evidence on the middle variable in both states; the step axis in
    ``blocks`` consecutive blocks (65 variables: 64 steps over 8)."""
    factors, sizes, values, plan, layout, A = _programs(n, card, seed=n)
    vid = plan.table.id_of(f"x{n // 2}")
    mask = np.stack([np.eye(card)[s] for s in (0, 1)])
    blocks_A = list(torch.tensor_split(torch.as_tensor(A), blocks))
    post, logz = chain_posterior_parallel_program(plan, layout)(
        blocks_A if blocks > 1 else blocks_A[0], {vid: torch.as_tensor(mask)})
    assert post.shape == (n, 2, card) and logz.shape == (2,)
    seq_post, seq_logz = chain_posterior_program(plan, layout)(
        torch.as_tensor(A), {vid: torch.as_tensor(mask)})
    _close(post, logz, seq_post.numpy(), seq_logz.numpy())
    jplan = jt_jax.compile_plan(factors, sizes)
    jvid = jplan.table.id_of(f"x{n // 2}")
    jpost, jlogz = jax_parallel_program(jplan, JaxChainLayout.detect(jplan))(
        jnp.asarray(A), {jvid: jnp.asarray(mask)})
    _close(post, logz, jpost, jlogz)


@pytest.mark.parametrize("blocks", [1, 4])
def test_parallel_program_impossible_row(blocks):
    """A row whose evidence has probability zero: zero posteriors and
    logZ = -inf (the port's contract), the other rows as the sequential
    program gives them; no NaN."""
    factors, sizes, values, plan, layout, A = _programs(40, 3, seed=2)
    rng = np.random.default_rng(0)
    M = (rng.random((40, 5, 3)) < 0.7).astype(np.float64)
    M[:, 2] = 1.0
    M[10, 2] = 0.0   # row 2: no state allowed at position 10
    A_blocks = list(torch.tensor_split(torch.as_tensor(A), blocks))
    post, logz = chain_posterior_parallel_program(plan, layout)(
        A_blocks if blocks > 1 else A_blocks[0], torch.as_tensor(M))
    seq_post, seq_logz = chain_posterior_program(plan, layout)(
        torch.as_tensor(A), torch.as_tensor(M))
    assert torch.isneginf(logz[2]) and not torch.isnan(post).any()
    assert (post[:, 2] == 0).all()
    _close(post, logz, seq_post.numpy(), seq_logz.numpy())


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_keeps_matrix_order_for_k3(reverse):
    """K = 3 matrices do not commute: the prefix scan gives
    X_0 ... X_k and the suffix scan X_k ... X_{n-1}, each in forward matrix
    order, up to the max-normalization its offsets undo."""
    rng = np.random.default_rng(7)
    n, B, K = 11, 2, 3
    X = rng.random((n, B, K, K)) + 0.05
    assert not np.allclose(X[0, 0] @ X[1, 0], X[1, 0] @ X[0, 0])
    got, off = _scan_products(torch.as_tensor(X), torch.zeros((n, B),
                              dtype=torch.float64), reverse)
    got = got.numpy() * np.exp(off.numpy())[..., None, None]
    for k in range(n):
        span = range(k, n) if reverse else range(k + 1)
        for b in range(B):
            want = np.eye(K)
            for i in span:
                want = want @ X[i, b]
            np.testing.assert_allclose(got[k, b], want, rtol=1e-12)


def test_engine_shard_sequence_picks_parallel_program():
    """``shard_sequence`` on a chain engine serves ``posterior_batch``
    through the log-depth program with the 64 steps split 8 per device, and
    matches the sequential engine and the JAX package's sharded engine."""
    from junctiontree_tpu.parallel.mesh import make_mesh as jax_make_mesh

    n = 65
    factors, sizes, values = chain_bn_model(n, seed=9)
    plan = jt.compile_plan(factors, sizes)
    B = 4
    rng = np.random.default_rng(1)
    masks = {}
    for name in ("x3", "x40"):
        m = np.zeros((B, 2))
        m[np.arange(B), rng.integers(0, 2, B)] = 1.0
        masks[name] = m
    ref = jt.Engine(plan, device="cpu", dtype=torch.float64).set_potentials(values)
    post_ref, logz_ref = ref.posterior_batch(masks)

    eng = jt.Engine(plan, device="cpu", dtype=torch.float64).set_potentials(values)
    assert eng.shard_sequence(make_mesh(8, 1, devices=CPU8), min_len=16) is eng
    post, logz = eng.posterior_batch(masks)
    assert isinstance(post, StackedPosteriors)
    assert ("chain_parallel",) in eng._programs
    assert [tuple(a.shape) for a in eng._chain_A] == [(8, 2, 2)] * 8
    _close(post.stacked, logz, post_ref.stacked.numpy(), logz_ref.numpy())

    jeng = jt_jax.create_junction_tree(factors, sizes).engine().set_potentials(values)
    jeng.shard_sequence(jax_make_mesh(n_batch=8, n_model=1), min_len=16)
    jpost, jlogz = jeng.posterior_batch(masks)
    np.testing.assert_allclose(logz.numpy(), np.asarray(jlogz), rtol=1e-9)
    for v in range(n):
        np.testing.assert_allclose(post[v].numpy(), np.asarray(jpost[v]),
                                   rtol=1e-9, atol=1e-14)


def test_engine_shard_sequence_short_chain_stays_sequential():
    """Below ``min_len`` the sequential program is kept."""
    factors, sizes, values = chain_bn_model(20, seed=3)
    plan = jt.compile_plan(factors, sizes)
    eng = jt.Engine(plan, device="cpu", dtype=torch.float64).set_potentials(values)
    eng.shard_sequence(make_mesh(8, 1, devices=CPU8), min_len=1000)
    masks = {"x5": np.array([[1.0, 0.0]])}
    post, logz = eng.posterior_batch(masks)
    assert ("chain",) in eng._programs and ("chain_parallel",) not in eng._programs
    assert isinstance(eng._chain_A, torch.Tensor)
    ref = jt.Engine(plan, device="cpu", dtype=torch.float64).set_potentials(values)
    post_r, logz_r = ref.posterior_batch(masks)
    assert torch.equal(logz, logz_r) and torch.equal(post.stacked, post_r.stacked)


def test_shard_sequence_ignored_off_chains():
    """A plan that is not a chain serves as without the setting."""
    factors, sizes, values = grid_mrf_model(3, 3, seed=1)
    plan = jt.compile_plan(factors, sizes)
    eng = jt.Engine(plan, device="cpu", dtype=torch.float64).set_potentials(values)
    eng.shard_sequence(make_mesh(devices=CPU8), min_len=2)
    masks = {"g0_0": np.array([[1.0, 0.0], [0.0, 1.0]])}
    post, logz = eng.posterior_batch(masks)
    ref = jt.Engine(plan, device="cpu", dtype=torch.float64).set_potentials(values)
    post_r, logz_r = ref.posterior_batch(masks)
    assert eng._route("auto") == "general" and torch.equal(logz, logz_r)
    assert all(torch.equal(a, b) for a, b in zip(post, post_r))

"""The measured comparison of the kernel with the library
(``junctiontree_tpu_torch/ops/autotune.py``) against the JAX package's
``junctiontree_tpu/ops/autotune.py``, case for case with
``tests/test_autotune.py``: the same injected timings go through both
packages' ``decide`` / ``_reconcile`` / ``measure``, and the winners,
demotions, margins and validation counts must agree, the JAX package's
"pallas" and "xla" read as the port's "k1" and "library".

The JAX cases that route to XLA when the Pallas kernel fails (a permanent
"compile failed" entry, ``measure`` returning an error record, a transient
revalidation failure, a raising ``measure`` serving the cached winner) run
in both packages side by side: where the JAX package records or serves a
route, the port raises and leaves no entry.  The infeasible-tiling case has
no counterpart (the port's kernel has no VMEM tiling to refuse).

Then the port's own rules: ``library_factored_contract`` against the JAX
package's ``reference_factored_contract`` on the same float64 numpy inputs
(rtol 1e-5 of the largest output: the JAX reference returns float32) and
against the port's plain version (rtol 1e-12, all three pairings, under
autograd too); no serving path consults ``decide``, and
``Engine.describe()["kernel_routing"]`` shows the table as the JAX engine's
does."""

import json

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu.ops import autotune as jax_autotune
from junctiontree_tpu.ops import pallas_contract as jax_pc
from junctiontree_tpu_torch.config import DEFAULT
from junctiontree_tpu_torch.ops import autotune
from junctiontree_tpu_torch.ops import factored_contract as fc
from junctiontree_tpu_torch.utils.timing import TIMERS

SHAPE = (8, 128, 128, 256)
KEY = "f32:8x128x128:B256:cpu"
JAX_KEY = "f32:8x128x128:B256"
# the JAX package's route names, as the port calls them
AS_PORT = {"pallas": "k1", "xla": "library"}
AS_JAX = {v: k for k, v in AS_PORT.items()}


@pytest.fixture(autouse=True)
def _isolated_caches(tmp_path, monkeypatch):
    for mod in (autotune, jax_autotune):
        monkeypatch.setattr(mod, "_CACHE", None)
        monkeypatch.setattr(mod, "_VALIDATED", set())
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    monkeypatch.setattr(DEFAULT, "autotune_cache_dir", str(tmp_path / "port"))
    monkeypatch.setattr(DEFAULT, "autotune", True)
    monkeypatch.setattr(jax_autotune, "cache_path",
                        lambda: str(tmp_path / "jax" / "autotune.json"))
    monkeypatch.setattr(jax_autotune, "_ENABLED", True)
    yield
    monkeypatch.setattr(autotune, "_CACHE", None)
    monkeypatch.setattr(jax_autotune, "_CACHE", None)


def _record(winner, k1_ms, library_ms):
    """A port measurement record."""
    return dict(winner=winner, k1_ms=k1_ms, library_ms=library_ms,
                k1_device_ms=k1_ms, library_device_ms=library_ms, flops=1,
                bytes=1, bound_ms=0.1, bound_by="operations")


def _jax_record(winner, k1_ms, library_ms):
    """The same measurement as the JAX package records it."""
    return dict(winner=AS_JAX[winner], pallas_ms=k1_ms, xla_ms=library_ms,
                flops=1, hbm_bytes=1, achieved_tflops=0.0,
                roofline_fraction=0.0)


def _write(winner, k1_ms, library_ms, **extra):
    """The same persisted entry in both packages' files."""
    for mod, key, rec in ((autotune, KEY, _record), (jax_autotune, JAX_KEY,
                                                     _jax_record)):
        with open(mod.cache_path(), "w") as f:
            json.dump({key: dict(rec(winner, k1_ms, library_ms), **extra)}, f)


def _disk(mod=autotune, key=KEY):
    with open(mod.cache_path()) as f:
        return json.load(f)[key]


def _measures(monkeypatch, *timings):
    """Both packages' ``measure`` replaced by the same measurements, one
    per call, each (winner, k1 ms, library ms); returns the calls made."""
    calls = {"port": 0, "jax": 0}

    def port(R1, R2, C, B, dtype="f32", device="cuda"):
        calls["port"] += 1
        return _record(*timings[calls["port"] - 1])

    def jax(R1, R2, C, B, dtype="f32"):
        calls["jax"] += 1
        return _jax_record(*timings[calls["jax"] - 1])

    monkeypatch.setattr(autotune, "measure", port)
    monkeypatch.setattr(jax_autotune, "measure", jax)
    return calls


def _decide(R1=8, R2=128, C=128, B=256, dtype="f32"):
    """Both packages' decision on one shape; they must agree."""
    got = autotune.decide(R1, R2, C, B, dtype=dtype, device="cpu")
    want = AS_PORT[jax_autotune.decide(R1, R2, C, B, dtype=dtype)]
    assert got == want
    return got


def _same_entry():
    """The persisted entries agree: winner, demotion, margin, validations
    and the timings."""
    mine, theirs = _disk(), _disk(jax_autotune, JAX_KEY)
    assert mine["winner"] == AS_PORT[theirs["winner"]]
    assert mine.get("demoted_from") == AS_PORT.get(theirs.get("demoted_from"))
    for field in ("margin", "validations"):
        assert mine.get(field) == theirs.get(field), field
    assert (mine["k1_ms"], mine["library_ms"]) == (theirs["pallas_ms"],
                                                   theirs["xla_ms"])
    return mine


def test_cache_lives_under_the_configured_directory(tmp_path, monkeypatch):
    assert autotune.cache_path() == str(tmp_path / "port" / "autotune.json")
    monkeypatch.setattr(DEFAULT, "autotune_cache_dir", None)
    assert autotune.cache_path().endswith(
        ".cache/junctiontree_tpu_torch/autotune.json")


def test_huge_library_intermediate_routes_to_k1_without_measuring(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("must not measure when the library would blow up")

    monkeypatch.setattr(autotune, "measure", boom)
    monkeypatch.setattr(jax_autotune, "measure", boom)
    R1, R2, C, B = 512, 512, 512, 8192
    assert min(B * R2 * C, B * R1 * C, B * R1 * R2) * 4 > 2 << 30
    assert _decide(R1, R2, C, B) == "k1"


def test_measured_winner_is_cached_in_memory_and_on_disk(monkeypatch):
    calls = _measures(monkeypatch, ("library", 2.0, 1.0), ("library", 2.0, 1.0))
    assert _decide() == "library"
    assert _decide() == "library"
    assert calls == {"port": 1, "jax": 1}  # second call from the validated cache
    ent = _same_entry()
    assert ent["margin"] == 2.0 and ent["ts"] > 0 and ent["validations"] == 1
    assert ent["k1_device_ms"] == 2.0 and ent["library_device_ms"] == 1.0
    # a fresh in-memory cache reloads the persisted decision; the key is
    # already validated by this process so no re-measurement happens
    monkeypatch.setattr(autotune, "_CACHE", None)
    monkeypatch.setattr(jax_autotune, "_CACHE", None)
    assert _decide() == "library"
    assert calls == {"port": 1, "jax": 1}
    # dtype is part of both keys, the card's name part of the port's
    assert _decide(dtype="bf16") == "library"
    assert calls == {"port": 2, "jax": 2}
    assert "bf16:8x128x128:B256:cpu" in autotune.report()


def test_stale_cached_winner_is_demoted_on_revalidation(monkeypatch):
    """A persisted winner that now loses by more than 10% is demoted the
    first time a new process consults it, in both packages."""
    _write("k1", 1.0, 2.0, validations=1)
    calls = _measures(monkeypatch, ("library", 1.35, 1.0))
    assert _decide() == "library"  # demoted
    ent = _same_entry()
    assert ent["demoted_from"] == "k1"
    assert ent["k1_ms"] == 1.35  # fresh timings replace stale ones
    assert ent["validations"] == 2
    assert _decide() == "library"
    assert calls == {"port": 1, "jax": 1}


@pytest.mark.parametrize("incumbent,k1_ms,library_ms", [
    ("k1", 1.05, 1.0), ("k1", 1.10, 1.0), ("k1", 1.11, 1.0), ("k1", 0.9, 1.0),
    ("library", 1.0, 1.05), ("library", 1.0, 1.2), ("library", 1.0, 0.5),
])
def test_revalidation_hysteresis_keeps_incumbent_within_margin(
        monkeypatch, incumbent, k1_ms, library_ms):
    """A fresh measurement within 10% of the incumbent keeps it; beyond,
    it is demoted; the timings are refreshed either way.  The port's
    ``decide`` and ``_reconcile`` answer as the JAX package's do."""
    other = "library" if incumbent == "k1" else "k1"
    _write(incumbent, 1.0, 1.0)
    fresh = ("k1" if k1_ms <= library_ms else "library", k1_ms, library_ms)
    _measures(monkeypatch, fresh)
    winner = _decide()
    ent = _same_entry()
    t = {"k1": k1_ms, "library": library_ms}
    assert winner == (other if t[incumbent] > 1.10 * t[other] else incumbent)
    assert ("demoted_from" in ent) == (winner != incumbent)
    assert (ent["k1_ms"], ent["library_ms"]) == (k1_ms, library_ms)
    old = _record(incumbent, 1.0, 1.0)
    rec = autotune._reconcile(old, _record(*fresh))
    jrec = jax_autotune._reconcile(_jax_record(incumbent, 1.0, 1.0),
                                   _jax_record(*fresh))
    assert rec["winner"] == AS_PORT[jrec["winner"]] == winner


def _timings(monkeypatch, k1=1.0, lib=2.0):
    """Stand-ins for the clocks of both packages: each candidate is run
    once and reported at fixed milliseconds (the JAX package's in
    seconds)."""
    def wall(fn, iters=5):
        fn()
        wall.n += 1
        return k1 if wall.n % 2 else lib

    def dev(fn):
        fn()
        dev.n += 1
        return k1 / 2 if dev.n % 2 else lib / 2

    def jax_time(fn, args, iters=5):
        jax_time.n += 1
        return (k1 if jax_time.n % 2 else lib) / 1e3

    wall.n = dev.n = jax_time.n = 0
    monkeypatch.setattr(autotune, "_wall_ms", wall)
    monkeypatch.setattr(autotune, "_device_ms", dev)
    monkeypatch.setattr(jax_autotune, "_time_once", jax_time)


@pytest.mark.parametrize("k1_ms,library_ms", [
    (1.0, 1.0), (1.05, 1.0), (1.10, 1.0), (1.2, 1.0), (0.5, 1.0), (3.0, 1.0)])
def test_measure_record_and_launch_counts(monkeypatch, k1_ms, library_ms):
    """``measure`` times both candidates (wall and device ms), gives a near
    tie (within 10%) to the kernel as the JAX package's tie band does,
    reports the card's bound, and leaves the kernel's launch counts as
    they were."""
    _timings(monkeypatch, k1=k1_ms, lib=library_ms)
    launches = ("factored_masked_contract.launches",
                "factored_masked_contract.launches_bf16",
                "factored_masked_contract.launches_backward")
    before = [TIMERS.counters()[n] for n in launches]
    rec = autotune.measure(64, 2048, 2, 4096, device="cpu")
    jrec = jax_autotune.measure(64, 2048, 2, 4096)
    assert [TIMERS.counters()[n] for n in launches] == before
    assert rec["winner"] == AS_PORT[jrec["winner"]]
    assert (rec["k1_ms"], rec["library_ms"]) == (jrec["pallas_ms"], jrec["xla_ms"])
    assert rec["k1_device_ms"] == round(k1_ms / 2, 4)
    assert rec["library_device_ms"] == round(library_ms / 2, 4)
    ops, nbytes, bound, by = autotune.contraction_bound(64, 2048, 2, 4096, False)
    assert rec["flops"] == ops == 2 * 4096 * 64 * 2048 * 2 + 2 * 4096 * 64 * 2
    assert rec["bound_ms"] == round(bound, 4) and by == "operations"


def _broken_kernels(monkeypatch):
    """Both packages' kernel wrappers fail when called."""
    def broken(*a, **k):
        raise RuntimeError("factored_contract kernel launch failed: no card")

    monkeypatch.setattr(fc, "factored_masked_contract", broken)
    monkeypatch.setattr(jax_pc, "factored_masked_contract", broken)


def _port_clocks(monkeypatch):
    """The port's clocks stubbed (each candidate still runs once); the JAX
    package's left alone, so its broken kernel fails in its own timing."""
    def wall(fn, iters=5):
        fn()
        return 1.0

    monkeypatch.setattr(autotune, "_wall_ms", wall)
    monkeypatch.setattr(autotune, "_device_ms", wall)


def test_kernel_failure_on_a_fresh_shape_raises_and_persists_nothing(monkeypatch):
    """Counterpart of a permanent "compile failed" route: where the JAX
    package records an "xla" entry with the error, a kernel that fails
    raises out of the port's ``decide``, and no entry records it."""
    _broken_kernels(monkeypatch)
    _port_clocks(monkeypatch)
    assert jax_autotune.decide(*SHAPE) == "xla"
    assert "compile failed" in _disk(jax_autotune, JAX_KEY)["error"]
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.decide(*SHAPE, device="cpu")
    assert autotune.report() == {}
    assert KEY not in autotune._VALIDATED


def test_measure_raises_on_kernel_failure(monkeypatch):
    """Counterpart of "measure survives a kernel compile failure": the JAX
    package returns an error record; the port's error propagates, with no
    record to route by."""
    _broken_kernels(monkeypatch)
    _port_clocks(monkeypatch)
    jrec = jax_autotune.measure(4, 8, 3, 5)
    assert jrec["winner"] == "xla" and "compile failed" in jrec["error"]
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.measure(4, 8, 3, 5, device="cpu")


def test_failed_revalidation_raises_and_keeps_the_persisted_entry(monkeypatch):
    """Counterpart of the transient revalidation failure: the JAX package
    keeps serving its incumbent and notes the failure; the port raises and
    leaves its healthy entry as it was, unvalidated."""
    _write("k1", 1.0, 2.0)
    good = _disk()
    _broken_kernels(monkeypatch)
    _port_clocks(monkeypatch)
    assert jax_autotune.decide(*SHAPE) == "pallas"
    assert "revalidation_error" in _disk(jax_autotune, JAX_KEY)
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.decide(*SHAPE, device="cpu")
    assert _disk() == good
    assert KEY not in autotune._VALIDATED


def test_raising_measure_is_not_hidden_behind_a_cached_winner(monkeypatch):
    """Counterpart of "a raising measure serves the cached winner": the JAX
    package serves it (or "xla" with no cache); the port raises, with or
    without a cached entry, and writes nothing."""
    _write("library", 2.0, 1.0)
    good = _disk()

    def raising_measure(*a, **k):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(autotune, "measure", raising_measure)
    monkeypatch.setattr(jax_autotune, "measure", raising_measure)
    assert jax_autotune.decide(*SHAPE) == "xla"  # its cached winner
    with pytest.raises(RuntimeError, match="out of memory"):
        autotune.decide(*SHAPE, device="cpu")
    assert _disk() == good
    monkeypatch.setattr(autotune, "_CACHE", {})
    with pytest.raises(RuntimeError, match="out of memory"):
        autotune.decide(*SHAPE, device="cpu")


def test_disabled_autotune_defaults_to_k1(monkeypatch):
    """Off, both answer the kernel without measuring; the port's
    ``set_enabled`` writes its one switch, ``config.DEFAULT.autotune``."""
    def boom(*a, **k):
        raise AssertionError("disabled autotune must not measure")

    monkeypatch.setattr(autotune, "measure", boom)
    monkeypatch.setattr(jax_autotune, "measure", boom)
    autotune.set_enabled(False)
    jax_autotune.set_enabled(False)
    assert DEFAULT.autotune is False
    assert _decide() == "k1"
    autotune.set_enabled(True)
    assert DEFAULT.autotune is True


@pytest.mark.parametrize("shape", [(16, 4, 3, 5), (4, 16, 3, 5), (2, 3, 64, 80)])
def test_library_contraction_matches_plain_version(shape):
    """Each of the three pairings (the intermediate [B, R2, C], [B, R1, C]
    or [B, R1, R2], whichever is smallest) equals the JAX package's
    reference contraction on the same float64 numpy inputs (rtol 1e-5 of
    the largest output: JAX returns float32) and the port's plain version
    (rtol 1e-12 in float64, under autograd too)."""
    R1, R2, C, B = shape
    rng = np.random.default_rng(0)
    pot_np = rng.random((R1, R2, C))
    w1_np, w2_np = rng.random((B, R1)), rng.random((B, R2))
    pot, w2 = torch.from_numpy(pot_np), torch.from_numpy(w2_np)
    w1 = torch.from_numpy(w1_np).requires_grad_(True)
    got = fc.library_factored_contract(pot, w1, w2)
    assert got.dtype == torch.float64
    jax_out = np.asarray(jax_pc.reference_factored_contract(pot_np, w1_np, w2_np))
    np.testing.assert_allclose(got.detach().numpy(), jax_out, rtol=0,
                               atol=1e-5 * np.abs(jax_out).max())
    want = fc.reference_factored_contract(pot, w1, w2)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-12)
    (ga,) = torch.autograd.grad(got.sum(), w1)
    (gb,) = torch.autograd.grad(want.sum(), w1)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-12)
    out = fc.library_factored_contract(pot.to(torch.bfloat16), w1.detach().float(),
                                       w2.to(torch.bfloat16))
    assert out.dtype == torch.float32


def _big_clique():
    rng = np.random.default_rng(0)
    names = [f"v{i}" for i in range(10)]
    factors = [names[:]] + [[n] for n in names]
    sizes = {n: 2 for n in names}
    values = [rng.random((2,) * 10) + 0.1] + [rng.random(2) + 0.1 for _ in names]
    return factors, sizes, values, names


def test_serving_never_consults_decide_and_describe_reports_the_table(monkeypatch):
    """With measurement on, a big-clique ``posterior_batch`` takes the
    kernel's wrapper on every routed contraction and never asks
    ``decide``; its posteriors equal the JAX engine's (float64, rtol
    1e-9).  ``describe()["kernel_routing"]`` carries the table once it
    holds an entry, as the JAX engine's does."""
    factors, sizes, values, names = _big_clique()
    tree = jt.create_junction_tree(factors, sizes)
    masks = jt.batch_masks_sparse(
        tree.plan, jt.random_evidence_batch(tree.plan, 6, names[:6], seed=1))
    monkeypatch.setattr(DEFAULT, "big_clique_min_states", 1 << 9)
    eng = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)

    def boom(*a, **k):
        raise AssertionError("serving must not consult the measurement")

    monkeypatch.setattr(autotune, "decide", boom)
    calls = TIMERS.counters()["big_clique_sep_message.calls"]
    post, logz = eng.posterior_batch(masks)
    assert TIMERS.counters()["big_clique_sep_message.calls"] > calls
    jeng = jt_jax.create_junction_tree(factors, sizes).engine().set_potentials(values)
    jpost, jlogz = jeng.posterior_batch(masks)
    np.testing.assert_allclose(logz.numpy(), np.asarray(jlogz), rtol=1e-9)
    for a, b in zip(post, jpost):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-15)
    d = eng.describe()
    assert "big_clique_library_calls" not in d["kernel_launches"]
    assert "kernel_routing" not in d and "kernel_routing" not in jeng.describe()
    _write("library", 2.0, 1.0)
    monkeypatch.setattr(autotune, "_CACHE", None)
    monkeypatch.setattr(jax_autotune, "_CACHE", None)
    mine = eng.describe()["kernel_routing"][KEY]
    theirs = jeng.describe()["kernel_routing"][JAX_KEY]
    assert mine["winner"] == AS_PORT[theirs["winner"]] == "library"

"""``python -m junctiontree_tpu_torch`` case for case with ``tests/test_cli.py``.

Each case runs the port's CLI with ``--device cpu`` and the JAX package's CLI
on the same UAI files (both in process, output captured) and compares what
they print: the numbers of MAR and PR to atol 1e-5 (the port computes in
float32, the JAX package here in float64), and MPE / MMAP assignments by
their scores under the brute-force oracle (rtol 1e-6: ties may decode to
different assignments).  The same oracle checks of ``tests/test_cli.py``
hold for the port's output.  One case runs the port as ``python -m``."""

import os
import subprocess
import sys

import numpy as np
import pytest

import junctiontree_tpu.__main__ as jax_cli
import junctiontree_tpu_torch.__main__ as cli
from junctiontree_tpu_torch.utils.uai import write_uai

from .util import brute_force_marginals, grid_mrf, random_values

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def uai_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("uai")
    factors, sizes = grid_mrf(2, 3)
    values = random_values(factors, sizes, seed=55)
    var_list = list(sizes)
    int_factors = [[var_list.index(v) for v in f] for f in factors]
    int_sizes = {i: sizes[v] for i, v in enumerate(var_list)}
    model = d / "m.uai"
    model.write_text(write_uai(int_factors, int_sizes, values))
    evid = d / "m.evid"
    evid.write_text("1 0 1\n")
    return model, evid, int_factors, int_sizes, values


def _run(main, capsys, *args):
    rc = main([str(a) for a in args])
    out = capsys.readouterr()
    return rc, out.out, out.err


def run_both(capsys, *args):
    """(port rc, stdout, stderr), (JAX rc, stdout, stderr) on the same
    arguments; the port runs on the CPU."""
    ours = _run(cli.main, capsys, *args, "--device", "cpu")
    theirs = _run(jax_cli.main, capsys, *args)
    return ours, theirs


def numbers(stdout):
    return np.array([float(t) for t in stdout.splitlines()[1].split()])


def assert_same_numbers(ours, theirs):
    assert ours[0] == theirs[0] == 0, ours[2] + theirs[2]
    assert ours[1].splitlines()[0] == theirs[1].splitlines()[0]
    np.testing.assert_allclose(numbers(ours[1]), numbers(theirs[1]), atol=1e-5)


def log_score(f, s, v, assign):
    """log of the unnormalized joint at a full assignment {var: state}."""
    total = 0.0
    for fv, val in zip(f, v):
        total += np.log(np.asarray(val, dtype=np.float64)[tuple(assign[x] for x in fv)])
    return total


def mpe_assignment(stdout):
    toks = stdout.splitlines()[1].split()
    return {i: int(x) for i, x in enumerate(toks[1:])}


def test_cli_pr(uai_files, capsys):
    model, evid, f, s, v = uai_files
    ours, theirs = run_both(capsys, model, "--task", "PR")
    assert_same_numbers(ours, theirs)
    assert ours[1].splitlines()[0] == "PR"
    (z,) = brute_force_marginals(f, s, v, [[]])
    np.testing.assert_allclose(float(ours[1].splitlines()[1]), np.log10(z), rtol=1e-4)


def test_cli_mar_with_evidence(uai_files, capsys):
    model, evid, f, s, v = uai_files
    ours, theirs = run_both(capsys, model, "--evidence", evid, "--task", "MAR",
                            "--stats")
    assert_same_numbers(ours, theirs)
    toks = ours[1].splitlines()[1].split()
    assert int(toks[0]) == len(s)
    card0 = int(toks[1])
    np.testing.assert_allclose([float(x) for x in toks[2:2 + card0]], [0.0, 1.0],
                               atol=1e-6)
    assert "compile" in ours[2]


def test_cli_mpe(uai_files, capsys):
    model, evid, f, s, v = uai_files
    ours, theirs = run_both(capsys, model, "--task", "MPE")
    assert ours[0] == theirs[0] == 0, ours[2]
    assert ours[1].splitlines()[0] == "MPE"
    toks = ours[1].splitlines()[1].split()
    assert int(toks[0]) == len(s)
    assert all(0 <= int(x) < 2 for x in toks[1:])
    a, b = mpe_assignment(ours[1]), mpe_assignment(theirs[1])
    assert log_score(f, s, v, a) == pytest.approx(log_score(f, s, v, b), rel=1e-6)
    best = np.log(brute_force_marginals(f, s, v, [list(range(len(s)))])[0].max())
    assert log_score(f, s, v, a) == pytest.approx(best, rel=1e-6)


def test_cli_cutset_engine(uai_files, capsys):
    """Forced cutset engine stays exact: MAR and PR equal the JAX CLI's and
    the oracle; MPE attains the exact engine's score."""
    model, evid, f, s, v = uai_files
    ours, theirs = run_both(capsys, model, "--task", "PR", "--engine", "cutset",
                            "--stats")
    assert_same_numbers(ours, theirs)
    (z,) = brute_force_marginals(f, s, v, [[]])
    np.testing.assert_allclose(float(ours[1].splitlines()[1]), np.log10(z), rtol=1e-4)
    assert "cutset engine" in ours[2]

    ours, theirs = run_both(capsys, model, "--task", "MAR", "--engine", "cutset",
                            "--evidence", evid)
    assert_same_numbers(ours, theirs)
    toks = ours[1].splitlines()[1].split()
    card0 = int(toks[1])
    np.testing.assert_allclose([float(x) for x in toks[2:2 + card0]], [0.0, 1.0],
                               atol=1e-6)
    (m_last,) = brute_force_marginals(f, s, v, [[len(s) - 1]], evidence={0: 1})
    np.testing.assert_allclose(numbers(ours[1])[-2:], m_last / m_last.sum(),
                               atol=1e-5)

    ours, theirs = run_both(capsys, model, "--task", "MPE", "--engine", "cutset")
    exact, _ = run_both(capsys, model, "--task", "MPE", "--engine", "exact")
    assert ours[0] == exact[0] == theirs[0] == 0, ours[2]

    def lp(err):
        return [float(l.split("=")[1]) for l in err.splitlines() if "log p" in l]

    np.testing.assert_allclose(lp(ours[2]), lp(exact[2]), rtol=1e-4)
    np.testing.assert_allclose(lp(ours[2]), lp(theirs[2]), rtol=1e-4)
    a, b = mpe_assignment(ours[1]), mpe_assignment(theirs[1])
    assert log_score(f, s, v, a) == pytest.approx(log_score(f, s, v, b), rel=1e-6)


def test_cli_out_file(uai_files, tmp_path, capsys):
    model, evid, f, s, v = uai_files
    out, jout = tmp_path / "res.txt", tmp_path / "jax.txt"
    rc, stdout, _ = _run(cli.main, capsys, model, "--task", "PR", "--out", out,
                         "--device", "cpu")
    assert rc == 0 and stdout == ""
    assert _run(jax_cli.main, capsys, model, "--task", "PR", "--out", jout)[0] == 0
    assert out.read_text().startswith("PR")
    np.testing.assert_allclose(numbers(out.read_text()), numbers(jout.read_text()),
                               atol=1e-5)


def test_cli_loopy_engine(uai_files, capsys):
    """Forced loopy engine: the port's loopy BP prints what the JAX CLI's
    does (MAR, PR within 1e-5; MPE of equal score), and stays near the exact
    answers on this tiny grid."""
    model, evid, f, s, v = uai_files
    ours, theirs = run_both(capsys, model, "--task", "MAR", "--engine", "loopy",
                            "--evidence", evid)
    assert_same_numbers(ours, theirs)
    assert "loopy BP" in ours[2]
    toks = ours[1].splitlines()[1].split()
    card0 = int(toks[1])
    np.testing.assert_allclose([float(x) for x in toks[2:2 + card0]], [0.0, 1.0],
                               atol=1e-5)

    ours, theirs = run_both(capsys, model, "--task", "PR", "--engine", "loopy")
    assert_same_numbers(ours, theirs)
    (z,) = brute_force_marginals(f, s, v, [[]])
    np.testing.assert_allclose(float(ours[1].splitlines()[1]), np.log10(z), rtol=0.05)

    ours, theirs = run_both(capsys, model, "--task", "MPE", "--engine", "loopy")
    assert ours[0] == theirs[0] == 0, ours[2]
    toks = ours[1].splitlines()[1].split()
    assert int(toks[0]) == len(s)
    assert all(0 <= int(x) < 2 for x in toks[1:])
    a, b = mpe_assignment(ours[1]), mpe_assignment(theirs[1])
    assert log_score(f, s, v, a) == pytest.approx(log_score(f, s, v, b), rel=1e-6)


def test_cli_mmap(uai_files, tmp_path, capsys):
    """MMAP task: query file in, 'MMAP' + (var, state) pairs out, attaining
    the brute-force optimum as the JAX CLI's assignment does."""
    model, evid, f, s, v = uai_files
    q = tmp_path / "m.query"
    q.write_text("2 0 3\n")
    ours, theirs = run_both(capsys, model, "--task", "MMAP", "--query", q,
                            "--evidence", evid, "--stats")
    assert ours[0] == theirs[0] == 0, ours[2]
    lines = ours[1].splitlines()
    assert lines[0] == "MMAP"
    toks = lines[1].split()
    assert int(toks[0]) == 2
    got = {int(toks[1 + 2 * i]): int(toks[2 + 2 * i]) for i in range(2)}
    jt = theirs[1].splitlines()[1].split()
    jgot = {int(jt[1 + 2 * i]): int(jt[2 + 2 * i]) for i in range(2)}
    marg = brute_force_marginals(f, s, v, [[0, 3]], {0: 1})[0]
    assert marg[got[0], got[3]] == pytest.approx(marg.max(), rel=1e-6)
    assert marg[got[0], got[3]] == pytest.approx(marg[jgot[0], jgot[3]], rel=1e-6)
    assert "log mmap value" in ours[2]
    assert "constrained induced width" in ours[2]

    def score(err):
        return float([l for l in err.splitlines() if "log mmap value" in l][0]
                     .split("=")[1])

    assert score(ours[2]) == pytest.approx(score(theirs[2]), abs=1e-5)


def test_cli_mmap_requires_query(uai_files, capsys):
    model, evid, f, s, v = uai_files
    ours, theirs = run_both(capsys, model, "--task", "MMAP")
    assert ours[0] == theirs[0] == 2
    assert "--query" in ours[2]


def test_cli_runs_as_module_and_defaults_to_the_card(uai_files):
    """``python -m junctiontree_tpu_torch`` runs without JAX; without
    ``--device`` it asks for CUDA device 0 and, with no card, says to pass
    ``--device cpu``."""
    model, evid, f, s, v = uai_files
    code = ("import sys; sys.modules['jax'] = None; import runpy; "
            "sys.argv[0] = 'junctiontree_tpu_torch'; "
            "runpy.run_module('junctiontree_tpu_torch', run_name='__main__')")

    def run(*args):
        return subprocess.run(
            [sys.executable, "-c", code, *map(str, args)],
            capture_output=True, text=True, cwd=REPO, timeout=300,
            env=dict(os.environ, PYTHONPATH=REPO),
        )

    r = run(model, "--task", "PR", "--device", "cpu")
    assert r.returncode == 0, r.stderr
    (z,) = brute_force_marginals(f, s, v, [[]])
    np.testing.assert_allclose(float(r.stdout.splitlines()[1]), np.log10(z), rtol=1e-4)
    import torch

    if not torch.cuda.is_available():
        r = run(model, "--task", "PR")
        assert r.returncode != 0
        assert 'device="cpu"' in r.stderr

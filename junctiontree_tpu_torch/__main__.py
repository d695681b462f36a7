"""Command-line interface for UAI-format inference (counterpart of
``junctiontree_tpu/__main__.py``).

    python -m junctiontree_tpu_torch MODEL.uai [--evidence E.evid] \
        [--task MAR|MPE|PR|MMAP] [--query Q.query] \
        [--engine auto|exact|cutset|loopy] [--device cuda|cpu] [--stats] \
        [--out FILE]

Tasks follow the UAI competition conventions: PR prints log10 of the
partition function; MAR prints per-variable posterior marginals; MPE prints
the most probable assignment; MMAP the marginal MAP assignment of the
``--query`` variables.  ``--engine auto`` (default) runs the exact
junction-tree engine; when the model's treewidth makes that infeasible it
first tries cutset conditioning (still exact — see cutset.py), then falls
back to loopy BP.  Everything runs on ``--device`` (default ``cuda``: CUDA
device 0; ``cpu`` runs on the CPU)."""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m junctiontree_tpu_torch",
        description="Exact inference on UAI-format discrete factor graphs",
    )
    ap.add_argument("model", help="UAI model file (MARKOV or BAYES)")
    ap.add_argument("--evidence", help="UAI .evid evidence file")
    ap.add_argument(
        "--task", default="MAR", choices=["MAR", "MPE", "PR", "MMAP"],
        help="MAR: marginals, MPE: most probable assignment, PR: log10 Z, "
        "MMAP: marginal MAP over the --query variables (exact, constrained "
        "elimination; see mmap.py)",
    )
    ap.add_argument(
        "--query",
        help="UAI .query file (MMAP query-variable set: '<n> var var ...')",
    )
    ap.add_argument("--stats", action="store_true", help="print compile stats")
    ap.add_argument("--out", help="write result to file instead of stdout")
    ap.add_argument(
        "--engine", default="auto",
        choices=["auto", "exact", "cutset", "loopy"],
        help="auto: exact junction tree, escalating to cutset conditioning "
        "(still exact) and then loopy BP when the treewidth makes direct "
        "exact inference infeasible; exact/cutset/loopy force one",
    )
    ap.add_argument("--iters", type=int, default=200,
                    help="loopy BP iteration cap")
    ap.add_argument("--damping", type=float, default=0.5,
                    help="loopy BP damping")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (CUDA device 0, the default) or "
                    "cpu")
    args = ap.parse_args(argv)

    import numpy as np

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.evidence import batch_masks_sparse
    from junctiontree_tpu_torch.executor import resolve_device
    from junctiontree_tpu_torch.utils.uai import load_evidence, load_uai

    # "cuda" is CUDA device 0, with the package's error where there is none
    args.device = resolve_device(None if args.device == "cuda" else args.device)

    t0 = time.perf_counter()
    factors, sizes, values = load_uai(args.model)
    evidence = load_evidence(args.evidence) if args.evidence else {}

    if args.task == "MMAP":
        return _run_mmap(args, factors, sizes, values, evidence)

    use_loopy = args.engine == "loopy"
    use_cutset = args.engine == "cutset"
    tree = None
    if not (use_loopy or use_cutset):
        tree = jt.create_junction_tree(factors, sizes)
        if args.engine == "auto":
            from junctiontree_tpu_torch.executor import check_feasible

            try:
                check_feasible(tree.plan)
            except ValueError as e:
                # exact conditioning first (cutset is still exact, for all
                # of MAR/PR/MPE); loopy BP is the approximate last resort
                cut = jt.choose_cutset(factors, sizes)
                if cut:  # only if it actually reaches feasibility
                    from junctiontree_tpu_torch.cutset import (
                        _max_states,
                        _without,
                    )
                    from junctiontree_tpu_torch.executor import (
                        MAX_CLIQUE_STATES,
                    )

                    red = _max_states(*_without(factors, sizes, set(cut)))
                    if red > MAX_CLIQUE_STATES:
                        cut = []
                if cut:
                    print(f"# exact inference infeasible directly ({e}); "
                          f"conditioning on cutset {cut}", file=sys.stderr)
                    use_cutset = True
                else:
                    print(f"# exact inference infeasible ({e}); "
                          "falling back to loopy BP", file=sys.stderr)
                    use_loopy = True
        if args.stats and not (use_loopy or use_cutset):
            print(
                "# compile %.2fs  %s"
                % (time.perf_counter() - t0, tree.stats()),
                file=sys.stderr,
            )

    if use_cutset:
        return _run_cutset(args, factors, sizes, values, evidence)
    if use_loopy:
        return _run_loopy(args, factors, sizes, values, evidence)

    lines: list = []
    n_vars = len(sizes)
    # a declared variable may appear in no factor scope (legal UAI input);
    # it is uniform/free — state 0 for MPE, uniform for MAR
    used = set(tree.plan.table.labels)
    model_evidence = {k: v for k, v in evidence.items() if k in used}
    if args.task == "MPE":
        eng = tree.engine("max_product", device=args.device).set_potentials(
            values)
        assign, logp = eng.map_assignment(model_evidence)
        lines.append("MPE")
        lines.append(
            str(n_vars)
            + " "
            + " ".join(
                str(assign.get(v, evidence.get(v, 0))) for v in range(n_vars)
            )
        )
        print("# log p = %.6f" % logp, file=sys.stderr)
    else:
        eng = tree.engine(device=args.device).set_potentials(values)
        masks = (
            batch_masks_sparse(tree.plan, [model_evidence])
            if model_evidence
            else {}
        )
        post, logz = eng.posterior_batch(masks)
        lz = float(logz[0])
        if args.task == "PR":
            lines.append("PR")
            lines.append("%.6f" % (lz / np.log(10.0)))
        else:
            lines.append("MAR")
            parts = [str(n_vars)]
            for v in range(n_vars):
                if v in used:
                    vid = tree.plan.table.id_of(v)
                    p = post[vid][0].cpu().numpy()
                else:
                    card = sizes[v]
                    p = np.full(card, 1.0 / card)
                    if v in evidence:
                        p = np.zeros(card)
                        p[evidence[v]] = 1.0
                parts.append(str(len(p)))
                parts.extend("%.8f" % x for x in p)
            lines.append(" ".join(parts))

    text = "\n".join(lines) + "\n"
    _emit(text, args.out)
    return 0


def _emit(text: str, out) -> None:
    if out:
        with open(out, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)


def _run_mmap(args, factors, sizes, values, evidence) -> int:
    """Exact Marginal MAP over the --query variables (mmap.py: constrained
    sum-before-max bucket elimination; the UAI MMAP task)."""
    from junctiontree_tpu_torch.mmap import MarginalMapSolver
    from junctiontree_tpu_torch.utils.uai import load_query

    if not args.query:
        print("MMAP requires --query Q.query (variable-set file)",
              file=sys.stderr)
        return 2
    query = load_query(args.query)
    used = {v for f in factors for v in f}
    model_query = [q for q in query if q in used]
    model_evidence = {k: v for k, v in evidence.items() if k in used}
    solver = MarginalMapSolver(factors, sizes, model_query, device=args.device)
    if args.stats:
        print("# mmap constrained induced width: %d"
              % solver.constrained_width, file=sys.stderr)
    solver.set_potentials(values)
    assign, score = solver.query(model_evidence)
    print("# log mmap value = %.6f" % score, file=sys.stderr)
    # free query vars (in no factor scope) are uniform: state 0, or the
    # evidenced state when observed
    full = {q: assign.get(q, evidence.get(q, 0)) for q in query}
    lines = [
        "MMAP",
        str(len(query)) + " " + " ".join(
            f"{q} {full[q]}" for q in query
        ),
    ]
    _emit("\n".join(lines) + "\n", args.out)
    return 0


def _run_cutset(args, factors, sizes, values, evidence) -> int:
    """Exact UAI MAR/PR/MPE past the treewidth wall via cutset conditioning."""
    import numpy as np

    from junctiontree_tpu_torch.cutset import CutsetEngine

    eng = CutsetEngine(factors, sizes, values, device=args.device)
    n_vars = len(sizes)
    used = {v for f in factors for v in f}
    if args.task == "MPE":
        if args.stats:
            print("# cutset engine: %s" % eng.describe(), file=sys.stderr)
        model_evidence = {k: v for k, v in evidence.items() if k in used}
        assign, logp = eng.map_assignment(model_evidence)
        print("# log p = %.6f" % logp, file=sys.stderr)
        lines = [
            "MPE",
            str(n_vars) + " " + " ".join(
                str(assign.get(v, evidence.get(v, 0))) for v in range(n_vars)
            ),
        ]
        _emit("\n".join(lines) + "\n", args.out)
        return 0
    masks = {}
    for v, state in evidence.items():
        if v not in used:
            continue
        m = np.zeros((1, sizes[v]), dtype=np.float32)
        m[0, state] = 1.0
        masks[v] = m
    if not masks:  # posterior_batch needs >=1 mask to size the batch
        first = next(iter(used))
        masks[first] = np.ones((1, sizes[first]), dtype=np.float32)
    if args.stats:
        print("# cutset engine: %s" % eng.describe(), file=sys.stderr)
    post, logz = eng.posterior_batch(masks)
    lz = float(logz[0])
    lines: list = []
    if args.task == "PR":
        lines.append("PR")
        lines.append("%.6f" % (lz / np.log(10.0)))
    else:
        lines.append("MAR")
        parts = [str(n_vars)]
        for v in range(n_vars):
            if v in used:
                p = post[v][0].cpu().numpy()
            else:
                card = sizes[v]
                p = np.full(card, 1.0 / card)
                if v in evidence:
                    p = np.zeros(card)
                    p[evidence[v]] = 1.0
            parts.append(str(len(p)))
            parts.extend("%.8f" % x for x in p)
        lines.append(" ".join(parts))
    _emit("\n".join(lines) + "\n", args.out)
    return 0


def _run_loopy(args, factors, sizes, values, evidence) -> int:
    """Approximate UAI tasks via loopy BP (high-treewidth fallback)."""
    import numpy as np

    from junctiontree_tpu_torch.approx import LoopyEngine

    eng = LoopyEngine(
        factors, sizes, values,
        damping=args.damping, max_iters=args.iters, device=args.device,
    )
    n_vars = len(sizes)
    used = set(eng.table.labels)
    model_evidence = {k: v for k, v in evidence.items() if k in used}
    lines: list = []
    if args.task == "MPE":
        assign, score, info = eng.map_assignment(model_evidence)
        lines.append("MPE")
        lines.append(
            str(n_vars)
            + " "
            + " ".join(
                str(assign.get(v, evidence.get(v, 0))) for v in range(n_vars)
            )
        )
        print("# loopy BP (approx), iters=%d delta=%.2e  log p = %.6f"
              % (info["iters"], info["delta"], score), file=sys.stderr)
    else:
        margs, logz, info = eng.posterior(model_evidence)
        print("# loopy BP (approx), iters=%d delta=%.2e"
              % (info["iters"], info["delta"]), file=sys.stderr)
        if args.task == "PR":
            lines.append("PR")
            lines.append("%.6f" % (float(logz) / np.log(10.0)))
        else:
            lines.append("MAR")
            parts = [str(n_vars)]
            for v in range(n_vars):
                if v in used:
                    p = np.asarray(margs[eng.table.id_of(v)].cpu())
                else:
                    card = sizes[v]
                    p = np.full(card, 1.0 / card)
                    if v in evidence:
                        p = np.zeros(card)
                        p[evidence[v]] = 1.0
                parts.append(str(len(p)))
                parts.extend("%.8f" % x for x in p)
            lines.append(" ".join(parts))
    _emit("\n".join(lines) + "\n", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Approximate inference: loopy belief propagation on the raw factor graph
(counterpart of ``junctiontree_tpu/approx.py``).

The exact engine's cost is exponential in treewidth: a 30x30 grid MRF has
treewidth ~30 and is out of reach for exact junction-tree inference.  Loopy
BP runs sum-product message passing directly on the (non-chordalized) factor
graph with a synchronous flooding schedule; on tree-structured graphs it is
exact, on loopy graphs it converges to the Bethe approximation of the
marginals and log-partition function.

Design:

  * factors are bucketed by shape and prestacked into [G, *shape] tensors;
    one flooding iteration is O(buckets x max_arity) dense tensor
    operations, independent of the number of factors: a 30x30 grid (1800
    factors) is the same program as a 3x3 grid;
  * all messages live in one padded [E, K_max, B] tensor; variable-side
    products are one padded-degree gather, factor-side reads are static
    slices;
  * iterations run as a Python loop in chunks, with one host read of the
    convergence delta per chunk, and none when ``tol <= 0``;
  * evidence is per-variable masks with a batch axis (same contract as
    ``Engine.posterior_batch``), so one program serves every evidence
    instantiation.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from .executor import resolve_device
from .labels import intern_factors
from .parallel.mesh import row_blocks

_TINY = 1e-30


class LoopyPosteriors:
    """Lazy list-like view over [V, B, K] loopy-BP beliefs; ``[v]`` returns
    the normalized [B, size_v] posterior for that var id on access."""

    def __init__(self, b_v, sizes):
        self._b_v = b_v
        self._sizes = sizes

    def __len__(self) -> int:
        return len(self._sizes)

    def __getitem__(self, v: int):
        return self._b_v[v, :, : self._sizes[v]]

    def __iter__(self):
        for v in range(len(self)):
            yield self[v]


class LoopyEngine:
    """Loopy-BP engine over a factor graph (no triangulation).

    Same query contract as the exact ``Engine.posterior_batch`` — returns
    (normalized per-variable posteriors, logZ estimate) — but approximate on
    loopy graphs and linear in the factor sizes instead of exponential in
    treewidth."""

    def __init__(
        self,
        factors: Sequence[Sequence[Hashable]],
        sizes: Dict[Hashable, int],
        values: Optional[Sequence[np.ndarray]] = None,
        damping: float = 0.5,
        max_iters: int = 200,
        tol: float = 1e-6,
        chunk_iters: int = 50,
        device=None,
        mesh=None,
        batch_axis: str = "batch",
    ):
        """device: where the potentials and messages live (default CUDA
        device 0, or with ``mesh`` the first device of its ``batch_axis``;
        ``"cpu"`` runs on the CPU).  mesh / batch_axis: an optional
        ``parallel.Mesh``: the evidence batch (the trailing axis of the
        message layout) is split over the devices of ``batch_axis``, each
        device floods its rows, and every chunk of iterations ends on the
        largest change over all rows, so the iterations match the unsplit
        run's."""
        self.mesh, self.batch_axis = mesh, batch_axis
        if device is None and mesh is not None:
            device = mesh.local_devices(batch_axis)[0]
        self.device = resolve_device(device)
        self.table, self.factors, self.sizes = intern_factors(factors, sizes)
        if not self.factors:
            raise ValueError("need at least one factor")
        if any(len(f) == 0 for f in self.factors):
            raise ValueError("scalar (zero-variable) factors not supported")
        self.damping = float(damping)
        self.max_iters = int(max_iters)
        self.tol = float(tol)
        self.chunk_iters = int(chunk_iters)
        self.num_vars = len(self.sizes)
        self.K = max(self.sizes)

        # ---- bucket factors by shape; build static edge tables ----
        shape_of = lambda f: tuple(self.sizes[v] for v in f)
        bucket_ix: Dict[tuple, int] = {}
        self.bucket_shapes: List[tuple] = []
        self.bucket_factors: List[List[int]] = []
        for fi, f in enumerate(self.factors):
            sh = shape_of(f)
            if sh not in bucket_ix:
                bucket_ix[sh] = len(self.bucket_shapes)
                self.bucket_shapes.append(sh)
                self.bucket_factors.append([])
            self.bucket_factors[bucket_ix[sh]].append(fi)

        # edge = (factor, position); ids assigned bucket-major,
        # position-major — so every (bucket, position) owns a CONTIGUOUS id
        # range.  That turns all message writes into concatenations and all
        # reads into static slices (no scatter/gather in the hot loop).
        self.edge_var: List[int] = []
        self.bucket_eids: List[List[np.ndarray]] = []   # [b][p] -> [G] ids
        self.bucket_estart: List[List[int]] = []        # [b][p] -> start id
        self.bucket_evars: List[List[np.ndarray]] = []  # [b][p] -> [G] vars
        for b, fis in enumerate(self.bucket_factors):
            arity = len(self.bucket_shapes[b])
            eids, evars, starts = [], [], []
            for p in range(arity):
                starts.append(len(self.edge_var))
                ids = []
                vs = []
                for fi in fis:
                    ids.append(len(self.edge_var))
                    v = self.factors[fi][p]
                    self.edge_var.append(v)
                    vs.append(v)
                eids.append(np.asarray(ids, dtype=np.int32))
                evars.append(np.asarray(vs, dtype=np.int32))
            self.bucket_eids.append(eids)
            self.bucket_estart.append(starts)
            self.bucket_evars.append(evars)
        self.E = len(self.edge_var)
        self.edge_var_arr = np.asarray(self.edge_var, dtype=np.int32)
        # per-var incoming-edge table padded to max degree; the pad entry
        # points at a sentinel all-ones row appended to the message tensor
        deg = np.bincount(self.edge_var_arr, minlength=self.num_vars)
        self.max_degree = int(deg.max()) if len(deg) else 0
        self.inc_idx = np.full(
            (self.num_vars, self.max_degree), self.E, dtype=np.int32
        )
        fill = np.zeros(self.num_vars, dtype=np.int64)
        for e, v in enumerate(self.edge_var_arr):
            self.inc_idx[v, fill[v]] = e
            fill[v] += 1
        # lane validity per edge [E, K] and per var [V, K]
        esz = np.asarray([self.sizes[v] for v in self.edge_var])
        lanes = np.arange(self.K)[None, :]
        self.edge_lane = (lanes < esz[:, None]).astype(np.float32)
        vsz = np.asarray(self.sizes)
        self.var_lane = (lanes < vsz[:, None]).astype(np.float32)
        self.degree = np.bincount(
            self.edge_var_arr, minlength=self.num_vars
        ).astype(np.float32)

        self._pots: Optional[List[torch.Tensor]] = None  # stacked per bucket
        self._pots_on: Dict[str, List[torch.Tensor]] = {}  # per mesh device
        self._cache: dict = {}
        if values is not None:
            self.set_potentials(values)

    def _dev(self, x, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device if device is None else device)

    def _pots_for(self, device) -> List[torch.Tensor]:
        """The stacked potentials on ``device`` (copied once)."""
        if torch.device(device) == self.device:
            return self._pots
        key = str(device)
        if key not in self._pots_on:
            self._pots_on[key] = [p.to(device) for p in self._pots]
        return self._pots_on[key]

    # ------------------------------------------------------------------
    def set_potentials(self, values: Sequence[np.ndarray]) -> "LoopyEngine":
        if len(values) != len(self.factors):
            raise ValueError(
                f"expected {len(self.factors)} value arrays, got {len(values)}"
            )
        for f, v in zip(self.factors, values):
            want = tuple(self.sizes[x] for x in f)
            if tuple(np.shape(v)) != want:
                raise ValueError(
                    f"potential shape {np.shape(v)} != factor shape {want}"
                )
        self._pots = [
            self._dev(
                np.stack([np.asarray(values[fi], dtype=np.float32)
                          for fi in fis])
            )
            for fis in self.bucket_factors
        ]
        self._pots_on = {}
        self._cache.clear()
        return self

    # ------------------------------------------------------------------
    def _program(self, B: int, mode: str = "sum", obs_ids: tuple = (),
                 device=None):
        """(masks_obs [O,K,B], m [E,K,B]) -> (m', delta): one chunk of
        flooding iterations, plus a belief/readout program.

        Only the observed variables' masks cross host->device ([O,K,B]);
        the dense [V,K,B] mask tensor is built on device (one indexed
        write): per-query upload scales with the evidence, not the model.

        Internal layout is batch-LAST: the large batch axis is the
        contiguous one, so elementwise work over small-cardinality variables
        (K=2..4) reads and writes whole coalesced rows of B.  The readout
        converts back to the external [V, B, K] contract.

        mode: "sum" = sum-product (posteriors + Bethe logZ), "max" =
        max-product (approximate MAP max-marginals; readout returns beliefs
        and a zero logZ placeholder).  ``device``: where the program runs
        (default the engine's)."""
        device = self.device if device is None else device
        dev = lambda x, dtype=torch.float32: self._dev(x, dtype, device)
        edge_var = dev(self.edge_var_arr, torch.int64)
        edge_lane = dev(self.edge_lane)[:, :, None]    # [E,K,1]
        var_lane = dev(self.var_lane)[:, :, None]      # [V,K,1]
        inc_idx = dev(self.inc_idx, torch.int64)       # [V,D]
        degree = dev(self.degree)
        V, E, K = self.num_vars, self.E, self.K
        pots = self._pots_for(device)
        damping = self.damping
        reduce_op = torch.amax if mode == "max" else torch.sum
        obs_arr = dev(np.asarray(obs_ids, dtype=np.int64), torch.int64)

        def dense_masks(masks_obs):
            dm = torch.ones((V, K, B), dtype=torch.float32, device=device)
            if len(obs_ids):
                dm[obs_arr] = masks_obs
            return dm

        def with_ones_row(m):
            return torch.cat([m, m.new_ones((1,) + tuple(m.shape[1:]))], dim=0)

        def var_to_factor(masks, m):
            """v->f messages [E,K,B] from current f->v messages."""
            # per-var product over incoming edges via a padded-degree gather
            prod = torch.prod(with_ones_row(m)[inc_idx], dim=1)  # [V,K,B]
            belief = masks * prod * var_lane + (1.0 - var_lane)
            v2f = belief[edge_var] / m.clamp_min(_TINY)
            s = torch.sum(v2f * edge_lane, dim=1, keepdim=True)
            return torch.where(
                edge_lane > 0, v2f / s.clamp_min(_TINY), 1.0
            )

        def factor_to_var(v2f, m_old):
            """One flooding update of all f->v messages.

            Edge ids are contiguous per (bucket, position), so the new
            message tensor is a concatenation of per-position blocks — no
            scatter."""
            pieces = []
            for b, sh in enumerate(self.bucket_shapes):
                arity = len(sh)
                G = len(self.bucket_factors[b])
                pot = pots[b][..., None]  # [G,*sh,1]
                ins = []
                for p in range(arity):
                    st = self.bucket_estart[b][p]
                    rows = v2f[st:st + G, : sh[p], :]
                    shape = [G] + [1] * arity + [rows.shape[-1]]
                    shape[1 + p] = sh[p]
                    ins.append(rows.reshape(shape))
                # leave-one-out prefix/suffix products
                prefix = [None] * arity
                run = None
                for p in range(arity):
                    prefix[p] = run
                    run = ins[p] if run is None else run * ins[p]
                suffix = [None] * arity
                run = None
                for p in range(arity - 1, -1, -1):
                    suffix[p] = run
                    run = ins[p] if run is None else run * ins[p]
                for p in range(arity):
                    acc = pot
                    if prefix[p] is not None:
                        acc = acc * prefix[p]
                    if suffix[p] is not None:
                        acc = acc * suffix[p]
                    red = tuple(1 + a for a in range(arity) if a != p)
                    out = reduce_op(acc, dim=red) if red else acc
                    s = torch.sum(out, dim=1, keepdim=True)
                    out = out / s.clamp_min(_TINY)  # [G, size_p, B?]
                    if sh[p] < K:
                        out = torch.nn.functional.pad(
                            out, (0, 0, 0, K - sh[p]), value=1.0
                        )
                    # unary factors have batch-free messages (leave-one-out
                    # excludes their only input); make every block [G,K,B]
                    pieces.append(out.expand(G, K, v2f.shape[-1]))
            m_new = torch.cat(pieces, dim=0)
            return damping * m_old + (1.0 - damping) * m_new

        def chunk(masks_obs, m):
            masks = dense_masks(masks_obs)
            for _ in range(self.chunk_iters):
                m_old = m
                m = factor_to_var(var_to_factor(masks, m_old), m_old)
            return m, (m - m_old).abs().max()

        def readout(masks_obs, m):
            """(var marginals [V,B,K] (external layout), logZ_bethe [B])."""
            masks = dense_masks(masks_obs)
            prod = torch.prod(with_ones_row(m)[inc_idx], dim=1)
            belief = masks * prod * var_lane
            bsum = torch.sum(belief, dim=1, keepdim=True)
            b_v = belief / bsum.clamp_min(_TINY)  # [V,K,B]
            B_ = belief.shape[-1]
            logz = belief.new_zeros((B_,))
            if mode == "max":  # max-marginals only; no Bethe free energy
                return b_v.transpose(1, 2), logz
            v2f = var_to_factor(masks, m)

            xlogy = lambda p, q: torch.where(
                p > _TINY, p * torch.log(q.clamp_min(_TINY)), 0.0
            )
            for b, sh in enumerate(self.bucket_shapes):
                arity = len(sh)
                G = len(self.bucket_factors[b])
                pot = pots[b][..., None]
                acc = pot
                for p in range(arity):
                    st = self.bucket_estart[b][p]
                    rows = v2f[st:st + G, : sh[p], :]
                    shape = [G] + [1] * arity + [rows.shape[-1]]
                    shape[1 + p] = sh[p]
                    acc = acc * rows.reshape(shape)
                axes = tuple(range(1, 1 + arity))
                z_f = torch.sum(acc, dim=axes, keepdim=True)
                b_f = acc / z_f.clamp_min(_TINY)
                # sum_f E_{b_f}[log pot_f - log b_f]
                term = xlogy(b_f, pot.expand(b_f.shape)) - xlogy(b_f, b_f)
                logz = logz + torch.sum(term, dim=(0,) + axes).reshape(-1)
            # + sum_v E_{b_v}[log mask_v] + (d_v - 1) E[log b_v]
            logz = logz + torch.sum(xlogy(b_v, masks), dim=(0, 1))
            dv = degree[:, None, None] - 1.0
            logz = logz + torch.sum(dv * xlogy(b_v, b_v), dim=(0, 1))
            return b_v.transpose(1, 2), logz

        return chunk, readout

    # ------------------------------------------------------------------
    def _stack_obs_masks(self, mask_batch, B: int):
        """Dict {var label or id: [B, size]} -> (obs_ids tuple sorted,
        stacked [O, K, B] numpy masks, pad=1).  Only observed variables
        cross host->device."""
        by_id = {}
        for k, m in mask_batch.items():
            vid = k if isinstance(k, int) else self.table.id_of(k)
            m = np.asarray(m, dtype=np.float32)
            if m.shape != (B, self.sizes[vid]):
                raise ValueError(
                    f"mask for {k}: expected {(B, self.sizes[vid])}, "
                    f"got {m.shape}"
                )
            by_id[vid] = m if vid not in by_id else by_id[vid] * m
        obs_ids = tuple(sorted(by_id))
        out = np.ones((len(obs_ids), self.K, B), dtype=np.float32)
        for i, vid in enumerate(obs_ids):
            out[i, : self.sizes[vid], :] = by_id[vid].T
        return obs_ids, out

    def posterior_batch(
        self, mask_batch: Dict, batch: Optional[int] = None
    ):
        """Approximate posteriors + Bethe logZ under batched evidence masks.

        mask_batch: {var label or interned id: [B, size_v]} linear masks.
        Returns (list over var ids of [B, size_v] normalized posteriors,
        logZ [B], info dict with 'iters' and 'delta')."""
        if self._pots is None:
            raise RuntimeError("call set_potentials(values) first")
        if batch is None:
            if not mask_batch:
                raise ValueError("pass batch= when mask_batch is empty")
            batch = int(next(iter(mask_batch.values())).shape[0])
        b_v, logz, info = self._run(mask_batch, batch, mode="sum")
        # lazy per-var view: slicing all V vars eagerly would dispatch V
        # device ops per query even when the caller reads a handful
        return LoopyPosteriors(b_v, self.sizes), logz, info

    def _run(self, mask_batch, batch: int, mode: str):
        obs_ids, masks_np = self._stack_obs_masks(mask_batch, batch)
        if self.mesh is None:
            parts = [(self.device, slice(0, batch))]
        else:
            devs = self.mesh.local_devices(self.batch_axis)
            parts = list(zip(devs, row_blocks(batch, len(devs))))
        runs = []   # per device: (chunk, readout, masks, messages)
        for device, rows in parts:
            n = rows.stop - rows.start
            key = ("prog", n, mode, obs_ids, str(device))
            if key not in self._cache:
                self._cache[key] = self._program(n, mode, obs_ids, device)
            chunk, readout = self._cache[key]
            m = torch.ones((self.E, self.K, n), dtype=torch.float32,
                           device=device)
            runs.append([chunk, readout,
                         self._dev(masks_np[..., rows], device=device), m])
        iters = 0
        d = None
        while iters < self.max_iters:
            deltas = []
            for run in runs:
                run[3], dr = run[0](run[2], run[3])
                deltas.append(dr.to(self.device))
            d = torch.stack(deltas).max()
            iters += self.chunk_iters
            # tol<=0 disables early exit, so skip the per-chunk device->host
            # delta read (each one waits for the device); the final delta
            # is read once below
            if self.tol > 0 and float(d) < self.tol:
                break
        outs = [readout(masks, m) for _, readout, masks, m in runs]
        b_v = torch.cat([b.to(self.device) for b, _ in outs], dim=1)
        logz = torch.cat([z.to(self.device) for _, z in outs])
        return b_v, logz, {"iters": iters, "delta": float(d)}

    def map_assignment_batch(
        self, mask_batch: Dict, batch: Optional[int] = None
    ):
        """Approximate MAP by max-product flooding + per-variable argmax.

        Exact on trees (up to ties); on loopy graphs this is the standard
        max-product BP heuristic.  Returns (assignments [B, num_vars] int32,
        scores [B] = log unnormalized joint at the decoded assignment
        including mask terms, info)."""
        if self._pots is None:
            raise RuntimeError("call set_potentials(values) first")
        if batch is None:
            if not mask_batch:
                raise ValueError("pass batch= when mask_batch is empty")
            batch = int(next(iter(mask_batch.values())).shape[0])
        b_v, _, info = self._run(mask_batch, batch, mode="max")
        lanes = self._dev(self.var_lane)[:, None, :]
        assign = torch.argmax(
            torch.where(lanes > 0, b_v, -1.0), dim=-1
        ).to(torch.int32).cpu().numpy().T  # [B, V]
        # score the decoded assignments: sum of log potentials + log masks
        obs_ids, obs_np = self._stack_obs_masks(mask_batch, batch)
        masks_np = np.ones(
            (self.num_vars, self.K, batch), dtype=np.float32
        )
        if obs_ids:
            masks_np[list(obs_ids)] = obs_np
        scores = np.zeros(batch, dtype=np.float64)
        with np.errstate(divide="ignore"):
            for b, fis in enumerate(self.bucket_factors):
                pot = self._pots[b].cpu().numpy()  # [G, *shape]
                flat = pot.reshape(len(fis), -1)
                strides = np.cumprod(
                    (self.bucket_shapes[b] + (1,))[::-1]
                )[::-1][1:]
                idx = np.zeros((batch, len(fis)), dtype=np.int64)
                for p, st in enumerate(strides):
                    idx += assign[:, self.bucket_evars[b][p]] * st
                scores += np.log(
                    np.maximum(flat[np.arange(len(fis))[None, :], idx], 0)
                ).sum(axis=1)
            vidx = np.arange(self.num_vars)
            scores += np.log(
                masks_np[vidx[None, :], assign,
                         np.arange(batch)[:, None]]
            ).sum(axis=1)
        return assign, scores, info

    def map_assignment(self, evidence: Optional[Dict[Hashable, int]] = None):
        """Single-query approximate MAP: ({var label: state}, score, info)."""
        evidence = evidence or {}
        masks = {}
        for k, s in evidence.items():
            vid = k if isinstance(k, int) else self.table.id_of(k)
            if not (0 <= s < self.sizes[vid]):
                raise ValueError(f"state {s} out of range for {k}")
            m = np.zeros((1, self.sizes[vid]), dtype=np.float32)
            m[0, s] = 1.0
            masks[vid] = m
        assign, scores, info = self.map_assignment_batch(masks, batch=1)
        out = {
            self.table.label_of(v): int(assign[0, v])
            for v in range(self.num_vars)
        }
        return out, float(scores[0]), info

    def posterior(self, evidence: Optional[Dict[Hashable, int]] = None):
        """Single-query convenience: evidence {var: state} -> (posteriors,
        logZ, info) with the batch axis squeezed."""
        evidence = evidence or {}
        masks = {}
        for k, s in evidence.items():
            vid = k if isinstance(k, int) else self.table.id_of(k)
            if not (0 <= s < self.sizes[vid]):
                raise ValueError(f"state {s} out of range for {k}")
            m = np.zeros((1, self.sizes[vid]), dtype=np.float32)
            m[0, s] = 1.0
            masks[vid] = m
        margs, logz, info = self.posterior_batch(masks, batch=1)
        return [m[0] for m in margs], float(logz[0]), info

"""A plain Li-Stephens forward-backward, from the published recursion.

Li and Stephens 2003 (Genetics 165:2213-2233): with K templates, the
transition from site m - 1 to m stays on the template with probability
s_m and otherwise jumps to one drawn uniformly, so the sum over the
previous template collapses to O(K) work a site:

  pred_0(k)   = prior(k)
  pred_m(k)   = s_m a_{m-1}(k) + (1 - s_m) / K sum_j a_{m-1}(j)
  a_m(k)      = pred_m(k) e_m(k)
  b_{M-1}(k)  = 1
  b_{m-1}(k)  = s_m e_m(k) b_m(k) + (1 - s_m) / K sum_j e_m(j) b_m(j)

e_m(k) is the likelihood of site m's evidence on template k: sum_a
P(a | k) mask_m(a), and sum_a P(a | k) where the site is not observed.
The template posterior at site m is proportional to a_m b_m, the allele
posterior to sum_k pred_m(k) b_m(k) P(a | k) mask_m(a), and log P(evidence)
is log sum_k a_{M-1}(k) b_{M-1}(k).  Each a_m and b_m is divided by its
sum (the logs of a's sums add up to the offset of log P), so long
chunks stay in range.

Plain ``torch``; imports nothing of this repository's packages.
"""

from __future__ import annotations

from typing import Dict

import torch


def _norm(x: torch.Tensor):
    """(x / its row sums, the sums); a zero row stays zero."""
    s = x.sum(dim=-1, keepdim=True)
    return x / torch.where(s > 0, s, torch.ones_like(s)), s[..., 0]


def forward_backward(prior: torch.Tensor, stay: torch.Tensor,
                     emit: torch.Tensor, masks: Dict[int, torch.Tensor],
                     rows: int):
    """Li-Stephens posteriors for ``rows`` targets.

    ``prior`` [K]; ``stay`` [M-1], s_m for m = 1..M-1; ``emit`` [M, K, C],
    P(allele | template) a site; ``masks`` {site: [rows, C]} at the
    observed sites.  Returns (template posteriors [M, rows, K], allele
    posteriors [M, rows, C], log P(evidence) [rows]); an impossible row
    gives zeros and -inf."""
    M, K, C = emit.shape
    e = torch.stack([masks[m] @ emit[m].T if m in masks
                     else emit[m].sum(dim=-1).expand(rows, K)
                     for m in range(M)])                  # [M, rows, K]
    pred, a = [], []
    logz = torch.zeros(rows, dtype=emit.dtype)
    prev = None
    for m in range(M):
        if m == 0:
            p = prior.expand(rows, K)
        else:
            p = stay[m - 1] * prev + (1 - stay[m - 1]) / K * prev.sum(
                dim=-1, keepdim=True)
        prev, s = _norm(p * e[m])
        logz = logz + torch.log(s)
        pred.append(p)
        a.append(prev)
    b = [None] * M
    b[M - 1] = torch.ones((rows, K), dtype=emit.dtype)
    for m in range(M - 1, 0, -1):
        eb = e[m] * b[m]
        b[m - 1], _ = _norm(stay[m - 1] * eb + (1 - stay[m - 1]) / K
                            * eb.sum(dim=-1, keepdim=True))
    hidden = torch.stack([_norm(a[m] * b[m])[0] for m in range(M)])
    allele = []
    for m in range(M):
        y = (pred[m] * b[m]) @ emit[m]
        if m in masks:
            y = y * masks[m]
        allele.append(_norm(y)[0])
    return hidden, torch.stack(allele), logz

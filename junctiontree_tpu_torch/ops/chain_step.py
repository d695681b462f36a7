"""One rescaled step of the chain program in two launches: the library's
product, then one row pass that does the rest of the step's elementwise
work and forms the next product's operand.

For batch rows b and a [K, K] transition ``A``::

    forward:   y = xm @ A                    xm = F_k ⊙ M_k
               s = max(rowmax(y), 1e-38);    scale = s
               out = (y / s) ⊙ m             m = M_{k+1}: F_{k+1} ⊙ M_{k+1}
                                             (None at the last step: F_m)
    backward:  y = mg @ Aᵀ                   mg = M_{k+1} ⊙ G_{k+1}
               g = y / max(rowmax(y), 1e-38) (G_k)
               p = post ⊙ g;                 post = p / max(rowsum(p), 1e-38)
                                             post = F_k ⊙ M_k in, its posterior out
               out = m ⊙ g                   m = M_k: the next step's mg
                                             (None at position 0: out is y)

This is ``scan_executor._rescaled_step``, its mask multiply and the chain
program's posterior pass, one position at a time.  The product is
``torch.matmul`` (FP32 on the CUDA cores under ``pinned_precision``: no
TF32); :func:`rows` is the hand-written CUDA kernel ``csrc/chain_step.cu``
(``chain_rows_kernel``: one warp a row, in place over the product; it
replaces no TPU kernel), and :func:`reference_rows` its plain PyTorch
version, with the same elementwise products and divisions (only the rows'
sums are summed in another order).  :func:`forward_step` and
:func:`backward_step` run the two.

The chain program calls them where :func:`engages`: float32 on a CUDA
device, K at most :data:`K_MAX`, and steps that are not functional (no
gradient through ``A``).  Everything else keeps the plain steps.
"""

from __future__ import annotations

from typing import Optional

import torch

K_MAX = 1024                  # the widest row a warp holds in registers
WIDTHS = (256, 512, 1024)     # the kernel's row widths; they must match
TINY = 1e-38                  # the chain program's floor of a maximum or sum


def engages(dtype: torch.dtype, device, card: int) -> bool:
    """Whether the chain program's (non-functional) steps over a
    ``card``-state chain of ``dtype`` on ``device`` run the row kernel:
    float32 on a CUDA device with ``card <= K_MAX`` (the CPU, meta tensors,
    float64 and the half types keep the plain steps)."""
    return (dtype == torch.float32 and torch.device(device).type == "cuda"
            and 1 <= card <= K_MAX)


def width(card: int) -> int:
    """The kernel's row width for ``card`` states: the narrowest of
    :data:`WIDTHS` that holds them."""
    return next(w for w in WIDTHS if card <= w)


def reference_rows(y: torch.Tensor, m: Optional[torch.Tensor],
                   scale: Optional[torch.Tensor] = None,
                   post: Optional[torch.Tensor] = None) -> None:
    """The row pass in plain PyTorch, in place over the product ``y`` [B,
    K]: forward (``post`` None) ``y`` = (y / s) ⊙ m (y / s where ``m`` is
    None) and ``scale`` [B, 1] (or [B]) = s; backward ``post`` = its
    normalised product with y / s and, where ``m`` is given, ``y`` = m ⊙
    (y / s) (else ``y`` is left as it is)."""
    s = y.amax(dim=-1, keepdim=True).clamp_(min=TINY)
    if post is None:
        y.div_(s)
        if m is not None:
            y.mul_(m)
        if scale is not None:
            scale.copy_(s.view(scale.shape))
        return
    g = y / s
    p = post.mul_(g)
    p.div_(p.sum(dim=-1, keepdim=True).clamp_min(TINY))
    if m is not None:
        torch.mul(m, g, out=y)


def rows(y: torch.Tensor, m: Optional[torch.Tensor],
         scale: Optional[torch.Tensor] = None,
         post: Optional[torch.Tensor] = None) -> None:
    """:func:`reference_rows` as one launch of the CUDA kernel: float32,
    contiguous tensors on one device, K at most :data:`K_MAX`."""
    B, K = y.shape
    mats = [t for t in (y, m, post) if t is not None]
    if any(t.dtype != torch.float32 for t in mats):
        raise TypeError("the chain row kernel takes float32 tensors")
    if not (1 <= K <= K_MAX) or any(t.shape != (B, K) for t in mats):
        raise ValueError(f"chain row shapes: y {tuple(y.shape)} (K <= "
                         f"{K_MAX}), every matrix [B, K]")
    if scale is not None and scale.numel() != B:
        raise ValueError(f"scale holds {scale.numel()} values, not B = {B}")
    dev = y.device
    if any(t.device != dev for t in mats) or (
            scale is not None and scale.device != dev):
        raise ValueError("the chain row pass's tensors must be on one device")
    if not all(t.is_contiguous() for t in mats) or (
            scale is not None and not scale.is_contiguous()):
        raise ValueError("the chain row kernel takes contiguous tensors")
    from .cuda_build import load_library

    lib = load_library()
    # 16 bytes at a time where every row is 16-byte aligned
    vec = 4 if K % 4 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in mats) else 1

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (y.data_ptr(), ptr(m), ptr(scale), ptr(post), B, K, width(K), vec,
            torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        rc = lib.jt_chain_rows(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.jt_chain_rows(*args)
    if rc != 0:
        raise RuntimeError("chain row kernel launch failed: "
                           + lib.jt_error_string(rc).decode()
                           + f" (code {rc})")


def forward_step(xm: torch.Tensor, A: torch.Tensor, m: Optional[torch.Tensor],
                 out: torch.Tensor,
                 scale: Optional[torch.Tensor] = None) -> None:
    """Forward step k: ``out`` = F_{k+1} ⊙ M_{k+1} (F_m where ``m`` is None)
    and ``scale`` = the rows' floored maxima, from ``xm`` = F_k ⊙ M_k, ``A``
    = A_k and ``m`` = M_{k+1}.  The product, then :func:`rows`
    (``launches`` counts it)."""
    torch.matmul(xm, A, out=out)
    rows(out, m, scale=scale)
    forward_step.launches += 1


def backward_step(mg: torch.Tensor, A: torch.Tensor,
                  m: Optional[torch.Tensor], out: torch.Tensor,
                  post: torch.Tensor) -> None:
    """Backward step k: from ``mg`` = M_{k+1} ⊙ G_{k+1} and ``A`` = A_k
    (read transposed), ``post`` = F_k ⊙ M_k overwritten by position k's
    posterior and ``out`` = M_k ⊙ G_k (``m`` = M_k; None: the product).
    The product, then :func:`rows` (``launches`` counts it)."""
    torch.matmul(mg, A.t(), out=out)
    rows(out, m, post=post)
    backward_step.launches += 1


forward_step.launches = 0
backward_step.launches = 0

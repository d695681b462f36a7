"""The fused max-plus collect of the tree-MAP program: one clique's scores
and argmax without its [b, clique_states] tensor.

For clique ``c``, batch row ``b`` and output ``j`` (a separator state of
the traceback's (sep, rest) layout; the root has one output)::

    s(b, v)   = pot[v] + mask_1[b, v] + ... + msg_1[b, v] + ...   (float32)
    val[j, b] = max over r of s(b, j * rest_n + r)
    idx[j, b] = the lowest r that attains it

with the masks clamped at -1e30 and every addend broadcast into the
clique: the sum and its order are the plain path's
(``map_executor._collect_plain``).  On the card this runs the hand-written
CUDA kernel ``csrc/map_collect.cu`` (a memset of its keys, the kernel, and
a small launch that unpacks the keys; it replaces no TPU kernel), for any
number of masks and messages and any mask sizes.
:func:`reference_collect` is its plain PyTorch version, which reads the
same arguments (offset table, strides) the same way; the wrapper
:func:`collect` takes it for tensors on the CPU and launches the kernel for
CUDA tensors.  The tree-MAP program calls :func:`collect` for every clique
where :func:`engages` (float32 on a CUDA device); the CPU and the other
dtypes keep the plain path.

A clique's layout (:class:`CliqueLayout`) is host data made once per
program: the states in (sep, rest) order and, for each state, the offset
of the potential, of each mask's staged row and of each child's separator
state (an int32 table ``[1 + k, states]``, on the device once per device).
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

# kernel constants; they must match csrc/map_collect.cu
THREADS = 256                 # a block: 8 warps
WARPS = THREADS // 32
ARG_ADDENDS = 32              # addends described in the launch's arguments
GROUPS = (1, 2, 3, 4)         # states of a warp's step
SMEM_BYTES = 227 * 1024       # a block's shared memory (every sm_90 card)
NEG = -1e30                   # the plain path's clamp of a mask
# blocks a launch aims at on each SM, and the fewest states a warp takes
BLOCKS_PER_SM = 16
MIN_WARP_STATES = 32
# an addend as the kernel reads it (struct Addend, 48 bytes)
ADDEND_DTYPE = np.dtype([("ptr", "<u8"), ("bstride", "<i8"),
                         ("ostride", "<i8"), ("size", "<i4"),
                         ("vary", "<i4"), ("inner", "<i4", (max(GROUPS),))])


def engages(dtype: torch.dtype, device: torch.device) -> bool:
    """Whether the tree-MAP program collects the cliques of potentials of
    ``dtype`` on ``device`` with the kernel: float32 on a CUDA device (the
    CPU, meta tensors, bfloat16, float16 and float64 keep the plain
    path)."""
    return dtype == torch.float32 and torch.device(device).type == "cuda"


def _strides(shape: Sequence[int]) -> List[int]:
    st = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        st[i] = st[i + 1] * shape[i + 1]
    return st


def smem_bytes(stage_rows: int, n_addends: int, rpt: int) -> int:
    """Shared memory of a block: ``stage_rows`` mask states staged for 32 x
    rpt rows, and each warp's table entries of at most
    :data:`ARG_ADDENDS` addends for 32 states."""
    return 4 * (stage_rows * 32 * rpt
                + WARPS * (1 + min(n_addends, ARG_ADDENDS)) * 32)


class CliqueLayout:
    """One clique as the kernel reads it.

    ``order``: the clique's variables in the order of the states ``v``
    (separator first, then the rest, for a non-root clique; the clique's
    own order at the root); ``out_n`` the separator's states (1 at the
    root) and ``rest_n`` the states of each output.  ``mask_vars``: the
    clique's masked variables, in the order of their adds; ``child_seps``:
    each child's separator variables, in its message's axis order."""

    def __init__(self, sizes: Sequence[int], clique_vars: Sequence[int],
                 order: Sequence[int], out_n: int,
                 mask_vars: Sequence[int], child_seps: Sequence[Sequence[int]]):
        self.sizes = sizes
        self.clique_vars = list(clique_vars)
        self.order = list(order)
        self.states = int(np.prod([self.sizes[v] for v in self.order]))
        self.out_n = int(out_n)
        self.rest_n = self.states // self.out_n
        self.mask_vars = list(mask_vars)
        self.child_seps = [list(s) for s in child_seps]
        self.mask_sizes = [self.sizes[v] for v in self.mask_vars]
        self.n_addends = len(self.mask_vars) + len(self.child_seps)
        # the kernel's step: the innermost axes of the rest, as many as
        # keep their product one of GROUPS
        self.group = 1
        for v in reversed(self.order):
            g = self.group * self.sizes[v]
            if g not in GROUPS or self.rest_n % g:
                break
            self.group = g
        self._tables: Dict[torch.device, torch.Tensor] = {}
        self._addends = None  # ADDEND_DTYPE [k]: all but the pointers
        self._launch: Dict[Tuple[int, int], "Launch"] = {}  # (b, card)

    def table_np(self) -> np.ndarray:
        """[1 + k, states] int32: for each state ``v``, the potential's flat
        index (clique order), each mask's staged row (the sizes of the masks
        before it plus the variable's state) and each child's flat
        separator state."""
        shape = [self.sizes[v] for v in self.order]
        flat = np.arange(self.states, dtype=np.int64)
        at = {v: (flat // s) % n
              for v, s, n in zip(self.order, _strides(shape), shape)}

        def index(vs):
            st = _strides([self.sizes[v] for v in vs])
            out = np.zeros(self.states, dtype=np.int64)
            for v, s in zip(vs, st):
                out += at[v] * s
            return out

        rows = [index(self.clique_vars)]
        prefix = 0
        for v, n in zip(self.mask_vars, self.mask_sizes):
            rows.append(prefix + at[v])
            prefix += n
        rows += [index(sep) for sep in self.child_seps]
        return np.stack(rows).astype(np.int32)

    def table(self, device: torch.device) -> torch.Tensor:
        t = self._tables.get(device)
        if t is None:
            if self.states >= 2**31:
                raise ValueError(
                    f"a clique of {self.states} states: the map_collect "
                    "kernel's int32 offsets take fewer than 2^31")
            tab = self.table_np()
            if self._addends is None:
                self._addends = self.addends_np(tab)
            t = self._tables[device] = torch.from_numpy(tab).to(device)
        return t

    def inner_np(self, tab: np.ndarray) -> np.ndarray:
        """[1 + k, group] int32: the offsets of a step's ``group`` states
        from its first, in each row of the table ``tab`` (the offsets are
        linear in the states' coordinates, so every step that starts at a
        multiple of ``group`` has these)."""
        return (tab[:, :self.group] - tab[:, :1]).astype(np.int32)

    def addends_np(self, tab: np.ndarray) -> np.ndarray:
        """The kernel's addend descriptors (:data:`ADDEND_DTYPE`, masks
        then messages) without their pointers and strides: a mask's size,
        whether the offsets vary over a step, and the step's offsets."""
        inner = self.inner_np(tab)[1:]
        out = np.zeros(self.n_addends, dtype=ADDEND_DTYPE)
        out["size"][:len(self.mask_sizes)] = self.mask_sizes
        out["vary"] = (inner != 0).any(axis=1)
        out["inner"][:, :self.group] = inner
        return out


class Addend(NamedTuple):
    """An addend as the kernel reads it: ``t[b * bstride + o * ostride]``
    for row ``b`` and offset ``o`` (bstride 0: unbatched); ``size`` is a
    mask's state count (0 for a message)."""
    t: torch.Tensor
    bstride: int
    ostride: int
    size: int


def addends(layout: CliqueLayout, masks: Sequence[torch.Tensor],
            msgs: Sequence[torch.Tensor]) -> List[Addend]:
    """The kernel's view of the clique's masks ([b, size_v], aligned with
    ``layout.mask_vars``) and children's float32 messages ([b, sep_states]
    in ``layout.child_seps`` order, any strides): no copy of a float32
    operand."""
    out = []
    for m, n in zip(masks, layout.mask_sizes):
        if m.dtype != torch.float32:
            m = m.float()
        out.append(Addend(m, m.stride(0) if m.shape[0] > 1 else 0,
                          m.stride(1), n))
    for m in msgs:
        out.append(Addend(m, m.stride(0) if m.shape[0] > 1 else 0,
                          m.stride(1), 0))
    return out


class Launch(NamedTuple):
    rpt: int       # rows a lane
    n_staged: int  # masks staged in shared memory (a prefix)
    wchunk: int    # states a warp
    nsplit: int    # blocks along the states


def launch_config(b: int, states: int, mask_sizes: Sequence[int],
                  n_addends: int, group: int, sm_count: int) -> Launch:
    """How the kernel covers b rows of a clique: 4 rows a lane from 65 rows
    up (2 from 33, else 1); every mask among the first
    :data:`ARG_ADDENDS` addends staged in shared memory, fewer rows a lane
    and then fewer staged masks (the last first) where they would not fit
    :data:`SMEM_BYTES`.  The states are split so that a launch holds about
    ``BLOCKS_PER_SM`` blocks an SM, a warp taking at least
    ``MIN_WARP_STATES`` states (a multiple of ``group``)."""
    rpt = 4 if b > 64 else 2 if b > 32 else 1
    n_staged = min(len(mask_sizes), ARG_ADDENDS)
    while smem_bytes(sum(mask_sizes[:n_staged]), n_addends,
                     rpt) > SMEM_BYTES:
        if rpt > 1:
            rpt //= 2
        else:
            n_staged -= 1
    tiles = -(-b // (32 * rpt))
    per = -(-states // (WARPS * -(-BLOCKS_PER_SM * sm_count // tiles)))
    wchunk = max(MIN_WARP_STATES, per, -(-states // (WARPS * 65535)))
    wchunk = -(-wchunk // group) * group
    return Launch(rpt, n_staged, wchunk, -(-states // (WARPS * wchunk)))


def reference_collect(layout: CliqueLayout, tab: torch.Tensor,
                      pot: torch.Tensor, adds: Sequence[Addend], b: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, read through the same table
    and strides: ([out_n, b] float32 scores, [out_n, b] int32 indices)."""
    tab = tab.to(torch.int64)
    acc = pot.reshape(-1)[tab[0]].expand(b, layout.states)
    nm = len(layout.mask_vars)
    if nm:
        stage = torch.cat([
            torch.as_strided(a.t, (b, a.size), (a.bstride, a.ostride))
            .clamp_min(NEG) for a in adds[:nm]], dim=1)
    for i, a in enumerate(adds):
        if i < nm:
            x = stage[:, tab[1 + i]]
        else:
            x = torch.as_strided(a.t, (b, a.t.shape[1]),
                                 (a.bstride, a.ostride))[:, tab[1 + i]]
        acc = acc + x
    vals, idx = acc.reshape(b, layout.out_n, layout.rest_n).max(dim=-1)
    return vals.t().contiguous(), idx.t().to(torch.int32).contiguous()


def descriptors(layout: CliqueLayout, adds: Sequence[Addend],
                n_staged: int) -> np.ndarray:
    """The addends as the kernel reads them (:data:`ADDEND_DTYPE`, [k]):
    pointer, strides, size, and the step's offsets.  A mask past the
    ``n_staged`` ones is read from global memory at its table offset, its
    staged row (its prefix plus its state), so its pointer starts its
    prefix earlier."""
    host = layout._addends.copy()
    host["ptr"] = [a.t.data_ptr() for a in adds]
    host["bstride"] = [a.bstride for a in adds]
    host["ostride"] = [a.ostride for a in adds]
    prefix = sum(layout.mask_sizes[:n_staged])
    for i in range(n_staged, len(layout.mask_sizes)):
        a = adds[i]
        host["ptr"][i] = a.t.data_ptr() - a.t.element_size() * prefix * a.ostride
        prefix += a.size
    return host


def _check(lib, rc: int) -> None:
    if rc != 0:
        raise RuntimeError("map_collect kernel launch failed: "
                           + lib.jt_error_string(rc).decode()
                           + f" (code {rc})")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def collect(layout: CliqueLayout, pot: torch.Tensor,
            masks: Sequence[torch.Tensor], msgs: Sequence[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """([out_n, b] float32 maxima, [out_n, b] int32 argmax over each
    output's rest states) of one clique: ``pot`` its float32 potential in
    the clique's axis order, ``masks`` and ``msgs`` as :func:`addends`
    takes them; b is the widest batch among them (1 with none).  The kernel
    for CUDA tensors, the plain version for CPU ones."""
    adds = addends(layout, masks, msgs)
    b = max([a.t.shape[0] for a in adds] + [1])
    pot = pot.contiguous()
    dev = pot.device
    tab = layout.table(dev)
    if not pot.is_cuda:
        return reference_collect(layout, tab, pot, adds, b)
    if pot.dtype != torch.float32:
        raise TypeError(f"the kernel takes a float32 potential, got {pot.dtype}")
    if any(a.t.device != dev for a in adds):
        raise ValueError("potential, masks and messages must be on one device")
    import ctypes

    from .cuda_build import load_library

    lib = load_library()
    cfg = layout._launch.get((b, dev.index))
    if cfg is None:
        cfg = layout._launch[b, dev.index] = launch_config(
            b, layout.states, layout.mask_sizes, layout.n_addends,
            layout.group, _sm_count(dev.index))
    keys = torch.empty((layout.out_n, b), dtype=torch.int64, device=dev)
    vals = torch.empty((layout.out_n, b), dtype=torch.float32, device=dev)
    idx = torch.empty((layout.out_n, b), dtype=torch.int32, device=dev)
    desc = (ctypes.c_int64 * 10)(
        layout.states, layout.rest_n, b, len(layout.mask_vars),
        len(layout.child_seps), cfg.n_staged, cfg.rpt, layout.group,
        cfg.wchunk, cfg.nsplit)
    host = descriptors(layout, adds, cfg.n_staged)
    # addends past the launch's arguments: read from device memory, copied
    # there on the stream from a pinned buffer
    ext = (torch.from_numpy(host[ARG_ADDENDS:].view(np.uint8)).pin_memory()
           .to(dev, non_blocking=True) if len(adds) > ARG_ADDENDS else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (pot.data_ptr(), tab.data_ptr(), keys.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), desc, host.ctypes.data,
            None if ext is None else ext.data_ptr(), stream)
    if dev.index == torch.cuda.current_device():
        rc = lib.jt_map_collect(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.jt_map_collect(*args)
    _check(lib, rc)
    return vals, idx

"""Connected-component minimum labels over an 8-connected grid (K2).

Counterpart of plvs_tpu/ops/cc_labels.py::cc_min_labels, the line
detector's connectivity pass. ``init`` [H, W] int32 holds each cell's
label (invalid cells a large sentinel), bit ci of ``conn_bits`` [H, W]
int32 links the cell to its ``SHIFTS[ci]`` neighbour; the result holds the
minimum ``init`` over each cell's connected component.

* CUDA tensors: the union-find kernel in ``csrc/cc_labels.cu`` — the true
  fixpoint for any component shape, with no iteration count.
* CPU tensors: :func:`cc_min_labels_plain`, which mirrors the JAX CPU
  reference (plvs_tpu/features/lines.py, the ``while_loop`` branch of
  ``detect_lines``) bit for bit, including its iteration cap.

The two differ only where the reference's cap stops it before the fixpoint
(a component longer than the sweeps can reach); with the cap lifted
(``max_chunks=None``) they agree exactly.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# sweep directions (dy, dx) and their link-bit indices — the stacking order
# of plvs_tpu/features/lines.py's ``connect`` and ops/cc_labels.SHIFTS
SHIFTS = [(1, 0), (-1, 0), (0, 1), (0, -1),
          (1, 1), (-1, -1), (1, -1), (-1, 1)]

# launches of the CUDA kernels (one per wrapper call that reaches the card)
launches = 0


def _seg_min_scan(lab: torch.Tensor, link: torch.Tensor, dim: int,
                  reverse: bool = False) -> torch.Tensor:
    """Segmented inclusive min-scan along ``dim``: ``link`` marks cells
    connected to their predecessor, so each cell receives the minimum label
    of its connected run up to itself (the reference's associative_scan
    over (head flag, value), here by shift doubling — min is exact, so the
    evaluation order does not matter)."""
    if reverse:
        lab, link = lab.flip(dim), link.flip(dim)
    val = lab.clone()
    head = ~link
    n = lab.shape[dim]
    k = 1
    while k < n:
        cur_v, cur_h = val.narrow(dim, k, n - k), head.narrow(dim, k, n - k)
        prv_v, prv_h = val.narrow(dim, 0, n - k), head.narrow(dim, 0, n - k)
        new_v = torch.where(cur_h, cur_v, torch.minimum(cur_v, prv_v))
        new_h = cur_h | prv_h
        val = torch.cat([val.narrow(dim, 0, k), new_v], dim)
        head = torch.cat([head.narrow(dim, 0, k), new_h], dim)
        k *= 2
    return val.flip(dim) if reverse else val


def cc_min_labels_plain(init: torch.Tensor, conn_bits: torch.Tensor,
                        max_chunks: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: the reference's Jacobi sweeps + segmented
    scans, exiting at the fixpoint or after ``max_chunks`` chunks of 8
    sweeps (None: no cap)."""
    connect = [((conn_bits >> ci) & 1).bool() for ci in range(8)]

    def sweep(lab):
        m = lab
        for ci, (sy, sx) in enumerate(SHIFTS):
            nb = torch.roll(lab, (sy, sx), (0, 1))
            m = torch.minimum(m, torch.where(connect[ci], nb, m))
        return m

    def scans(lab):
        lab = _seg_min_scan(lab, connect[2], 1)
        lab = _seg_min_scan(lab, connect[3], 1, reverse=True)
        lab = _seg_min_scan(lab, connect[0], 0)
        return _seg_min_scan(lab, connect[1], 0, reverse=True)

    lab = scans(init)
    i = 0
    while max_chunks is None or i < max_chunks:
        lab2 = lab
        for _ in range(8):
            lab2 = sweep(lab2)
        lab2 = scans(lab2)
        changed = bool((lab2 != lab).any())
        lab = lab2
        i += 1
        if not changed:
            break
    return lab


def _check(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int32 or t.dim() != 2:
        raise ValueError(f"{name}: expected [H, W] int32, got "
                         f"{tuple(t.shape)} {t.dtype}")


def cc_min_labels(init: torch.Tensor, conn_bits: torch.Tensor,
                  ref_max_chunks: int | None = None) -> torch.Tensor:
    """Min-label fixpoint over the grid. ``ref_max_chunks`` is the JAX CPU
    reference's iteration cap, honoured by the plain version (CPU tensors)
    only; the CUDA kernel always returns the true fixpoint."""
    global launches
    _check(init, "init")
    _check(conn_bits, "conn_bits")
    if init.shape != conn_bits.shape or init.device != conn_bits.device:
        raise ValueError("init and conn_bits must share shape and device")
    if init.device.type == "cpu":
        return cc_min_labels_plain(init, conn_bits, ref_max_chunks)
    if init.device.type != "cuda":
        raise ValueError(f"unsupported device {init.device}")
    init = init.contiguous()
    conn_bits = conn_bits.contiguous()
    h, w = init.shape
    out = torch.empty_like(init)
    if h * w == 0:
        return out
    parent = torch.empty(h * w, dtype=torch.int32, device=init.device)
    rootmin = torch.empty(h * w, dtype=torch.int32, device=init.device)
    lib = _lib()
    err = lib.plvs_cc_min_labels(
        init.data_ptr(), conn_bits.data_ptr(), out.data_ptr(),
        parent.data_ptr(), rootmin.data_ptr(), h, w,
        torch.cuda.current_stream(init.device).cuda_stream)
    _build.check(err, "cc_min_labels kernels")
    launches += 1
    return out


def _lib():
    lib = _build.load("cc_labels")
    fn = lib.plvs_cc_min_labels
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
    return lib

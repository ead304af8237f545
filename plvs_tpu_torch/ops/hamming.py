"""All-pairs Hamming distance matrix of packed 256-bit descriptors (K1).

Counterpart of plvs_tpu/ops/hamming.py (``hamming_pallas`` and the
``hamming_matrix`` dispatch). Descriptors are ``[N, 8]`` int32 tensors that
hold the uint32 bit patterns of the JAX package's ``[N, 8]`` uint32 arrays
(``arr.view(np.int32)``); the result is the ``[Q, K]`` int32 matrix of
popcount(xor) — exact, so kernel and plain version agree bit for bit.

* CUDA tensors: the hand-written kernel in ``csrc/hamming.cu``.
* CPU tensors: :func:`hamming_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

WORDS = 8
BITS = 32 * WORDS

# launches of the CUDA kernel (one per wrapper call that reaches the card)
launches = 0

_POP8 = torch.tensor([bin(i).count("1") for i in range(256)],
                     dtype=torch.int32)


def hamming_plain(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: promote to int64 (torch has no unsigned
    shifts on the CPU), XOR, and popcount through a byte table, one word
    at a time so the intermediate stays [Q, K]."""
    a = d1.to(torch.int64) & 0xFFFFFFFF
    b = d2.to(torch.int64) & 0xFFFFFFFF
    pop = _POP8.to(d1.device)
    out = torch.zeros((d1.shape[0], d2.shape[0]), dtype=torch.int32,
                      device=d1.device)
    for w in range(d1.shape[1]):
        x = a[:, w, None] ^ b[None, :, w]
        for s in (0, 8, 16, 24):
            out += pop[(x >> s) & 0xFF]
    return out


def _check(d: torch.Tensor, name: str) -> None:
    if d.dtype != torch.int32 or d.dim() != 2 or d.shape[1] != WORDS:
        raise ValueError(f"{name}: expected [N, {WORDS}] int32 descriptor "
                         f"words, got {tuple(d.shape)} {d.dtype}")


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[Q, 8] x [K, 8] int32 descriptor words -> [Q, K] int32 distances."""
    global launches
    _check(d1, "d1")
    _check(d2, "d2")
    if d1.device != d2.device:
        raise ValueError(f"d1 on {d1.device}, d2 on {d2.device}")
    if d1.device.type == "cpu":
        return hamming_plain(d1, d2)
    if d1.device.type != "cuda":
        raise ValueError(f"unsupported device {d1.device}")
    d1 = d1.contiguous()
    d2 = d2.contiguous()
    q, k = d1.shape[0], d2.shape[0]
    out = torch.empty((q, k), dtype=torch.int32, device=d1.device)
    if q == 0 or k == 0:
        return out
    lib = _lib()
    err = lib.plvs_hamming(d1.data_ptr(), d2.data_ptr(), out.data_ptr(), q, k,
                           torch.cuda.current_stream(d1.device).cuda_stream)
    _build.check(err, "hamming kernel")
    launches += 1
    return out


def _lib():
    lib = _build.load("hamming")
    fn = lib.plvs_hamming
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib

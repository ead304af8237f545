"""Hand-written CUDA kernels of the hot per-frame ops, with plain versions.

Each op here has two implementations of one function:

* a CUDA C++ kernel (``plvs_tpu_torch/csrc/*.cu``, built for sm_90a by
  ``_build.py``), launched for tensors on a CUDA device;
* a plain PyTorch version, used for tensors on the CPU (the tests) and as
  the reference the kernel is checked against on the card.

The choice follows the tensor's device, never the machine: a CUDA tensor
whose kernel cannot be built or launched raises.
"""

from __future__ import annotations

import torch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on. Asking for CUDA on a
    machine without it raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain versions")
    return dev

"""plvs_tpu_torch — the PyTorch / CUDA port of plvs_tpu for NVIDIA Hopper.

The package mirrors plvs_tpu's layout (geometry/, features/, ops/, solvers/,
slam/, io/) so that each module's counterpart is easy to find. Plain tensor
code is PyTorch; every Pallas kernel of the JAX package on the ported path
is a CUDA C++ kernel under ``csrc/`` (built with nvcc for sm_90a at first
use, bound through ctypes — see ``ops/_build.py``), with a plain PyTorch
version of the same function beside its wrapper. The wrappers run the plain
version only for tensors that lie on the CPU; a CUDA tensor launches the
kernel or raises.

Entry points take ``device="cuda"`` by default; ``device="cpu"`` exists for
the CPU tests. The package imports neither jax nor plvs_tpu.
"""

import torch

# TF32 off for every float32 matmul and convolution: the line detector sums
# integer-valued support weights with a [K, n_cell] masked matmul
# (features/lines.py) and the pyramid resamples with weight-matrix matmuls;
# TF32's 10-bit mantissa would move line endpoints and keypoints away from
# the float32 reference (and change which components survive the
# top-max_lines ranking). cuBLAS float32 is the default, cuDNN's is not.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

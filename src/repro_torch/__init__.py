"""Jasper ANNS in PyTorch and CUDA: the port of `repro` to an NVIDIA H100.

Same sub-package layout and names as the JAX package, so each module's
counterpart is found under the same path. Plain tensor code is PyTorch;
the Pallas TPU kernels (the search path's and the flash attention's) are
hand-written CUDA C++ for `sm_90a` under `csrc/`, built with `nvcc` at
first use and bound with `ctypes` (see `kernels/build.py`).

Entry points run on `cuda` unless the caller passes `device="cpu"`; with
no GPU and no explicit CPU device they raise (see `device.py`).
"""

import torch

# The JAX package is the float32 reference, and TF32 keeps only about three
# decimal digits: matmuls (query rotation, RaBitQ encode, brute-force ground
# truth, prune Gram matrices) must stay in full float32 on the card. This is
# the one place the package sets it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

"""PyTorch/CUDA port of the BETA reproduction (``repro``), slice by slice.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs/``, ``core/``, ``kernels/``, ``models/``, ``runtime/``) so each
module's counterpart sits at the same path.  It imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``.

Device policy: entry points take ``device="cuda"`` by default and run on
the CPU only when the caller passes ``device="cpu"``.  A kernel wrapper
launches its hand-written CUDA kernel for a CUDA tensor and falls to its
plain PyTorch version only for a CPU tensor.

Float32 matrix products must not silently run in TF32 (the unembed is the
one large float product on the serving path), so importing the package
turns TF32 off for both cuBLAS and cuDNN.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

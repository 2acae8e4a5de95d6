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
one large float product of the quantized serving path), so importing the
package turns TF32 off for both cuBLAS and cuDNN.  A bf16 product (float
serving) must accumulate in float32 and round once, as the reference's
does, so cuBLAS's reduced-precision split-K reductions are turned off too.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False

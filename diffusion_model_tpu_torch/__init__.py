"""diffusion_model_tpu_torch — the PyTorch and CUDA port of diffusion_model_tpu.

Conditional generation of SiO2 local structures from EELS spectra with an
E(3)-equivariant diffusion model, served from the JAX package's ``.npz``
snapshots. The per-edge work of every EGCL runs in a hand-written CUDA
kernel on the card, over the dense pair grid (``ops/egcl_pair.py``,
``csrc/egcl_pair.cu``) or over kNN neighbour lists for large cells
(``ops/egcl_knn.py``, ``csrc/egcl_knn.cu``), and in its plain PyTorch
statement on the CPU.

TF32 is switched off for float32 matmuls and convolutions: TF32 keeps about
three decimal digits, and the float32 path is the one held to the JAX
reference at 2e-4 relative. Geometry and masked reductions stay float32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

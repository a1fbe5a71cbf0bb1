"""PyTorch/CUDA port of the FAGP system in ``repro`` (the JAX package).

The layout mirrors ``repro`` (``core/``, ``kernels/``, ``bank/``,
``optim/``, ``data/``, ``launch/``, ``checkpoint/``, ``obs/``, and of the
LM half ``models/`` and ``configs/``) so every
module has a counterpart there, and the JAX package is the reference each
module is tested against.  The package imports ``torch`` only: nothing of
``jax`` and nothing of ``repro``.

Every entry point takes ``device=`` and defaults to ``"cuda"``; with no
card it raises instead of carrying on on the CPU (pass ``device="cpu"`` to
run the plain PyTorch versions of the kernels, as the tests do).

Precision: everything is float32.  TF32 is switched off here, at import,
for both matmul and cuDNN: the scaled system B = I + D G D / sigma^2 is
factorized by an f32 Cholesky whose condition number reaches ~1e5 at
paper scale, and the JAX package's cross-backend gates (1e-3 on B and b,
5e-3 on u and chol) do not hold with TF32's ~3 decimal digits.  The LM
half (``models/``) runs in bfloat16 as the reference does; its products
accumulate in float32 there, so bfloat16 reductions inside a product
(cuBLAS's split-K in reduced precision) are switched off here too.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

from .device import resolve_device  # noqa: E402
# the core first: the kernels' plain versions import its recurrence, so a
# first import of ``repro_torch.kernels.*`` finds the core whole
from . import core  # noqa: E402,F401

__all__ = ["resolve_device"]

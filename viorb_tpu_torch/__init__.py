"""viorb_tpu_torch — the PyTorch + CUDA port of viorb_tpu.

The package mirrors `viorb_tpu`'s module paths and public names, so each
port module sits where its JAX counterpart does. It imports torch and
numpy only: it never imports jax or `viorb_tpu`, because the GPU host it
targets has no JAX. `viorb_tpu` stays the reference the port is tested
against (tests/test_torch_*.py).

Where the JAX package wrote a Pallas kernel for the TPU, the port has a
hand-written CUDA kernel beside a plain PyTorch version of the same
function: a CUDA tensor goes to the kernel (or raises), a CPU tensor to
the plain version. Everything else is plain PyTorch.

Entry points that build tensors take `device=None`, which means the card
(`default_device()`, raising without one); `device="cpu"` asks for the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

# The reference forces exact f32 matmuls (viorb_tpu/__init__.py sets
# jax_default_matmul_precision="highest"): TF32 keeps ~3 decimal digits,
# which bends rotation chains and moves pyramid resize weights. cuDNN's
# default is TF32 for convolutions (the descriptor patch blur), so turn both
# off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from viorb_tpu_torch.device import default_device  # noqa: E402

__all__ = ["default_device"]

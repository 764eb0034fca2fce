"""Where the port's entry points put their tensors when the caller does
not say: on the card. There is no quiet CPU: without a CUDA device the
default raises, and a caller who wants the CPU asks for it
(`device="cpu"`), as the parity tests do."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """`torch.device("cuda")`; raises RuntimeError without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "viorb_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """The device a `device=` argument names; None is the default device."""
    return default_device() if device is None else torch.device(device)

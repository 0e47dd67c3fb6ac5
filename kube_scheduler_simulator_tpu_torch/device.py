"""Device and working-dtype resolution for the port.

The port runs on the card unless the caller asks for the CPU: a missing
card is an error, never a silent fallback.  The working dtype follows the
reference's rule (float32 on the accelerator, float64 for the bit-exact
CPU runs) and can be overridden per engine.
"""

from __future__ import annotations

import torch

# Full-precision float32 products everywhere (the one-hot expansions and
# every score formula must stay exact integer arithmetic).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` means the card; ``"cpu"`` only when the caller says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this port runs on an NVIDIA GPU unless the caller "
            "passes device='cpu' (torch.cuda.is_available() is False)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_dtype(device: torch.device, dtype: "torch.dtype | None" = None) -> torch.dtype:
    """float32 on the card, float64 on the CPU, unless ``dtype`` is given."""
    if dtype is not None:
        return dtype
    return torch.float32 if device.type == "cuda" else torch.float64

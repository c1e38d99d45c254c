"""Device selection for the port's entry points.

Entry points default to ``device="cuda"`` and never fall back to the CPU on
their own: the CPU runs only when the caller asks for it, as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev

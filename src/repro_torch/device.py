"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Asking
for CUDA on a host without a card raises: the port never falls back to
the CPU on its own. The CPU is used only when a caller asks for it, as
the tests do.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def get_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve ``device`` (default ``cuda``, indexed: ``cuda:<current>``,
    so it compares equal to a tensor's device); raise if CUDA is asked
    for and absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def batch_from_numpy(batch: dict, device=None) -> dict:
    """A batch of numpy arrays (a recsys, LM or graph batch) as tensors on
    ``device`` (default ``cuda``), same keys and dtypes."""
    dev = get_device(device)
    return {k: torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in batch.items()}

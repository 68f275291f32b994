"""Device selection: the port runs on CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None):
    """``None``/``"cuda"`` -> the current CUDA device (raises without one);
    ``"cpu"`` (or a CPU ``torch.device``) -> the CPU. Never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "directvoxgo_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU explicitly")
    return dev

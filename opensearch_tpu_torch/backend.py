"""Device resolution and float32 pinning for the PyTorch port.

Every entry point of the port takes an explicit ``device``. The default is
the card: ``resolve_device("cuda")`` raises when no CUDA device is
present, and nothing in the port moves work to the CPU on its own. The
CPU is reached only when a caller asks for it (``device="cpu"``), which is
how the CPU test-suite runs the port.

float32 products run in full float32: TF32 keeps about three decimal
digits and flips near-tie neighbours, which breaks the exact path's
recall of 1.0 (the reason the JAX package pins ``Precision.HIGHEST`` in
ops/knn.py and ops/fused.py). Importing this module pins both switches.
"""

from __future__ import annotations

import torch


def pin_float32() -> None:
    """Full-float32 matrix products (no TF32) on the card and the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


pin_float32()


def resolve_device(device: torch.device | str | None = "cuda") -> torch.device:
    """The device an entry point runs on. ``None`` means the card. A CUDA
    device that is not present is an error, never a quiet CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device [{dev}] was requested but torch.cuda.is_available() is "
            f"false; pass device=\"cpu\" to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device [{dev}] (cuda or cpu)")
    return dev

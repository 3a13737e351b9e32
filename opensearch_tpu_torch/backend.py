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


# the process-wide override of serving_devices (None: the node's own rule)
_serving_override: list[torch.device] | None = None


def serving_devices(device: torch.device | str | None = "cuda"
                    ) -> list[torch.device]:
    """The devices a node on `device` spreads its shards over, the
    counterpart of the reference's ``jax.devices()``: for a CUDA node every
    visible card, the node's own first; for a CPU node ``[cpu]``. Where
    :func:`set_serving_devices` has set a list, that list (a device may
    repeat in it, as the reference's 8 virtual CPU devices all sit on one
    host); it may repeat or reorder the node's kind of device but never
    change it (ValueError). Nothing moves to the CPU on its own: a CUDA
    node's list holds only cards."""
    dev = resolve_device(device)
    if _serving_override is not None:
        other = [str(d) for d in _serving_override if d.type != dev.type]
        if other:
            raise ValueError(
                f"serving devices {other} are not of the node's device "
                f"type [{dev.type}]: an override may repeat or reorder "
                f"devices, never move a node between the CPU and a card")
        return list(_serving_override)
    if dev.type == "cpu":
        return [dev]
    own = indexed(dev).index
    return [torch.device("cuda", own)] + [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())
        if i != own]


def set_serving_devices(devices: list | None) -> list[torch.device] | None:
    """Set the process-wide serving devices (``["cpu"] * 8``,
    ``[cuda:0] * 4``), or with None go back to each node's own rule.
    Returns the list it replaced. Only tests and chip_smoke.py set it."""
    global _serving_override
    if devices is not None:
        devices = [indexed(resolve_device(d)) for d in devices]
        if not devices:
            raise ValueError("serving devices: the list is empty")
    prev = _serving_override
    _serving_override = devices
    return prev


def indexed(dev: torch.device) -> torch.device:
    """A card with its index (``cuda`` is the current card)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev

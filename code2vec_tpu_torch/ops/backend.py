"""Kernel routing: the tensor's device picks the hand kernel or the plain
version; plus the kernels' launch counts and the entry points' device rule.

Counterpart of ``code2vec_tpu/ops/backend.py``, much smaller: there is one
kernel formulation (CUDA C++ for Hopper) and one plain formulation
(PyTorch). A wrapper given a CUDA tensor launches its kernel or raises; it
runs its plain version only for a tensor that lies on the CPU. An explicit
``backend=`` pins one route, and a tensor on the other device raises
instead of being moved.

Launch counts: each wrapper calls :func:`count_launch` right where it
launches its kernel, and nowhere else, so a caller can reset the counts,
drive a path, and read which kernels that path really went through.
"""

from __future__ import annotations

import torch

BACKENDS = ("auto", "cuda", "cpu")

_LAUNCHES: dict[str, int] = {}


def resolve(tensor: torch.Tensor, backend: str | None = None) -> str:
    """``"cuda"`` (launch the hand kernel) or ``"cpu"`` (plain version)
    for an op whose inputs live where ``tensor`` lives."""
    req = (backend or "auto").strip().lower()
    if req not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = tensor.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"no kernel route for tensors on {tensor.device}")
    if req != "auto" and req != dev:
        raise ValueError(
            f"backend={req!r} was pinned but the inputs lie on {dev!r}: a "
            "CUDA tensor launches the kernel, a CPU tensor runs the plain "
            "version"
        )
    return dev


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. With no GPU visible and no explicit request this raises —
    there is no silent fallback to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper)."""
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> dict[str, int]:
    """A snapshot of the launch counts since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()

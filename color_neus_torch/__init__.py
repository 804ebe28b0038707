"""color_neus_torch: the PyTorch / CUDA (Hopper) port of color_neus_tpu.

Module names follow the JAX package so each function has an obvious
counterpart there. The package imports torch and numpy only: never jax,
never color_neus_tpu.

Entry points run on CUDA unless the caller passes device="cpu"; without
a card and without that argument they raise. Every CUDA kernel sits
beside its plain PyTorch version, which runs only for CPU tensors.
"""

from __future__ import annotations

import torch


def pin_precision() -> None:
    """Full-f32 matmuls and convolutions: no TF32 anywhere.

    TF32 keeps ~3 decimal digits; a silently-reduced "f32" default was a
    real geometry error on the TPU (bf16 there), so every entry point and
    every test sets these on purpose."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless asked otherwise.

    No silent CPU fallback: without a card the caller must pass
    device="cpu"."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev

"""Command-line tools of the port (run as python -m color_neus_torch.tools.<name>)."""


def platform_name(device) -> str:
    """JAX's name of a device's platform, as the evidence tools report it:
    "gpu" for a CUDA card, else the torch device type."""
    return "gpu" if device.type == "cuda" else device.type

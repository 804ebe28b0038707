"""Command-line tools of the port (run as python -m color_neus_torch.tools.<name>)."""

from __future__ import annotations

import argparse
import json


def platform_name(device) -> str:
    """JAX's name of a device's platform, as the evidence tools report it:
    "gpu" for a CUDA card, else the torch device type."""
    return "gpu" if device.type == "cuda" else device.type


def parse_device(argv, description: str):
    """The --device of a tool's command line (the card unless 'cpu')."""
    from color_neus_torch import resolve_device
    p = argparse.ArgumentParser(description)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' for the plain versions on the host)")
    return resolve_device(p.parse_args(argv).device)


def print_report(rep: dict, device, indent=None) -> dict:
    """Prints a tool's report as JSON, on the card with its name and power
    limit under "card"; returns the report."""
    if device.type == "cuda":
        from color_neus_torch.tools._timing import card_line
        rep["card"] = card_line()
    print(json.dumps(rep, indent=indent), flush=True)
    return rep

"""Command-line tools of the port (run as python -m color_neus_torch.tools.<name>)."""

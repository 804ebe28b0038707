"""NeRF-style sinusoidal positional encoding (port of ops/embedding.py).

Log-spaced bands 2^0..2^(L-1), layout [x, sin(2^0 x), cos(2^0 x),
sin(2^1 x), cos(2^1 x), ...], each entry the full d-dim vector
(frequency-major, sin before cos) — the column order of the JAX
package's pe_basis (ops/pallas/point_pipeline.py:385-407), so weights
keyed to column positions (geometric init zeroing) line up.
"""

from __future__ import annotations

import torch


def embedding_dim(d_in: int, num_freqs: int, include_input: bool = True) -> int:
    """Output feature size of positional_encoding."""
    return d_in * ((1 if include_input else 0) + 2 * num_freqs)


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_input: bool = True) -> torch.Tensor:
    """Encode x[..., d] -> [..., d*(include_input + 2*num_freqs)]."""
    if num_freqs <= 0:
        return x
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]                       # [..., L, d]
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)   # [..., L, 2, d]
    enc = enc.reshape(*x.shape[:-1], num_freqs * 2 * x.shape[-1])
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc

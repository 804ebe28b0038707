"""Map the JAX params pytree to and from the port's parameters.

The tree is nested dicts of numpy arrays, as the JAX package's params
(and its checkpoints) hold them:

    renderer/{sdf,color}/lin*/{v,g,b}
    renderer/relight/{in_layer,mlp*}/{w,b}
    renderer/variance/variance
    focal/{fx,fy}    pose/{r,t}

A dict whose values are all arrays becomes an nn.ParameterDict, any other
dict an nn.ModuleDict, so the port's parameters carry the same names and
leaves. No jax import: the arrays are plain numpy.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def state_from_numpy(tree: dict, device="cpu") -> nn.ModuleDict:
    """Nested dict of arrays -> nn.ModuleDict of nn.ParameterDicts (f32)."""
    def build(d):
        if all(not isinstance(v, dict) for v in d.values()):
            return nn.ParameterDict({
                k: nn.Parameter(torch.as_tensor(np.array(v, np.float32), device=device))
                for k, v in d.items()})
        return nn.ModuleDict({k: build(v) for k, v in d.items()})
    return build(tree)


def state_to_numpy(params: nn.Module) -> dict:
    """The inverse of state_from_numpy: nested dict of f32 numpy arrays."""
    if isinstance(params, nn.ParameterDict):
        return {k: v.detach().cpu().numpy().astype(np.float32) for k, v in params.items()}
    return {k: state_to_numpy(v) for k, v in params.items()}


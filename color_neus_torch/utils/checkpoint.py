"""Train-state checkpoints: port of color_neus_tpu/utils/checkpoint.py.

One atomic npz file (written to <path>.tmp, then os.replace) holding the
whole train state: every parameter, keyed by its module path
("params/renderer.sdf.lin0.v"), the optimizer's per-parameter state under
the same path ("optim/renderer.sdf.lin0.v/exp_avg"), the step, and the
torch.Generator state (the reference's RandomState pickle,
recorder.py:81-87). Loading checks the names and shapes against the state
it loads into and raises on any mismatch. No pickle: plain arrays only.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def save_checkpoint(path: str, state, generator=None) -> None:
    """Atomic save of a TrainState (params, optimizer, step) and, when
    given, the generator's state."""
    payload = {}
    params = dict(state.params.named_parameters())
    for name, p in params.items():
        payload[f"params/{name}"] = p.detach().cpu().numpy()
        for k, v in state.optimizer.state.get(p, {}).items():
            payload[f"optim/{name}/{k}"] = torch.as_tensor(v).detach().cpu().numpy()
    payload["step"] = np.asarray(state.step, np.int64)
    if generator is not None:
        payload["generator"] = generator.get_state().numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, state, generator=None) -> None:
    """Restore a checkpoint into `state` (in place) and, when given, the
    generator. Raises ValueError when the file's parameter names or any
    shape differ from the state's."""
    params = dict(state.params.named_parameters())
    with np.load(path, allow_pickle=False) as data:
        names = {k[len("params/"):] for k in data.files if k.startswith("params/")}
        if names != set(params):
            raise ValueError(f"{path}: parameters differ from the model's: missing "
                             f"{sorted(set(params) - names)}, unexpected "
                             f"{sorted(names - set(params))}")
        for name, p in params.items():
            arr = data[f"params/{name}"]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{path}: {name} has shape {arr.shape}, the model "
                                 f"{tuple(p.shape)}")
        optim = {}
        for k in data.files:
            if not k.startswith("optim/"):
                continue
            name, key = k[len("optim/"):].rsplit("/", 1)
            if name not in params:
                raise ValueError(f"{path}: optimizer state of unknown parameter {name}")
            arr = data[k]
            if arr.ndim and tuple(arr.shape) != tuple(params[name].shape):
                raise ValueError(f"{path}: {k} has shape {arr.shape}, the parameter "
                                 f"{tuple(params[name].shape)}")
            optim.setdefault(name, {})[key] = arr
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(torch.from_numpy(data[f"params/{name}"]))
        # through load_state_dict, so the optimizer places each entry on the
        # device its own policy asks for (Adam's step count: CPU, or the
        # parameter's device when fused or capturable)
        sd = state.optimizer.state_dict()
        order = [p for group in state.optimizer.param_groups for p in group["params"]]
        index = {id(p): i for i, p in enumerate(order)}
        sd["state"] = {index[id(params[name])]: {k: torch.from_numpy(v) for k, v in st.items()}
                       for name, st in optim.items()}
        state.optimizer.load_state_dict(sd)
        state.set_step(int(data["step"]))
        if generator is not None:
            if "generator" not in data.files:
                raise ValueError(f"{path}: holds no generator state")
            generator.set_state(torch.from_numpy(data["generator"].copy()))

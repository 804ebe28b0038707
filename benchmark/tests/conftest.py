"""The benchmark's CPU tests: `python -m pytest benchmark/tests -q` from
the root of the checkout. Card-only tests carry the `cuda` marker and skip
inside a fixture without a card."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the cells' traffic at a size a CPU test run holds: full widths, few rays,
# samples and small views
TINY = {"n_rays": 32, "n_samples": 16, "n_importance": 16, "trace_bundles": 1,
        "scene": {"views": 10, "height": 48, "width": 64, "focal": [115.7, 115.3]}}


@pytest.fixture
def tiny_workloads(tmp_path):
    """A workloads folder with every training cell's traffic file at TINY
    sizes (limits as committed)."""
    src = os.path.join(ROOT, "benchmark", "workloads")
    for name in os.listdir(src):
        with open(os.path.join(src, name)) as f:
            t = json.load(f)
        if t["kind"] == "train":
            t.update(TINY)
        elif t["kind"] == "extract":
            t.update(resolution=64, lines=256, trace_extractions=1)
        with open(tmp_path / name, "w") as f:
            json.dump(t, f)
    return str(tmp_path)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")

"""A run end to end at a tiny size on the CPU (the look for a card
skipped): the last line's keys, and no result without a card."""

import json
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.spec import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_line_keys(trace, tiny_workloads):
    r = run.run_cell("color_neus_dtu.train", 2 ** 31 + 7, 0.5, trace, device="cpu",
                     require_card=False, workloads_dir=tiny_workloads)
    assert list(r) == KEYS + (["breakdown"] if trace else []) + ["compared"]
    json.loads(json.dumps(r))
    # a tiny size sets no limit: the readings are those of the cell's size
    assert r["correct"] in (True, False) and r["failed"] == 0 and r["attempted"] >= 1
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {"train_rays_per_s", "train_peak_gib", "setup_s"}
    for v in r["compared"].values():
        assert set(v) == {"value", "limit"}


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "color_neus_dtu.train", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""

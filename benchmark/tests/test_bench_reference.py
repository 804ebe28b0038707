"""The plain reference against the port's plain f32 path (no kernel, no
twin) at a tiny size on the CPU: the same steps from the same inputs (a
run's set-up calls, the warm-up bundle and the first replay's bundle), so
the same losses, first gradients and updated parameters to rounding."""

import copy

import pytest

from benchmark import compare, scene as S, spec
from benchmark.drivers import train as D


@pytest.mark.parametrize("workload", ["color_neus_dtu.train", "neus_dtu.train"])
def test_reference_is_the_plain_step(workload, tiny_workloads):
    cell = spec.Cell(spec.load(), workload, workloads_dir=tiny_workloads)
    cfg = copy.deepcopy(cell.config)
    cfg["MODEL"]["RENDERER"].update(FUSED_MARCH="off", FUSED_SDF="off", FUSED_CORE="off")
    # bundles of 2 steps: the two calls make 4, which two f32 paths keep
    # to rounding at 32 rays (over 20, Adam amplifies the sign of gradients
    # near 0 into gaps of 1e-3)
    cfg["TRAIN"]["LOG_INTERVAL"] = 2
    sizes = D.sizes_of(cfg, cell.traffic)
    r = D.program_cfg(cfg, sizes)["MODEL"]["RENDERER"]
    seed = 2 ** 33 + 5
    sc = S.make_scene(cell.traffic["scene"], seed, "cpu")
    leaves = S.make_leaves(r, sc["H"], sc["W"], sc["focal"], sc["images"].shape[0], seed, "cpu")
    prog = D.Program(cfg, sizes, sc, leaves, cell.traffic["start_step"], S.step_seed(seed), "cpu")
    got = prog.setup_calls()
    n = 2 * prog.k
    ref = D.reference_steps(cfg, leaves, sc, sizes, cell.traffic["start_step"], seed, n)
    nums = compare.training(got, ref, leaves, 0)
    assert nums["loss_gap"] < 1e-5 and nums["grad_gap"] < 1e-5
    assert nums["change_gap"] < 1e-4 and nums["frozen_moved"] == 0.0
    # the steps moved every learnt leaf and the loss
    assert all(float((ref["params"][k] - leaves[k]).abs().max()) > 0 for k in ref["grad"])
    assert len(got["losses"]) == n and len(set(ref["losses"])) == n


def test_scene_and_leaves_repeat_from_the_seed():
    spec_ = {"views": 3, "height": 8, "width": 12, "focal": [20.0, 20.0]}
    a, b = S.make_scene(spec_, 2 ** 40 + 1, "cpu"), S.make_scene(spec_, 2 ** 40 + 1, "cpu")
    assert (a["images"] == b["images"]).all() and (a["c2w"] == b["c2w"]).all()
    assert a["masks"].sum() > 0 and (a["masks"] < 1).any()

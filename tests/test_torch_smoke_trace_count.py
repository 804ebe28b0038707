"""chip_smoke.py phase 11's count of an arm's kernels in a trace of its
captured bundle's replays (busy_of_replays), on made-up traces: a trace
that lost a device record is traced again, and the counts must then hold
exactly; a count above the arm's, a shortfall in every trace, and a short
trace that holds as many records as the full one all fail."""

import pytest

import chip_smoke

ARM = "fused_march_f32"
SAVE, LOAD = chip_smoke.ARM_KERNELS[ARM]


def trace(load=1, extra=0):
    """Device records of one replay of a bundle: the sweeps, the arm's pair
    at `load` load launches a step, and `extra` unnamed kernels."""
    names = []
    for _ in range(chip_smoke.BUNDLE):
        names += ["void sdf_rays_kernel<64>(Params)"] * chip_smoke.SWEEPS_PER_STEP
        names += [f"(anonymous namespace)::{SAVE}(Params)", "at::vectorized_elementwise_kernel"]
    names += [f"(anonymous namespace)::{LOAD}(Params)"] * round(load * chip_smoke.BUNDLE)
    names += ["at::reduce_kernel"] * extra
    return [(10.0 * i, 10.0 * i + 5.0, n) for i, n in enumerate(names)]


FULL = trace()
LOST = FULL[:-1]                                  # the last load record lost
REPLACED = trace(load=0.9, extra=1)               # a load kernel replaced by another
ABOVE = trace(load=1.1)


class Loop:
    def __init__(self):
        self.bundles = 0

    def training_bundle(self):
        self.bundles += 1


@pytest.mark.parametrize("traces,ok", [
    ([FULL], True),
    ([LOST, FULL], True),
    ([LOST, LOST, FULL], True),
    ([LOST, LOST, LOST], False),
    ([ABOVE], False),
    ([REPLACED, FULL], False),
], ids=["full", "lost-then-full", "lost-twice-then-full", "lost-in-every-trace",
        "above-the-arm", "replaced-not-lost"])
def test_busy_of_replays_traces_again_only_for_a_lost_record(monkeypatch, traces, ok):
    loop, given = Loop(), iter(traces)

    def profiled(fn):
        fn()
        return 1.0, next(given)
    monkeypatch.setattr(chip_smoke, "profiled", profiled)
    if not ok:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.busy_of_replays(loop, 1, ARM, "11b")
        return
    _, busy, idle, per_step = chip_smoke.busy_of_replays(loop, 1, ARM, "11b")
    assert loop.bundles == len(traces)
    assert per_step[LOAD] == per_step[SAVE] == 1 and per_step["sdf_rays_"] == 4
    assert per_step["ray_march_load_bwd_kernel"] == 0
    assert 0 < busy and 0 < idle < 1

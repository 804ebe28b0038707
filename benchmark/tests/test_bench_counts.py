"""The benchmark's operation counts at the published widths, against a
count by hand."""

import json
import os

import pytest

from benchmark import spec
from benchmark.counts import march, networks, sweep


def renderer(name):
    with open(os.path.join(spec.HERE, "configs", f"{name}.json")) as f:
        return json.load(f)["MODEL"]["RENDERER"]


def test_color_neus_point_count():
    r = renderer("color_neus_dtu")
    # SDF: 39 -> 256 x 3 -> 217 (skip) -> 256 x 4 -> 257
    assert networks.sdf_layers(r) == [(39, 256), (256, 256), (256, 256), (256, 217),
                                      (256, 256), (256, 256), (256, 256), (256, 256),
                                      (256, 257)]
    assert networks.color_layers(r) == [(262, 256), (256, 256), (256, 256), (256, 256),
                                        (256, 3)]
    assert networks.relight_layers(r) == [(33, 256), (256, 256), (256, 256), (259, 256),
                                          (256, 3)]
    m = networks.point_macs(r)
    # forward: SDF 524,544 + reverse sweep 459,008 + colour 264,448 + relight 206,592
    assert m["forward"] == 524_544 + 459_008 + 264_448 + 206_592 == 1_454_592
    assert m["backward"] == 2_890_752
    per_point = 2 * (m["forward"] + m["backward"])
    # within 10% of the 9.27 MFLOP a point of a coarser hand count
    assert abs(per_point - 9.27e6) / 9.27e6 < 0.10
    assert march.flops(r, 1024, 128) == pytest.approx(1.139e12, rel=1e-3)
    # 1024 rays x (64 + 3 x 16) sweep points x 459,008 MACs
    assert sweep.flops(r, 1024, 64, 64, 4) == pytest.approx(2 * 1024 * 112 * 459_008)


def test_neus_point_count():
    r = renderer("neus_dtu")
    assert networks.color_layers(r)[0] == (289, 256)      # 9 + 256 + 24 (view PE)
    assert networks.relight_layers(r) == []
    m = networks.point_macs(r)
    assert m["forward"] == 524_544 + 459_008 + 271_360
    assert march.flops(r, 1024, 128) < march.flops(renderer("color_neus_dtu"), 1024, 128)


def test_bytes_bound_below_operations():
    """The march is bound by its operations at the published shape."""
    r = renderer("color_neus_dtu")
    assert march.bytes_moved(r, 1024, 128) / 3.35e12 < march.flops(r, 1024, 128) / 989e12


def test_grid_count_is_the_benchmarks_own(tiny_workloads):
    """The grid SDF's count takes the blocks the surface crosses under the
    reference SDF: none of the program's own statistics, and no more
    blocks than a sound sparse grid evaluates."""
    import numpy as np
    from benchmark import scene as S
    from benchmark.drivers import extract as X
    cell = spec.Cell(spec.load(), "color_neus_dtu.extract512", workloads_dir=tiny_workloads)
    t, r = cell.traffic, cell.config["MODEL"]["RENDERER"]
    res, f = t["resolution"], X.block_side(t["resolution"])
    bmin, bmax = (np.asarray(b, np.float32) for b in t["bbox"])
    leaves = X.make_leaves(cell, 2 ** 31 + 3, "cpu")
    blocks = S.surface_blocks(leaves, r, bmin, bmax, res, t["threshold"], f)
    stats = X.Program(cell.config, leaves, "cpu").extract(res, bmin, bmax, t["threshold"])[3]
    nb = res // f
    assert 0 < blocks <= round(stats["active_fraction"] * nb ** 3)
    c = X.extraction_counts(r, res, blocks, 100)
    assert c["grid"]["points"] == (nb + 1) ** 3 + blocks * f ** 3

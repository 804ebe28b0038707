"""The run's check that neither JAX nor the JAX package is loaded."""

import subprocess
import sys

from benchmark import run
from benchmark.spec import ROOT


def test_port_passes_and_jax_package_fails():
    port = {"color_neus_torch": object(), "color_neus_torch.models.neus": object(),
            "jaxtyping": object(), "torch": object()}
    assert run.forbidden_modules(port) == []
    assert run.forbidden_modules({**port, "color_neus_tpu": object()}) == ["color_neus_tpu"]
    assert run.forbidden_modules({**port, "jax.numpy": object(), "flax": object()}) == \
        ["flax", "jax.numpy"]


def test_harness_and_port_load_no_jax():
    code = ("import sys; import benchmark.run, benchmark.drivers.train, benchmark.calibrate; "
            "import color_neus_torch.models.trainer, color_neus_torch.runtime; "
            "print(benchmark.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"

"""Package-level checks of color_neus_torch: it imports neither jax nor
the JAX package nor the optional host libraries, its YAML mapping equals
the JAX package's on every shipped config, and chip_smoke.py's config
dict is the YAML sections it names."""

import dataclasses
import glob
import os
import subprocess
import sys

import pytest
import yaml

from color_neus_tpu.models.configs import renderer_config_from_cfg as jax_renderer_cfg
from color_neus_tpu.utils.config import get_config as jax_get_config

from color_neus_torch.models.configs import renderer_config_from_cfg
from color_neus_torch.utils.config import FrozenConfigError, get_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# torch itself may import tqdm; only what the port adds on top counts
_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import numpy, torch
base = set(sys.modules)
import color_neus_torch
mods = [m.name for m in pkgutil.walk_packages(color_neus_torch.__path__, "color_neus_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(k for k in set(sys.modules) - base
             if k.split(".")[0] in ("jax", "jaxlib", "color_neus_tpu", "yaml", "cv2",
                                    "optax", "tqdm"))
assert not any(k.split(".")[0] in ("jax", "color_neus_tpu") for k in sys.modules)
print(len(mods), bad)
assert len(mods) >= 15, mods
assert not bad, bad
tools = {"color_neus_torch.tools." + m for m in (
    "_timing", "bench_step", "bench_ab", "profile_step", "trace_profile", "march_ablate",
    "mesh_extraction_timing", "extract_probe", "merge_bench", "eval_fused_check")}
assert tools <= set(mods), tools - set(mods)
"""


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "config", "*.yml"))),
                         ids=os.path.basename)
def test_renderer_config_mapping_matches_jax(path):
    """Every field of the port's RendererConfig (a subset of the JAX one's:
    the port holds only what it reads) maps to the JAX package's value."""
    rcfg = get_config(path)["MODEL"]["RENDERER"]
    port = dataclasses.asdict(renderer_config_from_cfg(rcfg))
    ref = dataclasses.asdict(jax_renderer_cfg(jax_get_config(path)["MODEL"]["RENDERER"]))
    assert set(port) < set(ref)
    assert port == {k: ref[k] for k in port}


@pytest.mark.parametrize("key,value,default,read", [
    ("RAY_CHUNK", 4096, 0, True), ("COMPUTE_DTYPE", "bfloat16", "float32", True),
    ("N_OUTSIDE", 32, 0, True), ("FUSED_TILE", 1024, 512, False),
    ("THIN_DOTS", "mxu", "hilo", False)])
def test_renderer_keys_the_port_does_not_read_raise(key, value, default, read):
    """A TPU tiling key the port has no code for raises when set; a key it
    reads (RAY_CHUNK, COMPUTE_DTYPE, N_OUTSIDE since they were ported) maps
    to the JAX package's field; every JAX default and the mesh extraction's
    keys load."""
    rcfg = {"TYPE": "Color_NeuS", "COLOR": {"MODE": "no_view_dir"}, "EXTRACT_SPARSE": True}
    if read:
        port = dataclasses.asdict(renderer_config_from_cfg({**rcfg, key: value}))
        ref = dataclasses.asdict(jax_renderer_cfg({**rcfg, key: value}))
        assert port[key.lower()] == ref[key.lower()] == value
    else:
        with pytest.raises(NotImplementedError, match=key):
            renderer_config_from_cfg({**rcfg, key: value})
    assert renderer_config_from_cfg({**rcfg, key: default}) == renderer_config_from_cfg(rcfg)


def test_config_loader_matches_jax_and_freezes():
    path = os.path.join(REPO, "config", "Color_NeuS_synthetic.yml")
    cfg = get_config(path)
    assert cfg.to_dict() == jax_get_config(path).to_dict()
    assert cfg.TRAIN.OPTIMIZE.WARM_UP == 50
    with pytest.raises(FrozenConfigError):
        cfg.TRAIN["ITERATIONS"] = 1


def test_chip_smoke_config_is_the_yaml_sections():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with open(os.path.join(REPO, "config", "Color_NeuS_dtu.yml")) as f:
        dtu = yaml.safe_load(f)
    with open(os.path.join(REPO, "config", "Color_NeuS_synthetic.yml")) as f:
        synthetic = yaml.safe_load(f)
    assert chip_smoke.SMOKE_CFG["MODEL"] == dtu["MODEL"]
    for section in ("DATASET", "DATA_PRESET", "TRAIN"):
        assert chip_smoke.SMOKE_CFG[section] == synthetic[section], section
    assert set(chip_smoke.SMOKE_CFG) == {"MODEL", "DATASET", "DATA_PRESET", "TRAIN"}

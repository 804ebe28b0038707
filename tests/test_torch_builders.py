"""models/builders.py and models/protocol.py against the JAX package's, as
tests/test_utils.py holds JAX's: the RENDERER and MODEL registries hold
the reference's names, build_renderer's handle renders what JAX's handle
renders on the same weights (the render tolerance of test_torch_neus.py,
colour atol 2e-4), build_model's entry is a TrainLoop that trains, and
TrainLoop satisfies TrainerModule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import color_neus_tpu.models  # noqa: F401  (registers JAX's entries)
from color_neus_tpu.models.builders import build_renderer as jax_build_renderer

from color_neus_torch import pin_precision
from color_neus_torch.models import builders
from color_neus_torch.models.protocol import TrainerModule
from color_neus_torch.runtime import TrainLoop
from color_neus_torch.utils.config import config_from_dict
from color_neus_torch.utils.registry import DATASET, MODEL, RENDERER
from color_neus_torch.weights import state_from_numpy
from tests.test_torch_trainer import TINY_CFG

torch.set_num_threads(1)
pin_precision()

RENDERER_CFG = {"TYPE": "NeuS", "N_SAMPLES": 8, "N_IMPORTANCE": 4, "UP_SAMPLE_STEPS": 2,
                "PERTURB": 0.0,
                "SDF": {"D_HIDDEN": 32, "N_LAYERS": 2, "SKIP_IN": [], "MULTIRES": 2},
                "COLOR": {"MODE": "idr", "D_IN": 9, "D_HIDDEN": 32, "N_LAYERS": 1,
                          "MULTIRES_VIEW": 2}}


def test_registries_hold_the_reference_names():
    import color_neus_torch.data  # noqa: F401
    assert "NeuS" in RENDERER and "Color_NeuS" in RENDERER and "NeuS_Trainer" in MODEL
    assert "DTU" in DATASET and "Synthetic" in DATASET
    with pytest.raises(KeyError, match="NeRF"):
        builders.build_renderer({**RENDERER_CFG, "TYPE": "NeRF"})


@pytest.mark.parametrize("kind", ["NeuS", "Color_NeuS"])
def test_build_renderer_matches_jax(kind):
    cfg = dict(RENDERER_CFG, TYPE=kind)
    if kind == "Color_NeuS":
        cfg["COLOR"] = {"MODE": "no_view_dir", "D_IN": 6, "D_HIDDEN": 32, "N_LAYERS": 1,
                        "MULTIRES_VIEW": 0}
        cfg["RELIGHT"] = {"D_HIDDEN": 16}
    jh, h = jax_build_renderer(cfg), builders.build_renderer(cfg)
    assert isinstance(h, builders.RendererHandle) and h.rcfg.kind == jh.rcfg.kind
    jp = jh.init(jax.random.PRNGKey(0))
    pp = state_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    assert set(dict(pp.named_parameters())) == \
        set(dict(h.init(torch.Generator().manual_seed(0)).named_parameters()))
    o, d = np.array([[0.0, 0.0, -2.5]], np.float32), np.array([[0.0, 0.0, 1.0]], np.float32)
    near, far = np.array([1.5], np.float32), np.array([3.5], np.float32)
    args = tuple(map(jnp.asarray, (o, d, near, far)))
    want = jax.jit(lambda p: jh(p, *args, perturb_overwrite=0.0))(jp)
    got = h(pp, *map(torch.from_numpy, (o, d, near, far)), perturb_overwrite=0.0)
    assert got["color_fine"].shape == (1, 3)
    np.testing.assert_allclose(got["color_fine"].detach().numpy(),
                               np.asarray(want["color_fine"]), atol=2e-4)


def test_build_model_trains_and_trainloop_is_a_trainer_module():
    cfg = config_from_dict({**TINY_CFG, "MODEL": {**TINY_CFG["MODEL"],
                                                  "TYPE": "NeuS_Trainer"}})
    entry = builders.build_model(cfg, device="cpu")
    assert isinstance(entry, builders.NeuSTrainerEntry) and isinstance(entry.loop, TrainLoop)
    assert isinstance(entry.loop, TrainerModule)
    losses = entry.run(iterations=2)
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
    assert entry.loop.compute_loss({"loss": losses[-1]}) == float(losses[-1])

    class Partial:
        def training_step(self):
            return {}
    assert not isinstance(Partial(), TrainerModule)

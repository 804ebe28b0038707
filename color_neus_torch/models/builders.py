"""Registry-facing builders: string TYPE -> renderer / model factories
(the port's copy of color_neus_tpu/models/builders.py).

The reference's mmcv-style registries (lib/utils/builder.py: MODEL /
RENDERER, build_renderer at renderers/__init__.py:4, build_model_init at
builder.py:320) as thin handles around the functional core.
"""

from __future__ import annotations

from color_neus_torch.models import neus
from color_neus_torch.models.configs import renderer_config_from_cfg
from color_neus_torch.utils.registry import MODEL, RENDERER


class RendererHandle:
    """cfg (the reference's RENDERER schema) -> an init / apply handle."""

    def __init__(self, cfg: dict):
        self.rcfg = renderer_config_from_cfg(dict(cfg))

    def init(self, generator, device="cpu"):
        return neus.init_renderer(self.rcfg, generator, device)

    def __call__(self, params, rays_o, rays_d, near, far, **kw):
        return neus.render_rays(params, self.rcfg, rays_o, rays_d, near, far, **kw)


RENDERER.register_module("NeuS")(RendererHandle)
RENDERER.register_module("Color_NeuS")(RendererHandle)


def build_renderer(cfg: dict) -> RendererHandle:
    """renderers/__init__.py:4-5."""
    return RENDERER.build(cfg)


@MODEL.register_module("NeuS_Trainer")
class NeuSTrainerEntry:
    """The MODEL registry's entry: the training runtime of a top-level
    config (build_model_init; TrainLoop loads the dataset itself)."""

    def __init__(self, cfg, **kwargs):
        from color_neus_torch.runtime import TrainLoop
        self.loop = TrainLoop(cfg, **kwargs)

    def run(self, **kwargs):
        return self.loop.run(**kwargs)


def build_model(cfg, **kwargs):
    """builder.py:320-360: cfg.MODEL.TYPE selects the entry."""
    return MODEL.get(cfg["MODEL"]["TYPE"])(cfg, **kwargs)

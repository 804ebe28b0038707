"""BlendedMVS dataset: port of color_neus_tpu/data/bmvs.py (reference
lib/datasets/bmvs.py): DTU's layout in bmvs_<obj> directories."""

from __future__ import annotations

import os

from color_neus_torch.data.dtu import DTU
from color_neus_torch.utils.registry import DATASET


@DATASET.register_module("BlendedMVS")
class BlendedMVS(DTU):
    name = "BlendedMVS"

    def scene_dir(self, cfg: dict) -> str:
        return os.path.join(cfg["DATA_ROOT"], "BlendedMVS", f"bmvs_{cfg['OBJ_ID']}")

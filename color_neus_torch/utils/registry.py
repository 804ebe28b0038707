"""String -> factory registries for datasets / models / renderers (copy of
color_neus_tpu/utils/registry.py).

Slim equivalent of the reference's mmcv-style Registry
(lib/utils/builder.py:50-309): register classes by name, build from a
cfg whose TYPE selects the entry.
"""

from __future__ import annotations


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._entries: dict = {}

    def register_module(self, name: str | None = None):
        def deco(obj):
            key = name or obj.__name__
            if key in self._entries and self._entries[key] is not obj:
                raise KeyError(f"{key} already registered in {self.name}")
            self._entries[key] = obj
            return obj
        return deco

    def get(self, key: str):
        if key not in self._entries:
            raise KeyError(f"{key} not found in registry {self.name}; "
                           f"known: {sorted(self._entries)}")
        return self._entries[key]

    def build(self, cfg, **kwargs):
        return self.get(cfg["TYPE"])(cfg, **kwargs)

    def __contains__(self, key):
        return key in self._entries


DATASET = Registry("dataset")
MODEL = Registry("model")
RENDERER = Registry("renderer")

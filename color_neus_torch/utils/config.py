"""YAML config system, schema-compatible with the reference's yacs trees.

The port's copy of color_neus_tpu/utils/config.py: a nested attr-dict
with the reference's recursive freeze (lib/utils/config.py CN_R), the
same defaults and the same CLI overrides. PyYAML is imported only where
a YAML file is read, so the rest of the package runs without it.
"""

from __future__ import annotations

import copy


class FrozenConfigError(TypeError):
    pass


class Config(dict):
    """Nested attr-dict (cfg.MODEL.N_RAYS) with recursive freeze."""

    _frozen = False  # class fallback (instances set their own via freeze())

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        object.__setattr__(self, "_frozen", False)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def freeze(self):
        """Recursively forbid mutation (reference CN_R, config.py:8-39)."""
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, Config):
                v.freeze()
            elif isinstance(v, list):
                for x in v:
                    if isinstance(x, Config):
                        x.freeze()
        return self

    def _check(self):
        if object.__getattribute__(self, "_frozen"):
            raise FrozenConfigError(
                "Config is frozen (mutation after get_config is a bug; "
                "build a new dict/Config if you need a variant)")

    def __setitem__(self, key, value):
        self._check()
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._check()
        super().__delitem__(key)

    def update(self, *a, **k):
        self._check()
        return super().update(*a, **k)

    def setdefault(self, key, default=None):
        if key not in self:
            self._check()
        return super().setdefault(key, default)

    def pop(self, *a):
        self._check()
        return super().pop(*a)

    def popitem(self):
        self._check()
        return super().popitem()

    def clear(self):
        self._check()
        return super().clear()

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def to_dict(self):
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o
        return unwrap(self)


DEFAULTS = {
    "DATA_PRESET": {},
    "DATASET": {},
    "TRAIN": {
        "MANUAL_SEED": 1,
        "CONV_REPEATABLE": True,
        "BATCH_SIZE": 8,
        "LOG_INTERVAL": 50,
        "GRAD_CLIP_ENABLED": True,
        "GRAD_CLIP": {"TYPE": 2, "NORM": 0.001},
    },
    "MODEL": {"PRETRAINED": None},
}


def _deep_merge(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def config_from_dict(loaded: dict, arg=None) -> Config:
    """Merge a reference-schema dict over the defaults, apply CLI
    overrides, freeze (reference get_config, config.py:74-108)."""
    cfg = _deep_merge(DEFAULTS, loaded)

    if arg is not None:
        if getattr(arg, "batch_size", None) is not None:
            cfg["TRAIN"]["BATCH_SIZE"] = arg.batch_size
        else:
            arg.batch_size = cfg["TRAIN"]["BATCH_SIZE"]
        if getattr(arg, "reload", None) is not None:
            cfg["MODEL"]["PRETRAINED"] = arg.reload
        if getattr(arg, "obj_id", None) is not None:
            cfg.setdefault("DATASET", {})["OBJ_ID"] = arg.obj_id
        if getattr(arg, "iterations", None) is not None:
            cfg["TRAIN"]["ITERATIONS"] = arg.iterations
        if getattr(arg, "data_root", None) is not None:
            cfg.setdefault("DATASET", {})["DATA_ROOT"] = arg.data_root

    return Config.wrap(cfg).freeze()


def get_config(config_file: str, arg=None) -> Config:
    """Load a YAML config file (see config_from_dict)."""
    import yaml
    with open(config_file) as f:
        loaded = yaml.safe_load(f) or {}
    return config_from_dict(loaded, arg)

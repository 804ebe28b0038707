"""Static model configs: the port's copy of color_neus_tpu/models/configs.py.

Same dataclasses and the same reference-schema YAML mapping
(renderer_config_from_cfg), so every config/*.yml loads 1:1. The kernel
switches differ in meaning, because the port has its own kernels:

  fused_sdf    auto | on | off. auto/on run the placement sweeps through
               the hand-written CUDA kernel (ops/kernels/sdf_rays.py) for
               CUDA tensors and its plain PyTorch version for CPU tensors;
               off evaluates the sweeps through fields.sdf_value.
  fused_core   auto | on | off. With grad disabled (validation render,
               vertex colours) auto/on run the point-pipeline forward
               kernel (ops/kernels/point_pipeline.py; its plain twin for
               CPU tensors). With grad enabled (training) on runs the
               autograd Function of the forward kernel and the backward
               kernel (plain twins for CPU tensors), and auto runs the
               plain autograd core (the backward kernel is slower than it
               for now, PERF.md). off: the plain core. YAML reads a bare
               on / off as a boolean: true / false mean on / off here.
  fused_march  auto | on | off, the training loss path only
               (neus.render_rays_train). on runs the fused ray march:
               the autograd Function of the march's forward and backward
               kernels (ops/kernels/ray_march.py; plain twins for CPU
               tensors). auto and off run the plain PyTorch render core
               (what the JAX package runs off-TPU); auto takes the march
               only once a measured march step beats it (PERF.md).
  march_acts   auto | save | recompute, the march's backward (JAX's
               policy, ops/kernels/ray_march.py resolve_save_acts): save
               makes the forward kernel write the layer activations to a
               stash on the device and the backward kernel load them;
               recompute recomputes them in the backward; auto saves when
               the stashes of the step's R S points fit
               march_stash_budget_gb (MARCH_STASH_BUDGET_GB, 13.5 GiB; the
               environment's MARCH_STASH_BUDGET_GB overrides it), as at
               every shipped config's shape and at bench.py's.
  extract_precision  f32 | f32x3 | bf16: the grid-SDF kernel's dot type in
               mesh extraction (ops/kernels/sdf_mlp.py).
  extract_sparse  the coarse-to-fine mesh extraction (ops/mesh.py).
  ray_chunk    render_rays runs the plain core in chunks of ray_chunk rays,
               each rematerialised in the backward (torch.utils.checkpoint),
               when R > ray_chunk and ray_chunk divides R (neus.py).
  compute_dtype  float32 | bfloat16 | float16: the operands of the plain
               path's MLP products inside render_rays (fields.compute_dtype).
  n_outside    > 0 adds the NeRF++ inverted-sphere background (the nerf
               net); the training loss path then takes the plain core or
               fused_core, never the march, as in JAX.

RendererConfig holds only what the port reads. The JAX package's TPU
tiling keys (FUSED_TILE, MARCH_TILE) and THIN_DOTS have no Hopper meaning:
renderer_config_from_cfg raises NotImplementedError when one is set to
anything but its default, and skips N (the mesh block size, mc_block,
which the port's chunked grid does not read).

The point-pipeline and march kernels (fused_core / fused_march on, the
vertex colours, the validation render) compute the TPU kernels'
production arithmetic (ops/kernels/point_pipeline.py, bf16=True): the
colour and relight nets in bf16 products with f32 sums, the SDF chain in
the arithmetic march_bwd_precision names (JAX's knob, all three values):
  f32stash  (default) bf16 SDF products, f32 gates and stores, layer 0's
            weight grad in hi + lo bf16 passes;
  bf16      as f32stash, but the SDF chain's stores in bf16: the
            backward's tangent pre-gates, and the save mode's stash of the
            SDF layer outputs (half its SDF bytes), whose gates the load
            rebuilds from the bf16 values;
  f32       every SDF product (value, gradient and second-order chain,
            the SDF weight grads) in exact f32 on unrounded SDF weights.
Each value runs its own instantiation of the kernels (their _bf16s /
_f32s entries). Their positional encoding is exact f32, which is JAX's
THIN_DOTS vpu arithmetic (and what JAX's f32 mode uses); the default
THIN_DOTS hilo splits the phase's operand into two bf16 passes instead,
within 2^-17 of it. THIN_DOTS other than hilo raises NotImplementedError
(ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class SDFConfig:
    """SDF MLP (reference fields.py:12-116)."""
    d_in: int = 3
    d_out: int = 257
    d_hidden: int = 256
    n_layers: int = 8
    skip_in: tuple = (4,)
    multires: int = 6
    bias: float = 0.5
    scale: float = 3.0
    geometric_init: bool = True
    weight_norm: bool = True
    inside_outside: bool = False


@dataclass(frozen=True)
class ColorConfig:
    """IDR rendering MLP (reference fields.py:119-188)."""
    d_feature: int = 256
    mode: str = "idr"  # idr | no_view_dir | no_normal
    d_in: int = 9
    d_out: int = 3
    d_hidden: int = 256
    n_layers: int = 4
    weight_norm: bool = True
    multires_view: int = 4
    squeeze_out: bool = True


@dataclass(frozen=True)
class RelightConfig:
    """View-dependent residual MLP (reference fields.py:289-368)."""
    d_in: int = 6
    d_out: int = 3
    d_hidden: int = 256
    n_layers: int = 4
    y_in_layer: int = 3
    multires_view: int = 4
    include_grad: bool = True
    inv_sigmoid: bool = True


@dataclass(frozen=True)
class VarianceConfig:
    """Single learnable s (reference fields.py:277-286)."""
    init_val: float = 0.3


@dataclass(frozen=True)
class NeRFConfig:
    """NeRF++ background MLP (reference fields.py:192-274)."""
    depth: int = 8
    width: int = 256
    d_in: int = 4
    d_in_view: int = 3
    multires: int = 10
    multires_view: int = 4
    skips: tuple = (4,)


@dataclass(frozen=True)
class RendererConfig:
    """Renderer hyperparameters (reference NeuS.py:71-93)."""
    kind: str = "color_neus"  # "neus" | "color_neus"
    n_samples: int = 64
    n_importance: int = 64
    n_outside: int = 0
    up_sample_steps: int = 4
    perturb: float = 1.0
    fused_sdf: str = "auto"
    fused_core: str = "auto"
    fused_march: str = "auto"
    # the fused march's backward: auto | save | recompute (the module note)
    march_acts: str = "auto"
    # device memory (GiB) march_acts auto lets the save mode's stashes take
    march_stash_budget_gb: float = 13.5
    # dtype of the no-grad placement sweeps: bfloat16 (default) or float32
    sweep_dtype: str = "bfloat16"
    # activation of the placement sweeps: softplus (reference) or relu
    sweep_activation: str = "softplus"
    # the SDF chain's arithmetic in the fused kernels: f32stash | bf16 | f32
    # (the module note)
    march_bwd_precision: str = "f32stash"
    # mesh-extraction grid-SDF dot type (ops/mesh.py): f32 | f32x3 | bf16
    extract_precision: str = "f32"
    # rays per rematerialised chunk of the plain render core (0: one chunk)
    ray_chunk: int = 0
    # operand dtype of the plain path's MLP products (fields.compute_dtype)
    compute_dtype: str = "float32"
    # sparse (coarse-to-fine) mesh extraction
    extract_sparse: bool = False
    sdf: SDFConfig = field(default_factory=SDFConfig)
    color: ColorConfig = field(default_factory=ColorConfig)
    relight: RelightConfig = field(default_factory=RelightConfig)
    variance: VarianceConfig = field(default_factory=VarianceConfig)
    nerf: NeRFConfig = field(default_factory=NeRFConfig)

    def __post_init__(self):
        _enums = {
            "sweep_dtype": ("bfloat16", "float32"),
            "sweep_activation": ("softplus", "relu"),
            "kind": ("neus", "color_neus"),
            "fused_sdf": ("auto", "on", "off"),
            "fused_core": ("auto", "on", "off"),
            "fused_march": ("auto", "on", "off"),
            "march_acts": ("auto", "save", "recompute"),
            "march_bwd_precision": ("bf16", "f32stash", "f32"),
            "extract_precision": ("f32", "f32x3", "bf16"),
            "compute_dtype": ("float32", "bfloat16", "float16"),
        }
        for name, allowed in _enums.items():
            v = getattr(self, name)
            if v not in allowed:
                raise ValueError(
                    f"RendererConfig.{name}={v!r} not in {allowed}")


# renderer keys of the JAX package that choose TPU tilings and the TPU's
# unit for the thin PE dots, with their defaults there: no Hopper meaning
_UNPORTED_KEYS = {"FUSED_TILE": 512, "MARCH_TILE": 0, "THIN_DOTS": "hilo"}


def _lower_get(d: dict, key: str, default):
    """Fetch an UPPERCASE yaml key with a default."""
    v = d.get(key, default)
    if isinstance(v, list):
        v = tuple(v)
    return v


def _switch(d: dict, key: str) -> str:
    """A kernel switch; YAML 1.1 reads a bare on / off as true / false."""
    v = _lower_get(d, key, "auto")
    return {True: "on", False: "off"}.get(v, v) if isinstance(v, bool) else v


def renderer_config_from_cfg(rcfg: dict) -> RendererConfig:
    """Build a RendererConfig from a reference-schema dict (cfg.MODEL.RENDERER)."""
    sdf = rcfg.get("SDF", {})
    color = rcfg.get("COLOR", {})
    relight = rcfg.get("RELIGHT", {})
    dev = rcfg.get("DEVIATION", {})
    nerf = rcfg.get("NERF", {})
    for key, default in _UNPORTED_KEYS.items():
        if rcfg.get(key, default) != default:
            raise NotImplementedError(
                f"MODEL.RENDERER.{key}={rcfg[key]!r}: the port has no code that reads "
                f"it yet (default {default!r}); see ROADMAP.md")
    kind = {"NeuS": "neus", "Color_NeuS": "color_neus"}.get(rcfg.get("TYPE", "NeuS"), rcfg.get("TYPE", "neus"))
    if kind == "color_neus" and color.get("MODE", "idr") != "no_view_dir":
        raise ValueError("Color_NeuS requires COLOR.MODE == 'no_view_dir' (reference Color_NeuS.py:14)")
    return RendererConfig(
        kind=kind,
        n_samples=_lower_get(rcfg, "N_SAMPLES", 64),
        n_importance=_lower_get(rcfg, "N_IMPORTANCE", 64),
        n_outside=_lower_get(rcfg, "N_OUTSIDE", 0),
        up_sample_steps=_lower_get(rcfg, "UP_SAMPLE_STEPS", 4),
        perturb=_lower_get(rcfg, "PERTURB", 1.0),
        fused_sdf=_switch(rcfg, "FUSED_SDF"),
        fused_core=_switch(rcfg, "FUSED_CORE"),
        fused_march=_switch(rcfg, "FUSED_MARCH"),
        march_acts=_lower_get(rcfg, "MARCH_ACTS", "auto"),
        march_stash_budget_gb=_lower_get(rcfg, "MARCH_STASH_BUDGET_GB", 13.5),
        march_bwd_precision=_lower_get(rcfg, "MARCH_BWD_PRECISION", "f32stash"),
        sweep_dtype=_lower_get(rcfg, "SWEEP_DTYPE", "bfloat16"),
        sweep_activation=_lower_get(rcfg, "SWEEP_ACTIVATION", "softplus"),
        extract_precision=_lower_get(rcfg, "EXTRACT_PRECISION", "f32"),
        extract_sparse=bool(_lower_get(rcfg, "EXTRACT_SPARSE", False)),
        ray_chunk=_lower_get(rcfg, "RAY_CHUNK", 0),
        compute_dtype=_lower_get(rcfg, "COMPUTE_DTYPE", "float32"),
        sdf=SDFConfig(
            d_in=_lower_get(sdf, "D_IN", 3),
            d_out=_lower_get(sdf, "D_OUT", 257),
            d_hidden=_lower_get(sdf, "D_HIDDEN", 256),
            n_layers=_lower_get(sdf, "N_LAYERS", 8),
            skip_in=_lower_get(sdf, "SKIP_IN", (4,)),
            multires=_lower_get(sdf, "MULTIRES", 6),
            bias=_lower_get(sdf, "BIAS", 0.5),
            scale=_lower_get(sdf, "SCALE", 3.0),
            geometric_init=_lower_get(sdf, "GEOMETRIC_INIT", True),
            weight_norm=_lower_get(sdf, "WEIGHT_NORM", True),
            inside_outside=_lower_get(sdf, "INSIDE_OUTSIDE", False),
        ),
        color=ColorConfig(
            d_feature=_lower_get(color, "D_FEATURE", 256),
            mode=_lower_get(color, "MODE", "idr"),
            d_in=_lower_get(color, "D_IN", 9),
            d_out=_lower_get(color, "D_OUT", 3),
            d_hidden=_lower_get(color, "D_HIDDEN", 256),
            n_layers=_lower_get(color, "N_LAYERS", 4),
            weight_norm=_lower_get(color, "WEIGHT_NORM", True),
            multires_view=_lower_get(color, "MULTIRES_VIEW", 4),
            squeeze_out=_lower_get(color, "SQUEEZE_OUT", True),
        ),
        relight=RelightConfig(
            d_in=_lower_get(relight, "D_IN", 6),
            d_out=_lower_get(relight, "D_OUT", 3),
            d_hidden=_lower_get(relight, "D_HIDDEN", 256),
            n_layers=_lower_get(relight, "N_LAYERS", 4),
            y_in_layer=_lower_get(relight, "Y_IN_LAYER", 3),
            multires_view=_lower_get(relight, "MULTIRES_VIEW", 4),
            include_grad=_lower_get(relight, "INCLUDE_GRAD", True),
            inv_sigmoid=_lower_get(relight, "INV_SIGMOID", True),
        ),
        variance=VarianceConfig(init_val=_lower_get(dev, "INIT_VAL", 0.3)),
        nerf=NeRFConfig(
            depth=_lower_get(nerf, "D", 8),
            width=_lower_get(nerf, "W", 256),
            d_in=_lower_get(nerf, "D_IN", 4),
            d_in_view=_lower_get(nerf, "D_IN_VIEW", 3),
            multires=_lower_get(nerf, "MULTIRES", 10),
            multires_view=_lower_get(nerf, "MULTIRES_VIEW", 4),
            skips=_lower_get(nerf, "SKIPS", (4,)),
        ),
    )

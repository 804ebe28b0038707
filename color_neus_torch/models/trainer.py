"""Training core: port of color_neus_tpu/models/trainer.py.

One step samples pixels, renders them (camera nets, rays, hierarchy,
render core), computes the reference loss (NeuS_Trainer.py:129-171),
backpropagates, clips every parameter tensor's gradient on its own
(net_utils.py:174-184) and takes an Adam step (beta 0.9/0.99, eps 1e-8)
at the warm-up/cosine learning rate of the step before it is counted
(net_utils.py:56-78): step 0 runs at lr 0 under warm-up.

The step is split in two so a test can inject pixels: sample_pixels
draws them, train_step_pixels renders them (render_pixels) and updates
the state. The JAX package's render_random_rays is sample_pixels followed
by render_pixels. render_image renders a whole camera without gradients
(the validation view).

Everything a step reads from the step count (the learning rate, the
masked samplers' share) is computed on the device from the state's
counter, so make_train_multi_step can capture a bundle of steps into one
CUDA graph and replay it.

With TrainerConfig.mesh set (parallel.with_mesh; JAX's cfg.mesh) the
step is one rank's part of a data-parallel step: every rank draws the
same global pixels, renders its shard of them, computes the global loss
from the gathered per-ray partials (neus.render_rays_train), and sums
the gradients across ranks before the per-leaf clip (JAX's psum comes
before its clip too), so every replica takes the same update. The
generator draws the same numbers on every rank (the perturbation's noise
for the whole batch, of which a rank keeps its rows), so a run on W ranks
draws what a one-process run of the same seed draws.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from color_neus_torch.models import neus
from color_neus_torch.models.camera import (
    CameraConfig, focal_apply, init_focal, init_pose, pose_apply,
)
from color_neus_torch.models.configs import RendererConfig, renderer_config_from_cfg
from color_neus_torch.ops.rays import (
    all_rays_for_camera, near_far_from_sphere, rays_for_pixels, sample_pixels_masked,
    sample_pixels_masked_exact, sample_pixels_uniform,
)
from color_neus_torch.parallel.sharding import allreduce_grads, ray_shard
from color_neus_torch.utils.logger import logger


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainerConfig:
    n_rays: int = 1024
    eval_ray_size: int = 1024
    normalize_dir: bool = True
    opengl: bool = False
    include_mask: bool = True
    mask_rate: tuple = (0.5, 0.8)
    # 'exact' (default, reference ray_utils.py:61-76: exactly
    # int(rate * n_rays) in-mask rays, without replacement) or
    # 'bernoulli' (with replacement, the same split in expectation)
    mask_sample_mode: str = "exact"
    # the reference's maskless-path quirk (rays only from image 0)
    first_image_only_quirk: bool = False

    lambda_fine: float = 1.0
    lambda_eikonal: float = 0.1
    lambda_mask: float = 0.1
    lambda_relight: float = 1.0
    rgb_loss_type: str = "mse"  # mse | l1

    iterations: int = 100000
    lr: float = 5e-4
    optimizer: str = "adam"          # adam | rmsprop | sgd (net_utils.py:81-106)
    scheduler: str = "NEUS"          # NEUS (warmup+cosine) | NERF (exp decay)
    warm_up: int = 5000
    lr_alpha: float = 0.05
    gamma: float = 0.1               # NERF scheduler decay factor
    decay_steps: int = 250000        # NERF scheduler decay interval
    grad_clip_enabled: bool = True
    grad_clip_norm: float = 1.0

    camera: CameraConfig = field(default_factory=CameraConfig)
    renderer: RendererConfig = field(default_factory=RendererConfig)

    # the ray axis of a data-parallel run (parallel.Mesh, set by
    # parallel.with_mesh); None: one process
    mesh: object = None


def trainer_config_from_cfg(cfg: dict, H: int, W: int, n_cams: int) -> TrainerConfig:
    """Build from a reference-schema config dict (cfg.MODEL + cfg.TRAIN)."""
    m = cfg["MODEL"]
    t = cfg["TRAIN"]
    dp = cfg.get("DATA_PRESET", {})
    loss = m.get("LOSS", {})
    opt = t.get("OPTIMIZE", {})
    include_mask = dp.get("INCLUDE_MASK", True)
    return TrainerConfig(
        n_rays=m.get("N_RAYS", 1024),
        eval_ray_size=m.get("EVAL_RAY_SIZE", 10000),
        normalize_dir=m.get("NORMALIZE_DIR", True),
        opengl=dp.get("OPENGL_SYS", False),
        include_mask=include_mask,
        mask_rate=tuple(m.get("MASK_RATE", (0.5, 0.8))) if include_mask else None,
        mask_sample_mode=dp.get("MASK_SAMPLE_MODE", "exact"),
        first_image_only_quirk=dp.get("FIRST_IMAGE_ONLY_QUIRK", False),
        lambda_fine=loss.get("LAMBDA_FINE", 1.0),
        lambda_eikonal=loss.get("LAMBDA_EIKONAL", 0.1),
        lambda_mask=loss.get("LAMBDA_MASK", 0.0),
        lambda_relight=loss.get("LAMBDA_RELIGHT", 1.0),
        rgb_loss_type=loss.get("RGB_LOSS_TYPE", "mse"),
        iterations=t.get("ITERATIONS", 100000),
        lr=opt.get("LR", 5e-4),
        optimizer=opt.get("TYPE", "adam"),
        scheduler=opt.get("SCHEDULER_TYPE", "NEUS"),
        warm_up=opt.get("WARM_UP", 5000),
        lr_alpha=opt.get("LR_ALPHA", 0.05),
        gamma=opt.get("GAMMA", 0.1),
        decay_steps=opt.get("LRATE_DECAY", 250000),
        grad_clip_enabled=t.get("GRAD_CLIP_ENABLED", True),
        grad_clip_norm=float(t.get("GRAD_CLIP", {}).get("NORM", 1.0)),
        camera=CameraConfig(
            learn_focal=m.get("LEARN_FOCAL", False),
            learn_r=m.get("LEARN_R", False),
            learn_t=m.get("LEARN_T", False),
            fx_only=dp.get("FX_ONLY", False),
            focal_order=m.get("FOCAL_ORDER", 2),
            pose_mode=m.get("POSE_MODE", "6d"),
            H=H, W=W, n_cams=n_cams,
        ),
        renderer=renderer_config_from_cfg(m["RENDERER"]),
    )


# ---------------------------------------------------------------------------
# Learning rate, clipping, optimizer
# ---------------------------------------------------------------------------

def _div(x: torch.Tensor, d) -> torch.Tensor:
    """x / d, rounded as one f32 division on every device (CUDA divides by
    a Python scalar as a product with its reciprocal, an ulp off at times)."""
    return x / torch.full_like(x, d)


def _step_f32(step) -> torch.Tensor:
    """The step (an int or a 0-d tensor) as a 0-d f32 tensor on its device."""
    return torch.as_tensor(step).to(torch.float32)


def neus_lr_schedule(cfg: TrainerConfig):
    """Linear warm-up then cosine decay to lr*alpha (net_utils.py:56-78),
    in f32 from the step as the JAX package computes it: a 0-d f32 tensor
    on the step's device (no host read, so a captured step keeps it)."""
    def sched(step) -> torch.Tensor:
        step = _step_f32(step)
        warm = _div(step, max(cfg.warm_up, 1))
        progress = _div(step - cfg.warm_up, max(cfg.iterations - cfg.warm_up, 1))
        cos = ((torch.cos(math.pi * torch.clamp(progress, 0.0, 1.0)) + 1.0) * 0.5
               * (1 - cfg.lr_alpha) + cfg.lr_alpha)
        return cfg.lr * torch.where(step < cfg.warm_up, warm, cos)
    return sched


def nerf_lr_schedule(cfg: TrainerConfig):
    """Exponential decay lr * gamma^(step/decay_steps) (net_utils.py:40-53),
    in f32 on the step's device."""
    def sched(step) -> torch.Tensor:
        return cfg.lr * cfg.gamma ** _div(_step_f32(step), cfg.decay_steps)
    return sched


def lr_schedule(cfg: TrainerConfig):
    if cfg.scheduler.upper() == "NERF":
        return nerf_lr_schedule(cfg)
    return neus_lr_schedule(cfg)


@torch.no_grad()
def clip_per_leaf(params: nn.Module, max_norm: float) -> None:
    """Scale each parameter's gradient to L2 norm <= max_norm on its own —
    torch's clip_grad_norm_ applied leaf by leaf (net_utils.py:174-184),
    not one norm over all gradients. Stays on the device (no sync)."""
    for p in params.parameters():
        if p.grad is not None:
            n = torch.linalg.vector_norm(p.grad)
            p.grad.mul_(torch.clamp(max_norm / torch.clamp_min(n, 1e-6), max=1.0))


class DeviceSGD(torch.optim.Optimizer):
    """Plain SGD, p <- p - g * lr, as JAX's make_optimizer('sgd') updates
    (the gradient scaled by the schedule, then negated): the product and
    the subtraction as two foreach ops on the device, the lr a 0-d tensor
    read there. torch's SGD reads a tensor lr on the host, which a captured
    step cannot do. No state."""

    def __init__(self, params, lr: torch.Tensor):
        super().__init__(params, {"lr": lr})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if ps:
                torch._foreach_sub_(ps, torch._foreach_mul([p.grad for p in ps], group["lr"]))


def make_optimizer(cfg: TrainerConfig, params: nn.Module) -> torch.optim.Optimizer:
    """Optimizer families of build_optimizer_nerf (net_utils.py:81-106).
    The lr is a 0-d tensor on the parameters' device that every step
    overwrites from the schedule; on CUDA Adam and RMSprop are capturable
    (their step counts and bias corrections stay on the device), and SGD
    (DeviceSGD) reads its lr only there, so every family runs in a captured
    bundle."""
    dev = next(params.parameters()).device
    lr = torch.zeros((), dtype=torch.float32, device=dev)
    capturable = dev.type == "cuda"
    kind = cfg.optimizer.lower()
    if kind == "adam":
        return torch.optim.Adam(params.parameters(), lr=lr, betas=(0.9, 0.99), eps=1e-8,
                                capturable=capturable)
    if kind == "rmsprop":
        return torch.optim.RMSprop(params.parameters(), lr=lr, alpha=0.99, eps=1e-8,
                                   capturable=capturable)
    if kind == "sgd":
        return DeviceSGD(params.parameters(), lr)
    raise NotImplementedError(f"optimizer {cfg.optimizer}")


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

@dataclass
class TrainState:
    """params: nn.ModuleDict {renderer, focal, pose} with the JAX pytree's
    leaves; optimizer over all of them; step: optimisation steps taken, on
    the host; step_t: the same count as a 0-d int64 tensor on the
    parameters' device, which the step reads and increments there. The
    host never reads step_t back: it counts along (set_step sets both)."""
    params: nn.ModuleDict
    optimizer: torch.optim.Optimizer
    step: int = 0
    step_t: torch.Tensor | None = None

    def __post_init__(self):
        if self.step_t is None:
            dev = next(self.params.parameters()).device
            self.step_t = torch.tensor(self.step, dtype=torch.int64, device=dev)

    def set_step(self, step: int) -> None:
        self.step = step
        self.step_t.fill_(step)


def init_state(cfg: TrainerConfig, generator, device, init_focal_np=None) -> TrainState:
    params = nn.ModuleDict({
        "renderer": neus.init_renderer(cfg.renderer, generator, device),
        "focal": init_focal(cfg.camera, init_focal_np, device),
        "pose": init_pose(cfg.camera, device),
    })
    return TrainState(params, make_optimizer(cfg, params), 0)


def make_scene(origin, radius, init_c2w, device) -> dict:
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return {"origin": t(origin).reshape(3), "radius": t(radius).reshape(()),
            "init_c2w": t(init_c2w)}


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def compute_loss(cfg: TrainerConfig, render: dict):
    """NeuS_Trainer.compute_loss (129-171) semantics."""
    rgb_gt = render["rgb_map_gt"]
    if cfg.rgb_loss_type == "mse":
        rgb_fine_loss = torch.mean((render["color_fine"] - rgb_gt) ** 2)
    elif cfg.rgb_loss_type == "l1":
        rgb_fine_loss = torch.mean(torch.abs(render["color_fine"] - rgb_gt))
    else:
        raise ValueError(f"no such rgb loss type: {cfg.rgb_loss_type}")

    loss = cfg.lambda_fine * rgb_fine_loss
    eik = render["gradient_error"]
    loss = loss + cfg.lambda_eikonal * eik
    loss_dict = {"rgb_fine_loss": rgb_fine_loss, "eikonal_loss": eik}

    if cfg.lambda_mask != 0 and render.get("mask") is not None:
        ws = torch.clamp(render["weight_sum"].squeeze(-1), 1e-3, 1.0 - 1e-3)
        m = render["mask"]
        mask_loss = -torch.mean(m * torch.log(ws) + (1.0 - m) * torch.log(1.0 - ws))
        loss = loss + cfg.lambda_mask * mask_loss
        loss_dict["mask_loss"] = mask_loss

    if cfg.lambda_relight != 0 and "delta_relight" in render:
        delta = render["delta_relight"]
        if render.get("mask") is not None:
            delta = delta * render["mask"][:, None, None]
        relight_loss = torch.mean(delta) ** 2
        loss = loss + cfg.lambda_relight * relight_loss
        loss_dict["relight_loss"] = relight_loss
    elif cfg.lambda_relight != 0 and "delta_sum" in render:
        # per-ray sums: mean over the [R, S, 3] delta == sum(mask*dsum)/(R*S*3)
        dsum = render["delta_sum"]
        if render.get("mask") is not None:
            dsum = dsum * render["mask"]
        n_el = dsum.shape[0] * render["n_samples_total"] * 3
        relight_loss = (torch.sum(dsum) / n_el) ** 2
        loss = loss + cfg.lambda_relight * relight_loss
        loss_dict["relight_loss"] = relight_loss

    loss_dict["loss"] = loss
    return loss, loss_dict


# ---------------------------------------------------------------------------
# Pixels -> rays -> render
# ---------------------------------------------------------------------------

def _mask_rate_at(cfg: TrainerConfig, step) -> torch.Tensor:
    """The in-mask share at `step` (an int or a 0-d tensor), in f32 as the
    JAX package computes it: a 0-d tensor on the step's device."""
    m0, m1 = cfg.mask_rate
    return m0 + _div((m1 - m0) * _step_f32(step), cfg.iterations)


def sample_pixels(cfg: TrainerConfig, images, masks, step, generator):
    """(cam_sel, py, px, sel_mask) for one step (an int or the state's
    device counter); sel_mask is None without masks. cam_sel indexes the
    image batch."""
    B, H, W = images.shape[:3]
    if cfg.include_mask and masks is not None:
        sampler = (sample_pixels_masked_exact if cfg.mask_sample_mode == "exact"
                   else sample_pixels_masked)
        return sampler(generator, masks, cfg.n_rays, _mask_rate_at(cfg, step))
    cam_sel, py, px = sample_pixels_uniform(
        generator, B, H, W, cfg.n_rays, first_image_only=cfg.first_image_only_quirk,
        device=images.device)
    return cam_sel, py, px, None


def pixel_rays(params, scene, cfg: TrainerConfig, images, img_ids, cam_sel, py, px):
    """(rays_o, rays_d, near, far) of the given pixels of the image batch,
    in the scene's unit-sphere frame (NeuS_Trainer.render 103-127 with
    on-device ray generation)."""
    H, W = images.shape[1:3]
    focal = focal_apply(params["focal"], cfg.camera)
    c2w = pose_apply(params["pose"], cfg.camera, scene["init_c2w"], img_ids)  # [B,4,4]
    rays_o, rays_d = rays_for_pixels(c2w[cam_sel], focal, px, py, H, W,
                                     normalize=cfg.normalize_dir, opengl=cfg.opengl)
    rays_o = (rays_o - scene["origin"]) / scene["radius"]
    near, far = near_far_from_sphere(rays_o, rays_d)
    return rays_o, rays_d, near, far


def render_pixels(params, scene, cfg: TrainerConfig, images, img_ids,
                  cam_sel, py, px, sel_mask, generator):
    """Render the given pixels of the image batch. With cfg.mesh the
    pixels are the global batch: this rank renders its shard of them
    (JAX's constrain_rays) and the returned dict holds the global batch's
    outputs, ground truth and mask."""
    rgb_gt = images[cam_sel, py, px]
    mesh = cfg.mesh
    if mesh is not None:
        cam_sel, py, px = (ray_shard(x, mesh.rank, mesh.world) for x in (cam_sel, py, px))
    rays_o, rays_d, near, far = pixel_rays(params, scene, cfg, images, img_ids,
                                           cam_sel, py, px)
    render = neus.render_rays_train(params["renderer"], cfg.renderer, rays_o, rays_d,
                                    near, far, generator=generator, mesh=mesh)
    render["rgb_map_gt"] = rgb_gt
    render["mask"] = sel_mask
    return render


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def apply_gradients(state: TrainState, cfg: TrainerConfig) -> torch.Tensor:
    """The update of make_optimizer's chain on the parameters' .grad: with
    cfg.mesh the sum across ranks (parallel.allreduce_grads), the per-leaf
    clip, the lr of the schedule at the device step, the optimizer's step;
    advances the step. Returns the lr (0-d, no sync)."""
    if cfg.mesh is not None:
        allreduce_grads(state.params)
    if cfg.grad_clip_enabled:
        clip_per_leaf(state.params, cfg.grad_clip_norm)
    lr = lr_schedule(cfg)(state.step_t)
    for group in state.optimizer.param_groups:
        group["lr"].copy_(lr)
    state.optimizer.step()
    state.step_t.add_(1)
    state.step += 1
    return lr


def train_step_pixels(state: TrainState, scene, cfg: TrainerConfig, images, img_ids,
                      cam_sel, py, px, sel_mask, generator) -> dict:
    """One optimisation step on the given pixels; updates `state` in place
    and returns the step's metrics as 0-d tensors (no host sync)."""
    state.optimizer.zero_grad(set_to_none=True)
    render = render_pixels(state.params, scene, cfg, images, img_ids, cam_sel, py, px,
                           sel_mask, generator)
    loss, loss_dict = compute_loss(cfg, render)
    loss.backward()
    lr = apply_gradients(state, cfg)

    aux = {k: v.detach() for k, v in loss_dict.items()}
    aux["s_val"] = torch.mean(render["s_val"]).detach()
    aux["psnr"] = -10.0 * torch.log10(torch.clamp_min(aux["rgb_fine_loss"], 1e-10))
    aux["lr"] = lr
    return aux


def train_step(state: TrainState, scene, cfg: TrainerConfig, images, masks, img_ids,
               generator) -> dict:
    """One optimisation step on freshly sampled pixels of the image batch."""
    cam_sel, py, px, sel_mask = sample_pixels(cfg, images, masks, state.step_t, generator)
    return train_step_pixels(state, scene, cfg, images, img_ids, cam_sel, py, px,
                             sel_mask, generator)


def full_data_step(state: TrainState, scene, cfg: TrainerConfig, images, masks,
                   batch_size: int, generator) -> dict:
    """One step over the device-resident dataset: the image batch is a
    randperm prefix (dtu.py:164-168 semantics), drawn on the device."""
    n_imgs = images.shape[0]
    b = min(batch_size, n_imgs)
    img_ids = torch.randperm(n_imgs, generator=generator, device=images.device)[:b]
    masks_b = masks[img_ids] if masks is not None else None
    return train_step(state, scene, cfg, images[img_ids], masks_b, img_ids, generator)


def _captured_tensors(state: TrainState, scene, images, masks) -> list:
    """Every tensor a captured bundle reads or writes in place whose
    storage outlives it: the parameters, the optimizer's state and lr, the
    step counter, the scene and the dataset."""
    opt = state.optimizer
    out = list(state.params.parameters()) + [state.step_t, images, *scene.values()]
    out += [v for st in opt.state.values() for v in st.values() if torch.is_tensor(v)]
    out += [g["lr"] for g in opt.param_groups if torch.is_tensor(g["lr"])]
    return out + ([masks] if masks is not None else [])


class MultiStep:
    """k_steps full-data steps per call (make_train_multi_step):
    multi(state, scene, images, masks, generator) -> (state, aux of the
    last step with "loss_mean" over the bundle, the bundle's losses [k]).

    On the CPU a call is a loop of k_steps steps, and so is every call in
    a data-parallel run whose group cannot be captured (gloo: its
    collectives go through the host), decided here from the backend and
    logged once. Otherwise, on CUDA the first call
    runs a warm-up bundle of real steps on a side stream (it builds the
    kernels, fills their caches and creates the optimizer's state), then
    captures k_steps steps into one torch.cuda.CUDAGraph with the
    generator registered; every later call replays the graph once. The
    graph holds the storage of the tensors it was captured on: a call on
    other storage (a checkpoint load replaces the optimizer's state; another
    state or dataset) drops it and captures anew after a warm-up bundle. In
    a data-parallel run on NCCL the gathers and the gradients' all-reduce
    are captured with the steps. A capture that fails raises; there is no
    uncaptured path on CUDA besides the warm-up bundle and gloo's.
    `captured` holds the kernel launches (the wrappers' counts) one replay
    makes; `recorded` and `replayed` add up those of every capture and
    every replay, `replays` counts replays."""

    def __init__(self, cfg: TrainerConfig, n_imgs: int, batch_size: int, k_steps: int):
        if k_steps < 1:
            raise ValueError(f"k_steps must be >= 1, got {k_steps}")
        self.cfg, self.batch_size, self.k_steps = cfg, min(batch_size, n_imgs), k_steps
        self.capture = cfg.mesh is None or cfg.mesh.capturable
        if not self.capture:
            logger.info("bundles of %d steps run uncaptured: the %s group's collectives "
                        "cannot be captured in a CUDA graph", k_steps, cfg.mesh.backend)
        self.graph = None
        self._out = self._bound = None
        self.captured, self.recorded, self.replayed = Counter(), Counter(), Counter()
        self.replays = 0

    def steps(self, state, scene, images, masks, generator):
        """k_steps uncaptured steps: (aux of the last + loss_mean, losses [k])."""
        auxs = [full_data_step(state, scene, self.cfg, images, masks, self.batch_size,
                               generator) for _ in range(self.k_steps)]
        losses = torch.stack([a["loss"] for a in auxs])
        return dict(auxs[-1], loss_mean=torch.mean(losses)), losses

    def __call__(self, state: TrainState, scene, images, masks, generator):
        if images.device.type != "cuda" or not self.capture:
            return (state, *self.steps(state, scene, images, masks, generator))
        bound = [generator] + [t.data_ptr() for t in _captured_tensors(state, scene, images,
                                                                          masks)]
        if self.graph is None or bound != self._bound:
            return (state, *self._capture(state, scene, images, masks, generator))
        self.graph.replay()
        state.step += self.k_steps
        self.replays += 1
        self.replayed.update(self.captured)
        aux, losses = self._out
        return state, {k: v.clone() for k, v in aux.items()}, losses.clone()

    def _capture(self, state, scene, images, masks, generator):
        from color_neus_torch.ops.kernels import launch_counts
        self.graph = self._out = None            # a stale graph's pool goes first
        dev = images.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            out = self.steps(state, scene, images, masks, generator)
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        step, before = state.step, launch_counts()
        try:
            with torch.cuda.graph(graph, stream=stream):
                outs = self.steps(state, scene, images, masks, generator)
        except Exception as e:
            raise RuntimeError(f"capturing a bundle of {self.k_steps} training steps "
                               f"failed: {e}") from e
        finally:
            state.step = step                    # capture records the steps, runs none
        after = launch_counts()
        self.captured = Counter({k: after[k] - before[k] for k in after
                                 if after[k] > before[k]})
        self.recorded.update(self.captured)
        self.graph, self._out = graph, outs
        self._bound = [generator] + [t.data_ptr() for t in _captured_tensors(
            state, scene, images, masks)]
        return out


def make_train_multi_step(cfg: TrainerConfig, n_imgs: int, batch_size: int,
                          k_steps: int) -> MultiStep:
    """K optimisation steps per dispatch (the JAX package's lax.scan
    bundle, trainer.py:377-395): on CUDA one replay of a captured graph."""
    return MultiStep(cfg, n_imgs, batch_size, k_steps)


# ---------------------------------------------------------------------------
# Full-image rendering (validation / testing)
# ---------------------------------------------------------------------------

@torch.no_grad()
def render_image(params, scene, cfg: TrainerConfig, cam_id: int, H: int, W: int, generator):
    """Render camera `cam_id` whole, in chunks of EVAL_RAY_SIZE rays on the
    device (trainer.py:420-447; NeuS_Trainer.validate_image capability).
    The sample perturbation draws from `generator`. Returns (rgb [H,W,3],
    depth [H,W]) as numpy arrays."""
    dev = scene["init_c2w"].device
    focal = focal_apply(params["focal"], cfg.camera)
    c2w = pose_apply(params["pose"], cfg.camera, scene["init_c2w"],
                     torch.tensor([cam_id], device=dev))[0]
    rays_o, rays_d = all_rays_for_camera(c2w, focal, H, W, normalize=cfg.normalize_dir,
                                         opengl=cfg.opengl)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    rgb, depth = [], []
    for i in range(0, rays_o.shape[0], cfg.eval_ray_size):
        ro = (rays_o[i:i + cfg.eval_ray_size] - scene["origin"]) / scene["radius"]
        rd = rays_d[i:i + cfg.eval_ray_size]
        near, far = near_far_from_sphere(ro, rd)
        out = neus.render_rays(params["renderer"], cfg.renderer, ro, rd, near, far,
                               generator=generator)
        rgb.append(out["color_fine"])
        depth.append(out["depth"])
    return (torch.cat(rgb).reshape(H, W, 3).cpu().numpy(),
            torch.cat(depth).reshape(H, W).cpu().numpy())

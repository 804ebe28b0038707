"""Train / eval loop: port of color_neus_tpu/runtime.py.

Builds the dataset, moves the whole image and mask stacks to the device
once, initialises the state from TRAIN.MANUAL_SEED (or loads
MODEL.PRETRAINED, the --reload checkpoint, or resumes an experiment
directory's checkpoint with its generator), and runs full-data steps
(image batch and pixels drawn on the device), logging loss, psnr and lr
every LOG_INTERVAL steps.

Steps run in bundles of k_steps = LOG_INTERVAL when the save, image and
mesh intervals and ITERATIONS are all multiples of it (the JAX package's
rule, bundle_steps), else one by one: on CUDA a bundle is one replay of a
captured CUDA graph (trainer.make_train_multi_step), on the CPU a loop.
Everything below happens at bundle boundaries.

Given an experiment id or a directory to resume (as the CLIs give them),
the loop also records: the per-step scalars at every log step, a
checkpoint every SAVE_INTERVAL steps, at the end and where it stops, a
validation image every VIZ_IMAGE_INTERVAL steps, a mesh every
VIZ_MESH_INTERVAL steps (runtime.py:199-206), and the camera plots every
50 log steps while poses are learnt. Without either it writes nothing.

Given a mesh (parallel.make_mesh after parallel.init: one process a card
under torchrun), the loop is one rank of a data-parallel run: the ray
batch is sharded over the ranks (parallel.with_mesh; JAX shards as soon
as it sees more than one device). Every rank holds the dataset and a
replica of the state, seeded alike, and resumes from the same checkpoint.
Rank 0 picks the experiment directory and broadcasts it, and alone writes
checkpoints, snapshots, scalars, images, meshes and the log; a barrier
follows each checkpoint, and the other ranks wait at one while rank 0
renders a validation image or extracts a mesh. The stop flag (stop_after,
SIGTERM / SIGINT) is agreed across ranks at every boundary, so ranks that
see a signal at different bundles stop at the same step.
"""

from __future__ import annotations

import importlib.util
import os
import signal
import time

import numpy as np
import torch

from color_neus_torch import parallel, pin_precision, resolve_device
from color_neus_torch.data.base import create_dataset
from color_neus_torch.data.image_io import write_png
from color_neus_torch.models import trainer as TR
from color_neus_torch.models.camera import pose_apply
from color_neus_torch.ops import mesh as mesh_ops
from color_neus_torch.utils.checkpoint import load_checkpoint
from color_neus_torch.utils.logger import logger
from color_neus_torch.utils.metrics import PSNR, SSIM, LossMetric
from color_neus_torch.utils.misc import format_cfg
from color_neus_torch.utils.recorder import Recorder, ScalarWriter, require_clean_tree


def depth_colormap(depth: np.ndarray) -> np.ndarray:
    """HOT-style colormap for depth viz (viztools.py:158-162 capability)."""
    d = depth - depth.min()
    d = d / max(float(d.max()), 1e-8)
    r = np.clip(3 * d, 0, 1)
    g = np.clip(3 * d - 1, 0, 1)
    b = np.clip(3 * d - 2, 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def bundle_steps(train_cfg) -> int:
    """Steps per dispatch (color_neus_tpu/runtime.py:104-109): LOG_INTERVAL
    when SAVE_INTERVAL, VIZ_IMAGE_INTERVAL, VIZ_MESH_INTERVAL and ITERATIONS
    are all multiples of it, so no event falls inside a bundle; else 1."""
    log_int = max(train_cfg.get("LOG_INTERVAL", 10), 1)
    intervals = [train_cfg.get(k, 10000) for k in ("SAVE_INTERVAL", "VIZ_IMAGE_INTERVAL",
                                                   "VIZ_MESH_INTERVAL")]
    intervals.append(train_cfg.get("ITERATIONS", 100000))
    return log_int if all(i % log_int == 0 for i in intervals) else 1


class TrainLoop:
    def __init__(self, cfg, device=None, exp_id: str | None = None, resume: str | None = None,
                 snapshot: int = 50, require_clean_git: bool = True, mesh=None):
        pin_precision()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rank0 = mesh is None or mesh.rank == 0
        self.seed = cfg["TRAIN"].get("MANUAL_SEED", 1)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

        self.dataset = create_dataset(cfg["DATASET"], cfg.get("DATA_PRESET", {}))
        init = self.dataset.init_data()
        self.H, self.W, self.n_imgs = init["H"], init["W"], init["n_imgs"]
        self.scale_mats = init["scale_mats_np"]
        self.bbox_min, self.bbox_max = init["object_bbox_min"], init["object_bbox_max"]

        self.tcfg = parallel.with_mesh(
            TR.trainer_config_from_cfg(cfg, self.H, self.W, self.n_imgs), mesh)
        self.state = TR.init_state(self.tcfg, self.generator, self.device,
                                   init_focal_np=init["focal"])
        self.scene = TR.make_scene(init["origin"], init["radius"], init["poses"], self.device)

        all_data = self.dataset.load_all()
        self.images = torch.as_tensor(all_data["images"], device=self.device)
        self.masks = (torch.as_tensor(all_data["masks"], device=self.device)
                      if all_data["masks"] is not None else None)
        self.batch_size = cfg["TRAIN"]["BATCH_SIZE"]
        self.k_steps = bundle_steps(cfg["TRAIN"])
        self.multi_step = (TR.make_train_multi_step(self.tcfg, self.n_imgs, self.batch_size,
                                                    self.k_steps)
                           if self.k_steps > 1 else None)
        logger.info("config:%s", format_cfg(cfg.to_dict() if hasattr(cfg, "to_dict") else cfg))

        # recording: every rank runs the recording boundaries (their
        # barriers); rank 0 alone holds the recorder and writes
        self.recording = exp_id is not None or resume is not None
        self.recorder, self.writer, self.exp_path = None, None, None
        if self.recording:
            exp_id = exp_id or "default"
            require_clean_tree(exp_id, require_clean_git)   # every rank, before any collective
            if self.rank0:
                self.recorder = Recorder(exp_id, cfg, resume_path=resume, snapshot=snapshot,
                                         require_clean_git=False)
                self.writer = ScalarWriter(os.path.join(self.recorder.exp_path, "tensorboard"))
                self.exp_path = self.recorder.exp_path
            if mesh is not None:
                self.exp_path = parallel.broadcast_object(self.exp_path)
        cam = self.tcfg.camera
        self.pose_plots = (self.writer is not None and (cam.learn_r or cam.learn_t)
                           and self.writer.has_image_sink
                           and importlib.util.find_spec("matplotlib") is not None)
        if self.writer is not None and (cam.learn_r or cam.learn_t) and not self.pose_plots:
            logger.info("camera pose plots skipped: they need tensorboardX (the image sink) "
                        "and matplotlib")
        self.loss_metric = LossMetric()
        self.psnr_metric = PSNR()
        self.ssim_metric = SSIM()
        self.last_mesh_stats: dict = {}

        pretrained = cfg["MODEL"].get("PRETRAINED")
        if pretrained:
            load_checkpoint(pretrained, self.state)
            logger.info("loaded pretrained state (step %d) from %s", self.state.step, pretrained)
        if resume:
            load_checkpoint(Recorder.checkpoint_file(resume), self.state, self.generator)
            logger.info("resumed at step %d from %s", self.state.step, resume)

    def training_step(self) -> dict:
        return TR.full_data_step(self.state, self.scene, self.tcfg, self.images, self.masks,
                                 self.batch_size, self.generator)

    def training_bundle(self):
        """k_steps steps in one dispatch: (aux of the last step with
        loss_mean, the bundle's losses [k])."""
        _, aux, losses = self.multi_step(self.state, self.scene, self.images, self.masks,
                                         self.generator)
        return aux, losses

    def run(self, iterations: int | None = None, stop_after: int | None = None,
            profile_dir: str | None = None) -> torch.Tensor:
        """Train to `iterations` (default TRAIN.ITERATIONS) steps in total;
        returns the loss of every step run here, on the host.

        A step count that is a multiple of k_steps starts a bundle when the
        whole bundle fits below `iterations`; other steps run one by one.
        stop_after stops at the first boundary at or past that step, with a
        checkpoint. SIGTERM and SIGINT stop at the next boundary, with a
        checkpoint, and return (the reference's recovery model: rerun with
        --resume, train.py:54-55); the previous handlers are back when run
        returns or raises. profile_dir receives a torch.profiler trace of the
        first two bundles (trace.json)."""
        interrupted = []

        def on_signal(signum, frame):
            interrupted.append(signum)
            logger.warning("signal %d: will checkpoint and stop at the next bundle boundary",
                           signum)

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, on_signal)
            except ValueError:  # not the main thread: no handler, run to the end
                pass
        try:
            return self._run(iterations, stop_after, profile_dir, interrupted)
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)
            if self.writer is not None:
                self.writer.close()

    def _run(self, iterations, stop_after, profile_dir, interrupted) -> torch.Tensor:
        t = self.cfg["TRAIN"]
        iterations = t["ITERATIONS"] if iterations is None else iterations
        log_int = max(t.get("LOG_INTERVAL", 10), 1)
        save_int = t.get("SAVE_INTERVAL", 10000)
        viz_img_int = t.get("VIZ_IMAGE_INTERVAL", 10000)
        viz_mesh_int = t.get("VIZ_MESH_INTERVAL", 10000)
        k = self.k_steps
        start = self.state.step
        logger.info("training on %s: steps %d..%d (%d steps/dispatch)%s", self.device, start,
                    iterations, k, "" if self.mesh is None else
                    f", rays sharded over {self.mesh.world} ranks ({self.mesh.backend})")
        prof = None
        if profile_dir:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU] + (
                [torch.profiler.ProfilerActivity.CUDA] if self.device.type == "cuda" else []))
            prof.start()
        losses = []
        t0 = time.perf_counter()
        try:
            while self.state.step < iterations:
                step = self.state.step
                if k > 1 and step % k == 0 and step + k <= iterations:
                    aux, bundle = self.training_bundle()
                    losses.append(bundle)
                else:
                    aux = self.training_step()
                    losses.append(aux["loss"][None])
                step = self.state.step
                if prof is not None and (step - start >= 2 * k or step >= iterations):
                    prof.stop()
                    os.makedirs(profile_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
                    logger.info("profile trace of %d steps written to %s", step - start,
                                profile_dir)
                    prof = None
                if step % log_int == 0 or step >= iterations:
                    self.log_step(step, aux, (step - start) * self.tcfg.n_rays
                                  / max(time.perf_counter() - t0, 1e-9))
                if self.recording:
                    self.record_step(step, iterations, log_int, save_int, viz_img_int,
                                     viz_mesh_int)
                stop = (stop_after is not None and step >= stop_after) or bool(interrupted)
                if self.mesh is not None:
                    stop = parallel.any_rank(stop)
                if stop:
                    if self.recording:
                        self.save_checkpoint()
                    logger.info("stopped early at step %d%s", step,
                                " (checkpointed)" if self.recording else "")
                    break
        finally:
            if prof is not None:
                prof.stop()
        logger.info("training done.")
        return torch.cat(losses).cpu() if losses else torch.zeros(0)

    def log_step(self, step: int, aux: dict, rays_per_s: float) -> None:
        """The log line and, when recording, the scalars of one log step."""
        aux_np = {k: float(v) for k, v in aux.items()}
        logger.info("step %d | loss %.5f | psnr %.2f | lr %.3g | %.0f rays/s", step,
                    aux_np["loss"], aux_np["psnr"], aux_np["lr"], rays_per_s)
        if self.recorder is None:
            return
        self.loss_metric.feed(aux_np)
        for k, v in aux_np.items():
            self.writer.add_scalar(k, v, step)
        self.writer.flush()

    def record_step(self, step, iterations, log_int, save_int, viz_img_int, viz_mesh_int):
        """What the recorder writes after `step` (runtime.py:186-206)."""
        # camera-pose plots while poses are refined (NeuS_Trainer.py:202-207
        # cadence: every 50 log intervals)
        if self.pose_plots and step % (log_int * 50) == 0:
            self.plot_poses(step)
        if step % save_int == 0 or step >= iterations:
            self.save_checkpoint()
            if self.recorder is not None:
                self.on_train_finished(step)
        if step % viz_img_int == 0 and step < iterations:
            self.on_rank0(self.validation_step, step)
        if step % viz_mesh_int == 0 and step < iterations:
            self.on_rank0(self.validate_mesh, step, resolution=512)

    def save_checkpoint(self) -> None:
        """Rank 0 records the checkpoint; in a data-parallel run every rank
        then meets at a barrier, so a resume finds the whole file."""
        if self.recorder is not None:
            self.recorder.record_checkpoint(self.state, self.generator)
        if self.mesh is not None:
            parallel.barrier()

    def on_rank0(self, fn, *args, **kw) -> None:
        """fn on rank 0 alone; the other ranks wait for it at a barrier."""
        if self.rank0:
            fn(*args, **kw)
        if self.mesh is not None:
            parallel.barrier()

    def plot_poses(self, step: int) -> None:
        from color_neus_torch.utils.viztools import plot_camera_scene, plot_cameras_track
        with torch.no_grad():
            c2ws = pose_apply(self.state.params["pose"], self.tcfg.camera,
                              self.scene["init_c2w"],
                              torch.arange(self.n_imgs, device=self.device)).cpu().numpy()
        self.writer.add_image("poses", plot_camera_scene(
            c2ws, float(self.scene["radius"]), f"step_{step}"), step)
        self.writer.add_image("poses_track", plot_cameras_track(c2ws), step)

    # ------------------------------------------------------------------
    # Trainer lifecycle (the reference's model_abstraction.py:4-37 names)
    # ------------------------------------------------------------------
    def compute_loss(self, aux: dict) -> float:
        """Scalar loss of a step's aux (the step assembles it:
        models/trainer.compute_loss, NeuS_Trainer.py:129-171)."""
        return float(aux["loss"])

    def on_train_finished(self, step: int) -> None:
        self.recorder.record_loss(self.loss_metric, step, comment="train-")
        self.loss_metric.reset()

    def validation_step(self, step: int) -> None:
        self.validate_image(step)

    def on_val_finished(self, step: int) -> None:
        if self.recorder is not None:
            self.recorder.record_metric([self.psnr_metric, self.ssim_metric], step,
                                        comment="val-")
        logger.info("val @%d: %s %s", step, self.psnr_metric, self.ssim_metric)
        self.psnr_metric.reset()
        self.ssim_metric.reset()

    def testing_step(self, step: int, recon_res: int = 512):
        """Mesh extraction entry (NeuS_Trainer.testing_step:321-322)."""
        return self.validate_mesh(step, resolution=recon_res)

    # ------------------------------------------------------------------
    def validate_image(self, step: int):
        """Render one view picked by a generator seeded from the seed and
        the step, dump the [GT | render | depth] strip and feed PSNR / SSIM
        (NeuS_Trainer.validate_image 216-277). Returns (cam_id, rgb, depth)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed * 1_000_003 + 0xA11D + step)
        cam_id = int(torch.randint(0, self.n_imgs, (1,), generator=g, device=self.device))
        rgb, depth = TR.render_image(self.state.params, self.scene, self.tcfg, cam_id,
                                     self.H, self.W, g)
        gt = self.images[cam_id].cpu().numpy()
        if self.recorder is not None:
            strip = np.hstack([(gt * 255).astype(np.uint8),
                               (np.clip(rgb, 0, 1) * 255).astype(np.uint8),
                               depth_colormap(depth)])
            write_png(os.path.join(self.recorder.viz_image_dir, f"img_{step}.png"), strip)
        self.psnr_metric.feed(rgb, gt)
        self.ssim_metric.feed(rgb, gt)
        self.on_val_finished(step)
        return cam_id, rgb, depth

    def validate_mesh(self, step: int, resolution: int = 64, threshold: float = 0.0,
                      world_space: bool = True):
        """Extract the mesh and its vertex colours; write *_mesh.ply and
        *_color.ply when recording (NeuS_Trainer.validate_mesh 279-307).
        The extraction's timings land in self.last_mesh_stats."""
        params = self.state.params["renderer"]
        stats = {}
        t0 = time.perf_counter()
        verts, tris = mesh_ops.extract_geometry(params, self.tcfg.renderer, self.bbox_min,
                                                self.bbox_max, resolution, threshold,
                                                stats=stats)
        logger.info("mesh @%d: %d verts, %d tris", step, len(verts), len(tris))
        stats.update(n_verts=len(verts), n_tris=len(tris))
        self.last_mesh_stats = stats
        if len(verts) == 0:
            stats["total_s"] = time.perf_counter() - t0
            return None
        t1 = time.perf_counter()
        colors = mesh_ops.extract_vertex_colors(params, self.tcfg.renderer, verts)
        stats["colors_s"] = time.perf_counter() - t1
        verts_out = verts
        if world_space:
            verts_out = verts * self.scale_mats[0][0, 0] + self.scale_mats[0][:3, 3][None]
        if self.recorder is not None:
            mesh_ops.write_ply(os.path.join(self.recorder.mesh_dir, f"{step:08d}_mesh.ply"),
                               verts_out, tris)
            mesh_ops.write_ply(os.path.join(self.recorder.mesh_dir, f"{step:08d}_color.ply"),
                               verts_out, tris, colors)
        stats["total_s"] = time.perf_counter() - t0
        return verts_out, tris, colors

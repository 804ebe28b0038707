"""One NeuS / Color-NeuS training step in plain PyTorch f32 (TF32 off):
the reference that a training cell's first steps are held to.

A step (reference NeuS_Trainer.py and lib/utils/net_utils.py semantics):
a random batch of `batch_size` images; `n_rays` pixels of it, the
in-mask share int(rate * n_rays) of them drawn without replacement from
the mask and the rest from the background (Gumbel top-k: a uniform key a
pixel); rays through the pixels' centres-less coordinates, normalised,
into the unit sphere; near / far where the ray meets the sphere; the
coarse samples jittered by one uniform a ray; four up-sample rounds at
inv_s = 64 * 2^i from a deterministic inverse cdf, the last merging z
only; the render core on the section mid-points; the loss (colour MSE,
eikonal over |p| < 1.2, mask BCE, the relight residual's squared mean);
each leaf's gradient clipped to norm 1 on its own; Adam (0.9, 0.99, 1e-8)
at the warm-up / cosine rate of the step count before the step.

The random numbers are drawn from a generator seeded as the program's,
in the order and shapes that the step's definition draws them: the image
batch (randperm), the two pixel keys, the jitter.

The core runs in blocks of rays: a first pass gives every ray's partials
(colour, weight sum, residual sum, eikonal numerator and denominator)
without a graph kept, the loss and its gradient by those partials follow,
and a second pass backpropagates block by block, so the memory is that of
one block at any batch size.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import nets


def pin_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def lr_at(t: dict, step: int) -> float:
    """NEUS schedule: linear warm-up, then cosine to lr * alpha."""
    o = t["OPTIMIZE"]
    lr, warm, it, alpha = o["LR"], o["WARM_UP"], t["ITERATIONS"], o["LR_ALPHA"]
    if step < warm:
        return lr * step / max(warm, 1)
    prog = min(max((step - warm) / max(it - warm, 1), 0.0), 1.0)
    return lr * ((math.cos(math.pi * prog) + 1.0) * 0.5 * (1 - alpha) + alpha)


def mask_share(m: dict, t: dict, step: int, device) -> torch.Tensor:
    """The in-mask share at `step`, in f32 (rate0 + (rate1 - rate0) step / iterations)."""
    r0, r1 = m["MASK_RATE"]
    s = torch.tensor(float(step), dtype=torch.float32, device=device)
    return r0 + (r1 - r0) * s / torch.full_like(s, t["ITERATIONS"])


def draw_pixels(g, masks_b, n_rays: int, share: torch.Tensor):
    """(flat pixel index [R], in-mask flag [R]) of one step's batch."""
    flat = masks_b.reshape(-1) > 0.5
    key_in = torch.rand(flat.shape, generator=g, device=flat.device)
    key_out = torch.rand(flat.shape, generator=g, device=flat.device)
    cand_in = torch.topk(key_in.masked_fill(~flat, float("-inf")), n_rays).indices
    cand_out = torch.topk(key_out.masked_fill(flat, float("-inf")), n_rays).indices
    m_in = int(flat.sum())
    n_in = int((share * n_rays).to(torch.int64))
    n_in = max(min(n_in, m_in, n_rays), n_rays - min(flat.numel() - m_in, n_rays))
    idx = torch.cat([cand_in[:n_in], cand_out[:n_rays - n_in]])
    return idx, flat[idx].to(torch.float32)


def pixel_rays(c2w, fx, fy, py, px, H: int, W: int):
    """(rays_o, rays_d, near, far) in the unit sphere (origin 0, radius 1)."""
    d = torch.stack([(px.float() - 0.5 * W) / fx, (py.float() - 0.5 * H) / fy,
                     torch.ones_like(px, dtype=torch.float32)], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    rays_d = torch.sum(c2w[:, :3, :3] * d[:, None, :], dim=-1)
    rays_o = c2w[:, :3, 3]
    a = torch.sum(rays_d ** 2, dim=-1)
    b = 2.0 * torch.sum(rays_o * rays_d, dim=-1)
    mid = -0.5 * b / a
    return rays_o, rays_d, mid - 1.0, mid + 1.0


def sample_pdf(bins, weights, n: int):
    """Deterministic inverse-cdf samples (u at the n bins' centres)."""
    w = weights + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    u = torch.linspace(0.5 / n, 1 - 0.5 / n, n, device=bins.device)
    u = u.expand(bins.shape[0], n).contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    cdf_b, cdf_a = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    bins_b, bins_a = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


def exclusive_weights(alpha):
    t = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], -1), -1)
    return alpha * t[:, :-1]


def up_sample(rays_o, rays_d, z, sdf, n: int, inv_s: float):
    pts = rays_o[:, None] + rays_d[:, None] * z[..., None]
    radius = torch.linalg.norm(pts, dim=-1)
    inside = (radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)
    mid_sdf = (sdf[:, :-1] + sdf[:, 1:]) * 0.5
    cos = (sdf[:, 1:] - sdf[:, :-1]) / (z[:, 1:] - z[:, :-1] + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos[:, :1]), cos[:, :-1]], -1)
    cos = torch.minimum(prev_cos, cos).clamp(-1e3, 0.0) * inside
    dist = z[:, 1:] - z[:, :-1]
    prev_cdf = torch.sigmoid((mid_sdf - cos * dist * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid_sdf + cos * dist * 0.5) * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    return sample_pdf(z, exclusive_weights(alpha), n)


@torch.no_grad()
def hierarchy(leaves, r, rays_o, rays_d, z, quant=None):
    """z [R, n_samples] (jittered) -> z [R, n_samples + n_importance]."""
    def sdf_of(zz):
        pts = (rays_o[:, None] + rays_d[:, None] * zz[..., None]).reshape(-1, 3)
        return nets.sdf_net(leaves, r, pts, quant)[:, 0].reshape(zz.shape)

    steps = r["UP_SAMPLE_STEPS"]
    per = r["N_IMPORTANCE"] // steps
    sdf = sdf_of(z)
    for i in range(steps):
        new_z = up_sample(rays_o, rays_d, z, sdf, per, 64 * 2 ** i)
        z, order = torch.sort(torch.cat([z, new_z], -1), dim=-1, stable=True)
        if i + 1 < steps:
            sdf = torch.gather(torch.cat([sdf, sdf_of(new_z)], -1), 1, order)
    return z


def core_partials(leaves, r, rays_o, rays_d, z, quant=None):
    """[R, 7] per ray: colour (3), weight sum, residual sum over samples
    and channels (0 for NeuS), eikonal numerator and denominator."""
    R, S = z.shape
    dists = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.full_like(z[:, :1], 2.0 / r["N_SAMPLES"])], -1)
    mid = z + dists * 0.5
    pts = (rays_o[:, None] + rays_d[:, None] * mid[..., None]).reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(R, S, 3).reshape(-1, 3)
    sdf, feat, grad = nets.sdf_with_grad(leaves, r, pts, quant)
    color = nets.color_net(leaves, r, pts, grad, dirs, feat, quant)
    delta_sum = torch.zeros(R, device=z.device)
    if r["TYPE"] == "Color_NeuS":
        color, delta = nets.relight_net(leaves, r, color, pts, dirs, grad, quant)
        delta_sum = delta.reshape(R, -1).sum(-1)
    inv_s = torch.exp(leaves["renderer.variance.variance"] * 10.0)
    true_cos = torch.sum(dirs * grad, -1, keepdim=True)
    iter_cos = -F.relu(-true_cos * 0.5 + 0.5)
    half = iter_cos * dists.reshape(-1, 1) * 0.5
    prev_cdf = torch.sigmoid((sdf - half) * inv_s)
    next_cdf = torch.sigmoid((sdf + half) * inv_s)
    alpha = ((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).reshape(R, S).clamp(0.0, 1.0)
    w = exclusive_weights(alpha)
    rgb = torch.sum(color.reshape(R, S, 3) * w[..., None], 1)
    relax = (torch.linalg.norm(pts, dim=-1).reshape(R, S) < 1.2).float()
    err = (torch.linalg.norm(grad, dim=-1).reshape(R, S) - 1.0) ** 2
    return torch.cat([rgb, w.sum(-1, keepdim=True), delta_sum[:, None],
                      (relax * err).sum(-1, keepdim=True), relax.sum(-1, keepdim=True)], -1)


def loss_of(m: dict, r: dict, parts, gt, mask, n_total: int):
    """The loss of a batch's partials [R, 7] (NeuS_Trainer.compute_loss)."""
    l = m["LOSS"]
    rgb = torch.mean((parts[:, :3] - gt) ** 2)
    eik = parts[:, 5].sum() / (parts[:, 6].sum() + 1e-5)
    loss = l.get("LAMBDA_FINE", 1.0) * rgb + l.get("LAMBDA_EIKONAL", 0.1) * eik
    if l.get("LAMBDA_MASK", 0.0) != 0:
        ws = parts[:, 3].clamp(1e-3, 1.0 - 1e-3)
        loss = loss - l["LAMBDA_MASK"] * torch.mean(mask * torch.log(ws)
                                                    + (1.0 - mask) * torch.log(1.0 - ws))
    if r["TYPE"] == "Color_NeuS" and l.get("LAMBDA_RELIGHT", 1.0) != 0:
        rel = (torch.sum(parts[:, 4] * mask) / (parts.shape[0] * n_total * 3)) ** 2
        loss = loss + l.get("LAMBDA_RELIGHT", 1.0) * rel
    return loss


class ReferenceTrainer:
    """The reference's training state and step. `leaves`: the first
    weights (cloned here); `scene`: benchmark.scene.make_scene's dict;
    `sizes`: n_rays, n_samples, n_importance, up_sample_steps, batch_size;
    `start_step`: the step count the state starts at; `seed`: the steps'
    generator seed; `quant`: the control's rounding of every product."""

    def __init__(self, cfg: dict, leaves: dict, scene: dict, sizes: dict, start_step: int,
                 seed: int, quant=None, block_points: int = 1 << 17):
        pin_f32()
        self.m, self.t = cfg["MODEL"], cfg["TRAIN"]
        opt = self.t["OPTIMIZE"]
        if opt.get("TYPE", "adam") != "adam" or opt.get("SCHEDULER_TYPE", "NEUS") != "NEUS":
            raise NotImplementedError("the reference steps Adam under the NEUS schedule only")
        self.r = dict(self.m["RENDERER"], N_SAMPLES=sizes["n_samples"],
                      N_IMPORTANCE=sizes["n_importance"],
                      UP_SAMPLE_STEPS=sizes["up_sample_steps"])
        self.sizes, self.scene, self.quant = sizes, scene, quant
        dev = scene["images"].device
        self.leaves = {k: v.detach().clone().requires_grad_(self._learnt(k))
                       for k, v in leaves.items()}
        self.moment = {k: (torch.zeros_like(v), torch.zeros_like(v))
                       for k, v in self.leaves.items() if v.requires_grad}
        self.step_count = start_step
        self.adam_t = 0
        self.g = torch.Generator(device=dev).manual_seed(seed)
        self.block = max(1, block_points // (sizes["n_samples"] + sizes["n_importance"]))
        self.first_grad = None

    def _learnt(self, name: str) -> bool:
        m = self.m
        if name.startswith("focal."):
            return bool(m.get("LEARN_FOCAL", False))
        if name == "pose.r":
            return bool(m.get("LEARN_R", False))
        if name == "pose.t":
            return bool(m.get("LEARN_T", False))
        return True

    def _rays(self):
        sc, sz = self.scene, self.sizes
        n_img = sc["images"].shape[0]
        ids = torch.randperm(n_img, generator=self.g, device=sc["images"].device)
        ids = ids[:min(sz["batch_size"], n_img)]
        masks_b = sc["masks"][ids]
        share = mask_share(self.m, self.t, self.step_count, masks_b.device)
        idx, mask = draw_pixels(self.g, masks_b, sz["n_rays"], share)
        H, W = sc["H"], sc["W"]
        cam, rem = idx // (H * W), idx % (H * W)
        py, px = rem // W, rem % W
        gt = sc["images"][ids][cam, py, px]
        cx, cy = self.leaves["focal.fx"].detach(), self.leaves["focal.fy"].detach()
        fx, fy = cx * cx * W, cy * cy * H
        o, d, near, far = pixel_rays(sc["c2w"][ids][cam], fx, fy, py, px, H, W)
        return o, d, near, far, gt, mask

    def step(self) -> float:
        """One optimisation step; returns its loss."""
        o, d, near, far, gt, mask = self._rays()
        n = self.r["N_SAMPLES"]
        t = torch.linspace(0.0, 1.0, n, device=o.device)
        z = near[:, None] + (far - near)[:, None] * t[None, :]
        if self.r.get("PERTURB", 1.0) > 0:
            jitter = torch.rand((o.shape[0], 1), generator=self.g, device=o.device) - 0.5
            z = z + jitter * 2.0 / n
        blocks = [slice(i, i + self.block) for i in range(0, o.shape[0], self.block)]
        zs = [hierarchy(self.leaves, self.r, o[b], d[b], z[b], self.quant) for b in blocks]
        parts = torch.cat([core_partials(self.leaves, self.r, o[b], d[b], zb,
                                         self.quant).detach()
                           for b, zb in zip(blocks, zs)])
        n_total = self.r["N_SAMPLES"] + self.r["N_IMPORTANCE"]
        parts.requires_grad_(True)
        loss = loss_of(self.m, self.r, parts, gt, mask, n_total)
        d_parts, = torch.autograd.grad(loss, parts)
        learnt = [v for v in self.leaves.values() if v.requires_grad]
        grads = [torch.zeros_like(v) for v in learnt]
        for b, zb in zip(blocks, zs):
            p = core_partials(self.leaves, self.r, o[b], d[b], zb, self.quant)
            gs = torch.autograd.grad(p, learnt, grad_outputs=d_parts[b], allow_unused=True)
            for acc, gb in zip(grads, gs):
                if gb is not None:
                    acc += gb
        self._adam(dict(zip([k for k, v in self.leaves.items() if v.requires_grad], grads)))
        return float(loss.detach())

    @torch.no_grad()
    def _adam(self, grads: dict) -> None:
        lr = lr_at(self.t, self.step_count)
        clip = self.t.get("GRAD_CLIP_ENABLED", True)
        max_norm = float(self.t.get("GRAD_CLIP", {}).get("NORM", 1.0))
        b1, b2, eps = 0.9, 0.99, 1e-8
        self.adam_t += 1
        bc1, bc2 = 1 - b1 ** self.adam_t, 1 - b2 ** self.adam_t
        clipped = {}
        for k, g in grads.items():
            if clip:
                g = g * min(1.0, max_norm / max(float(torch.linalg.vector_norm(g)), 1e-6))
            clipped[k] = g
            m, v = self.moment[k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            self.leaves[k].sub_(lr / bc1 * m / (torch.sqrt(v / bc2) + eps))
        if self.first_grad is None:
            self.first_grad = clipped
        self.step_count += 1

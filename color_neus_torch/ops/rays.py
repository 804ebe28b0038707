"""Ray generation and sampling: port of color_neus_tpu/ops/rays.py.

Rays are computed only for the sampled pixels, on the device, with
static shapes (reference lib/models/tools/ray_utils.py materialises all
N*H*W rays each step). Randomness comes from an explicit
torch.Generator on the tensors' device; it cannot reproduce JAX's bits,
so the tests compare the samplers by distribution.
"""

from __future__ import annotations

import torch


def near_far_from_sphere(rays_o: torch.Tensor, rays_d: torch.Tensor):
    """Near/far as mid-point-of-closest-approach -/+ 1 (ray_utils.py:7-13)."""
    a = torch.sum(rays_d ** 2, dim=-1)
    b = 2.0 * torch.sum(rays_o * rays_d, dim=-1)
    mid = 0.5 * (-b) / a
    return mid - 1.0, mid + 1.0


def _cam_dirs(px, py, focal, H, W, normalize, opengl, dtype):
    """Camera-frame direction for pixels (x right, y down, z forward):
    no +0.5 pixel-centre offset, principal point (W/2, H/2)
    (ray_utils.py:45-50). opengl flips y and z."""
    ys = -1.0 if opengl else 1.0
    zs = -1.0 if opengl else 1.0
    dx = (px.to(dtype) - 0.5 * W) / focal[0]
    dy = ys * (py.to(dtype) - 0.5 * H) / focal[1]
    dz = zs * torch.ones_like(dx)
    dirs = torch.stack([dx, dy, dz], dim=-1)
    if normalize:
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return dirs


def _rotate(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """rot [..., 3, 3] @ v [..., 3] as an elementwise f32 product and sum:
    no matmul, so no TF32 path can round the ray directions."""
    return torch.sum(rot * v[..., None, :], dim=-1)


def rays_for_pixels(c2w, focal, px, py, H, W, normalize=False, opengl=False):
    """World-space rays for selected pixels.

    c2w [R, 4, 4] per ray; focal [2]; px/py [R] (x = column, y = row).
    Returns (rays_o, rays_d), each [R, 3]."""
    dirs = _cam_dirs(px, py, focal, H, W, normalize, opengl, c2w.dtype)
    rays_d = _rotate(c2w[:, :3, :3], dirs)
    rays_o = c2w[:, :3, 3]
    return rays_o, rays_d


def all_rays_for_camera(c2w, focal, H, W, normalize=False, opengl=False):
    """All H*W rays of one camera (c2w [4,4]); returns [H, W, 3] pairs
    (get_rays_at, ray_utils.py:90-119)."""
    dev = c2w.device
    py, px = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")
    dirs = _cam_dirs(px, py, focal, H, W, normalize, opengl, c2w.dtype)
    rays_d = _rotate(c2w[:3, :3], dirs)
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


# ---------------------------------------------------------------------------
# Pixel sampling
# ---------------------------------------------------------------------------

def sample_pixels_uniform(generator, n_cams: int, H: int, W: int, n_rays: int,
                          first_image_only: bool = False, device="cpu"):
    """Uniform pixel sampling over a batch of cameras.

    first_image_only replicates the reference's maskless-path quirk
    (ray_utils.py:57-59: only camera 0 is ever sampled).
    Returns (cam_idx [R], py [R], px [R])."""
    if first_image_only:
        cam_idx = torch.zeros((n_rays,), dtype=torch.long, device=device)
    else:
        cam_idx = torch.randint(0, n_cams, (n_rays,), generator=generator, device=device)
    pix = torch.randint(0, H * W, (n_rays,), generator=generator, device=device)
    return cam_idx, pix // W, pix % W


def _share(mask_rate, dev) -> torch.Tensor:
    """The in-mask share (a float or a 0-d tensor, the trainer's on the
    device) as a 0-d f32 tensor on dev."""
    return torch.as_tensor(mask_rate, dtype=torch.float32, device=dev)


def sample_pixels_masked(generator, masks: torch.Tensor, n_rays: int, mask_rate):
    """Bernoulli mask-aware sampling, with replacement: each ray lands
    in-mask with probability mask_rate, uniformly over the in-mask pixels
    of the batch (uniformly over background otherwise). Nothing is read
    on the host. Returns (cam_idx, py, px, sel_mask), each [R]."""
    B, H, W = masks.shape
    dev = masks.device
    mask_rate = _share(mask_rate, dev)
    flat = masks.reshape(-1) > 0.5
    cin = torch.cumsum(flat.to(torch.int64), 0)
    cout = torch.cumsum((~flat).to(torch.int64), 0)
    m_in = cin[-1]
    m_out = cout[-1]

    pick_in = torch.rand((n_rays,), generator=generator, device=dev) < mask_rate
    pick_in = torch.where(m_in == 0, torch.zeros_like(pick_in),
                          torch.where(m_out == 0, torch.ones_like(pick_in), pick_in))

    def draw(cum, m):
        # k-th element of the set (1-based) on the nondecreasing count
        u = torch.rand((n_rays,), generator=generator, device=dev)
        tgt = torch.minimum((u * m).to(torch.int64) + 1, torch.clamp_min(m, 1))
        return torch.searchsorted(cum, tgt, right=False)

    idx = torch.where(pick_in, draw(cin, m_in), draw(cout, m_out))
    sel_mask = flat[idx].to(masks.dtype)
    cam_idx = idx // (H * W)
    rem = idx % (H * W)
    return cam_idx, rem // W, rem % W, sel_mask


def sample_pixels_masked_exact(generator, masks: torch.Tensor, n_rays: int,
                               mask_rate):
    """Exact-count masked split (the default, reference ray_utils.py:61-76):
    n_in = int(mask_rate * n_rays) rays in-mask (clamped to the in-mask
    pixel count), the rest on background, each set drawn without
    replacement, uniformly — Gumbel-top-k over the flattened pixels
    (uniform key per pixel, top n_rays per set), spliced at n_in. n_in is
    computed on the device from the share (a float or a 0-d tensor), in
    f32 and truncated as the JAX package does: nothing is read on the host.
    Returns (cam_idx, py, px, sel_mask), each [R]."""
    B, H, W = masks.shape
    dev = masks.device
    flat = masks.reshape(-1) > 0.5
    gi = torch.rand(flat.shape, generator=generator, device=dev)
    go = torch.rand(flat.shape, generator=generator, device=dev)
    in_cand = torch.topk(gi.masked_fill(~flat, float("-inf")), n_rays).indices
    out_cand = torch.topk(go.masked_fill(flat, float("-inf")), n_rays).indices
    m_in = torch.sum(flat.to(torch.int64))
    m_out = flat.numel() - m_in
    n_in = (_share(mask_rate, dev) * n_rays).to(torch.int64)   # int() truncation
    n_in = torch.minimum(n_in, torch.clamp_max(m_in, n_rays))
    # defensive (the reference assumes enough background pixels exist)
    n_in = torch.maximum(n_in, n_rays - torch.clamp_max(m_out, n_rays))
    i = torch.arange(n_rays, device=dev)
    idx = torch.where(i < n_in, in_cand,
                      out_cand[torch.clamp(i - n_in, 0, n_rays - 1)])
    sel_mask = flat[idx].to(masks.dtype)
    cam_idx = idx // (H * W)
    rem = idx % (H * W)
    return cam_idx, rem // W, rem % W, sel_mask


# ---------------------------------------------------------------------------
# Inverse-CDF importance sampling
# ---------------------------------------------------------------------------

def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = True, generator=None) -> torch.Tensor:
    """Draw n_samples per ray from the piecewise-constant pdf over bins.

    bins [R, M] (edges = the coarse z), weights [R, M-1]. det=True uses
    linspace(0.5/n, 1-0.5/n, n). 1e-5 floors as ray_utils.py:123-154.
    searchsorted(right=True) equals the JAX package's counting form
    #(cdf <= u) because the cdf is nondecreasing."""
    R, M = bins.shape
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros((R, 1), dtype=cdf.dtype, device=cdf.device), cdf], dim=-1)

    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=cdf.dtype, device=cdf.device)
        u = u.expand(R, n_samples).contiguous()
    else:
        if generator is None:
            raise ValueError("stochastic sample_pdf needs a generator")
        u = torch.rand((R, n_samples), generator=generator, dtype=cdf.dtype,
                       device=cdf.device)

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, M - 1)

    cdf_b = torch.gather(cdf, 1, below)
    cdf_a = torch.gather(cdf, 1, above)
    bins_b = torch.gather(bins, 1, below)
    bins_a = torch.gather(bins, 1, above)

    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)

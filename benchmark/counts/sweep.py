"""The hierarchy's placement sweeps of one training step: the SDF value
of the coarse samples and of every up-sample round's new samples but the
last round's (which only merges z). Operations and bytes as counts/march."""

from __future__ import annotations

from benchmark.counts import networks


def points_per_ray(n_samples: int, n_importance: int, up_sample_steps: int) -> int:
    return n_samples + (up_sample_steps - 1) * (n_importance // up_sample_steps)


def flops(r: dict, n_rays: int, n_samples: int, n_importance: int,
          up_sample_steps: int) -> float:
    pts = n_rays * points_per_ray(n_samples, n_importance, up_sample_steps)
    return 2.0 * pts * networks.sdf_value_macs(r)


def bytes_moved(r: dict, n_rays: int, n_samples: int, n_importance: int,
                up_sample_steps: int) -> float:
    w = networks.macs(networks.sdf_layers(r))
    pts = n_rays * points_per_ray(n_samples, n_importance, up_sample_steps)
    return 4.0 * (w + n_rays * 6 + 2 * pts)

"""idle_pct.train: The device's idle share of the traced training window, in %: 1 - the
union of the device's intervals / the window's host seconds.

Layer: device. Unit: %. Moves: train_rays_per_s.
Returns None where the trace holds nothing to read.
"""


def read(ctx):
    if ctx.get("kind") != "train" or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["summary"].busy_s / ctx["window_s"])

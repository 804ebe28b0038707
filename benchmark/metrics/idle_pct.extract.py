"""idle_pct.extract: The device's idle share of the traced extractions, in %: 1 - the union
of the device's intervals / the window's host seconds.

Layer: device. Unit: %. Moves: extract_s.
Returns None where the trace holds nothing to read.
"""


def read(ctx):
    if ctx.get("kind") != "extract" or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["summary"].busy_s / ctx["window_s"])

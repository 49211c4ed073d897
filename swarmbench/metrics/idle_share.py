"""The device's idle share of the profiled rounds: 1 − (the union of its
kernel, copy and set intervals) / the rounds' wall, both from a trace of
the device's activity alone between two markers (`swarmbench.trace`), so
that recording host ops adds no gaps of its own."""
LAYER = "Device"
UNIT, MOVES = "%", "step_s"


def read(ctx):
    prof = ctx.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])

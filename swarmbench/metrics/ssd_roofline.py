"""The SSD scan's forward kernels' share of their roofline: the bound of
every call the profiled rounds made (`swarmbench.work.ssd_bound` at its
shape) over the device time of the three kernels of a call
(chunk_state, state_pass, chunk_out), each kernel's records scaled to
the calls made."""
from swarmbench import rates, work

LAYER = "Kernels: kernels/ssd_scan.py -> csrc/ssd_scan.cu"
UNIT, MOVES = "%", "step_s"
KERNELS = ("chunk_state_kernel", "state_pass_kernel", "chunk_out_kernel")


def read(ctx):
    prof = ctx.get("profile")
    calls = ctx["cell"].kernels.get("ssd")
    if not prof or not calls:
        return None
    made = sum(c for _, c in calls) * prof["rounds"]
    seconds = 0.0
    for k in KERNELS:
        hits = [(n, s) for name, (n, s) in prof["kernels"].items() if k in name]
        n = sum(h[0] for h in hits)
        if n == 0:
            return None
        seconds += sum(h[1] for h in hits) * made / n
    pk = rates.peaks(ctx["kind"])
    bound = prof["rounds"] * sum(
        c * work.ssd_bound(*shape, pk["hbm_bytes_per_s"], pk["float32"],
                           pk["bfloat16"])[0] for shape, c in calls)
    return 100.0 * bound / seconds

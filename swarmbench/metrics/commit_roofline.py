"""The fused commit kernel's share of its roofline: the least time its
bytes need at the card's HBM rate (`swarmbench.work.commit_bytes`: each
input read once, each output written once) over the mean device time of
its records in the trace."""
from swarmbench import rates, trace, work

LAYER = "Kernels: kernels/fused_merge.py -> csrc/fused_merge.cu"
UNIT, MOVES = "%", "step_s"


def read(ctx):
    prof = ctx.get("profile")
    spec = ctx["cell"].kernels.get("commit")
    if not prof or not spec:
        return None
    count, seconds = trace.kernel_time(prof, "merge_all_kernel")
    if count == 0 or seconds <= 0:
        return None
    bw = rates.peaks(ctx["kind"])["hbm_bytes_per_s"]
    bound = work.commit_bytes(spec["n"], spec["p"], spec["itemsize"]) / bw
    return 100.0 * bound / (seconds / count)

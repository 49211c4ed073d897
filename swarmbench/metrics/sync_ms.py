"""Milliseconds of one sync: the host clock around ``engine.sync``
(synchronised before and after: gate metrics, mixing, wire, commit),
averaged over the spanned rounds."""
LAYER = "Engine sync: core/engine.py sync -> gate eval, core/topology.py, core/merge_impl.py, core/comms.py"
UNIT, MOVES = "ms", "step_s"


def read(ctx):
    spans = ctx.get("spans", {}).get("sync_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)

"""Milliseconds of one local step: the host clock around the engine's
local-step call (synchronised before and after), summed over the spanned
rounds' steps and divided by them."""
LAYER = "Session local steps: core/session.py round -> core/engine.py vmapped steps -> optim/adamw.py"
UNIT, MOVES = "ms", "step_s"


def read(ctx):
    spans = ctx.get("spans", {}).get("local_steps_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)

"""The model's operations over the plain rounds' wall, as a share of the
card's peak in the configuration's stated precision (`swarmbench.work`'s
formulas: a training step counts its forward and backward, not any
recompute; the gate its forwards)."""
LAYER = "Model step: models/cnn.py; models/ssm.py via launch/train.py TrainStep"
UNIT, MOVES = "%", "step_s"


def read(ctx):
    plain = ctx.get("plain")
    cell = ctx["cell"]
    if not plain or plain["wall_s"] <= 0:
        return None
    flops = plain["rounds"] * cell.round_flops
    return 100.0 * flops / plain["wall_s"] / cell.peak_flops

"""The host clock around GpuEngine.stage_params in set-up (engine
staging: the pk's queries checked, converted and laid out on the
card)."""


def read(ctx):
    return ctx["setup"].get("stage_s")

"""The mean milliseconds a tick of the single robot's mapping stage, between
the CUDA events the benchmark records at the program's ``mark`` hooks over
the window of the traced run."""


def read(ctx):
    return (ctx.get("stages") or {}).get("mapping")

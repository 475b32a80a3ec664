"""torch.cuda.max_memory_allocated() after the window, reset at the
start of set-up, in GB (1e9 bytes)."""


def read(ctx):
    b = ctx["memory_peak_bytes"]
    return b / 1e9 if b else None

"""Process start (run.py's first line) to the window's start: imports,
the kernels built or loaded, inputs, staging and the warm-up proofs
(host clock)."""


def read(ctx):
    return ctx["setup"]["setup_s"]

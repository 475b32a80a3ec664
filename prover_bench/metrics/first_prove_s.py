"""The host clock around set-up's first prove() (prover warm-up: the
domain's tables, the R1CS's CSR, a process's first torch field
product)."""


def read(ctx):
    return ctx["setup"].get("first_prove_s")

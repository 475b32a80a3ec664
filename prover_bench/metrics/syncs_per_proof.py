"""The host's waits for the card a proof, as torch's sync debug mode
counts them (pageable copies, reads, synchronize): the program's counter
``syncs`` (the stage timer's own waits, ``syncs_timer``, left out), a
median over the window's proofs."""

from prover_bench.spans import median_counter


def read(ctx):
    return median_counter(ctx, "syncs")

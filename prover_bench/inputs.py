"""A cell's inputs, made from the seed: the circuit, a pool of
witnesses, the proving key's discrete logs and points, and each proof's
r and s.  The same seed gives the same inputs.

The proving key is made of pools, as a real CRS would take minutes of
scalar multiplications to make: the a, b_g1 and l queries cycle through
67 G1 points each, b_g2 through 19 G2 points, all with random discrete
logs; the h query's point i is ``k tau^i`` times the generator, tau of
order ``H_POOL`` (a prime factor of r - 1), so it cycles through
``H_POOL`` points.  Pool sizes are odd primes, so that no cycle lines up
with the prover's power-of-two chunks.  The query arrays are built by
indexing the pool's 16-bit limbs, as the pk reader hands them to the
prover.  ``reference/groth16.py`` works the expected proof out from the
logs.
"""

from __future__ import annotations

import random

import numpy as np

from .reference.bn254 import G1, G2, R, FixedBase, Fq, Fq2

G1_POOL = 67
G2_POOL = 19
H_POOL = 983      # divides r - 1


def stream(seed: int, name: str) -> random.Random:
    """An independent stream of draws for one kind of input."""
    return random.Random(f"{seed}:{name}")


def pool_size(traffic: dict, constraints: int) -> int:
    """W witnesses: as many as make the traffic's witness budget,
    within its bounds."""
    p = traffic["witness_pool"]
    return max(p["min"], min(p["max"], p["constraints"] // constraints))


def proving_key_logs(seed: int) -> dict:
    rng = stream(seed, "pk")
    logs = {q: [rng.randrange(1, R) for _ in range(G1_POOL)]
            for q in ("a", "b1", "l")}
    logs["b2"] = [rng.randrange(1, R) for _ in range(G2_POOL)]
    logs["tau"] = pow(pow(5, (R - 1) // H_POOL, R), rng.randrange(1, H_POOL),
                      R)
    logs["k"] = rng.randrange(1, R)
    for name in ("alpha", "beta", "delta"):
        logs[name] = rng.randrange(1, R)
    return logs


def limbs(values) -> np.ndarray:
    """ints < 2^256 -> (16, n) uint32 of 16-bit little-endian limbs."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, "<u2").reshape(len(values), 16).T.astype(
        np.uint32)


def pool_arrays(points, n: int, g2: bool) -> dict:
    """n query columns cycling through the pool's affine points, as
    projective limb arrays (z = 1): x, y, z for G1; x0, x1, y0, y1, z0
    for G2."""
    idx = np.arange(n) % len(points)
    if g2:
        coords = {"x0": [p[0][0] for p in points],
                  "x1": [p[0][1] for p in points],
                  "y0": [p[1][0] for p in points],
                  "y1": [p[1][1] for p in points]}
        coords["z0"] = [1] * len(points)
    else:
        coords = {"x": [p[0] for p in points], "y": [p[1] for p in points],
                  "z": [1] * len(points)}
    return {k: limbs(v)[:, idx] for k, v in coords.items()}


def proving_key(circuit: dict, logs: dict) -> dict:
    """The pk's points: the five queries as limb arrays and the
    verifying key's points, affine plain tuples."""
    n = len(circuit["a"])
    ni = circuit["num_inputs"]
    nv = ni + circuit["num_aux"]
    m = 1
    while m < n + ni:
        m <<= 1
    g1, g2 = FixedBase(G1, Fq), FixedBase(G2, Fq2)
    tau, k = logs["tau"], logs["k"]
    h_logs = [k * pow(tau, c, R) % R for c in range(H_POOL)]
    pools = {q: g1.mul_many(logs[q]) for q in ("a", "b1", "l")}
    pools["h"] = g1.mul_many(h_logs)
    pools["b2"] = [g2.mul(v) for v in logs["b2"]]
    al, be, de = logs["alpha"], logs["beta"], logs["delta"]
    return {
        "a": pool_arrays(pools["a"], nv, False),
        "b1": pool_arrays(pools["b1"], nv, False),
        "l": pool_arrays(pools["l"], circuit["num_aux"], False),
        "h": pool_arrays(pools["h"], m - 1, False),
        "b2": pool_arrays(pools["b2"], nv, True),
        "m": m,
        "vk": {"alpha_g1": g1.mul(al), "beta_g1": g1.mul(be),
               "beta_g2": g2.mul(be), "delta_g1": g1.mul(de),
               "delta_g2": g2.mul(de), "gamma_g2": G2, "ic": [G1] * ni},
    }


def witness_pool(gen, config: dict, seed: int, W: int) -> list:
    rng = stream(seed, "witness")
    return [gen.witness(config, rng) for _ in range(W)]


class Randomness:
    """Each proof's r and s, drawn in turn from the seed."""

    def __init__(self, seed: int):
        self.rng = stream(seed, "rs")

    def next(self) -> tuple[int, int]:
        return self.rng.randrange(1, R), self.rng.randrange(1, R)

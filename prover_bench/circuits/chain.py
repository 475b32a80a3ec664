"""The multiplier chain t[i] = t[i-1]^2 + i as rank-1 constraints.

Variables: 0 is ONE, 1 the public input x = t[-1], then t[0] .. t[n-1]
(variable i + 2 is t[i]).  Row i states t[i-1] * t[i-1] = t[i] - i.
Built row by row as the R1CS, the way synthetic benchmark circuits are;
a witness is the chain's values from a uniform x in Fr.
"""

from __future__ import annotations

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def rows(config: dict) -> dict:
    """The constraint system of ``config["constraints"]`` rows: the
    sparse rows of A, B and C as lists of (variable, coefficient)."""
    n = config["constraints"]
    a = [[(i + 1, 1)] for i in range(n)]
    b = [[(i + 1, 1)] for i in range(n)]
    c = [[(i + 2, 1), (0, -i % R)] for i in range(n)]
    return {"num_inputs": 2, "num_aux": n, "input_names": ["main.x"],
            "a": a, "b": b, "c": c}


def witness(config: dict, rng) -> list[int]:
    """z = [1, x, t[0], ..., t[n-1]] for a uniform x drawn from rng."""
    n = config["constraints"]
    z = [1, rng.randrange(1, R)]
    t = z[1]
    for i in range(n):
        t = (t * t + i) % R
        z.append(t)
    return z

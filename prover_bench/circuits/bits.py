"""circomlib's ``Num2Bits(n)`` range check, K instances under one main,
as rank-1 constraints.

The template (circomlib ``circuits/bitify.circom``) states each bit
``out[i] * (out[i] - 1) === 0`` and then ``sum 2^i out[i] === in``.  The
main has one public ``signal input x`` wired to instance 0 and
``signal private input in[K-1]`` wired to the rest; the port's frontend
(``za_tpu_torch.compiler`` and ``optimize``) folds the K wiring rows
away and emits, instance by instance, n + 1 rows:
- for each bit b: A = [(b, 1)], B = [(b, 1), (0, r - 1)], C = [];
- then A = B = [] and C = [(out[i], r - 2^i) for i < n] + [(in, 1)].

Variables: 0 is ONE, 1 is x (instance 0's input, the one public
input), 2 .. K the private inputs of instances 1 .. K-1, then bit i of
instance k is variable K + 1 + n k + i.  Built row by row here, as the
frontend emits them, so that set-up needs no compile; a witness is each
instance's input uniform below min(r, 2^n) and its bits.
"""

from __future__ import annotations

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def _sizes(config: dict) -> tuple[int, int]:
    K, n = config["instances"], config["bits"]
    if config["constraints"] != K * (n + 1):
        raise ValueError(f"constraints {config['constraints']} is not "
                         f"instances x (bits + 1) = {K * (n + 1)}")
    return K, n


def rows(config: dict) -> dict:
    """The constraint system: the sparse rows of A, B and C as lists of
    (variable, coefficient), in the frontend's order."""
    K, n = _sizes(config)
    minus_one = (0, R - 1)
    a, b, c = [], [], []
    for k in range(K):
        base = K + 1 + n * k
        for v in range(base, base + n):
            a.append([(v, 1)])
            b.append([(v, 1), minus_one])
            c.append([])
        a.append([])
        b.append([])
        c.append([(base + i, R - (1 << i)) for i in range(n)] + [(1 + k, 1)])
    return {"num_inputs": 2, "num_aux": K - 1 + n * K,
            "input_names": ["main.x"], "a": a, "b": b, "c": c}


def witness(config: dict, rng) -> list[int]:
    """z = [1, in[0], ..., in[K-1], bits of in[0], ..., bits of in[K-1]]
    for inputs drawn uniform below min(r, 2^n) from rng."""
    K, n = _sizes(config)
    ins = [rng.randrange(0, min(R, 1 << n)) for _ in range(K)]
    z = [1] + ins
    for v in ins:
        z.extend((v >> i) & 1 for i in range(n))
    return z

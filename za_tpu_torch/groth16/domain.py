"""Radix-2 evaluation domain over Fr (host reference implementation).

Golden model for the device NTT (za_tpu_torch.engine.ntt). Mirrors the
role of bellman's EvaluationDomain: forward/inverse NTT over the 2^k
roots-of-unity domain and the distinguished multiplicative coset used
for the QAP h(x) division.
"""

from __future__ import annotations

from ..curve import FR_GENERATOR, FR_ROOT_OF_UNITY, FR_TWO_ADICITY, R


class Domain:
    def __init__(self, size: int):
        assert size & (size - 1) == 0, "domain size must be a power of two"
        k = size.bit_length() - 1
        assert k <= FR_TWO_ADICITY
        self.size = size
        self.k = k
        self.omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - k), R)
        self.omega_inv = pow(self.omega, R - 2, R)
        self.size_inv = pow(size, R - 2, R)
        self.coset_gen = FR_GENERATOR
        self.coset_gen_inv = pow(FR_GENERATOR, R - 2, R)
        # Z(x) = x^m - 1 evaluated anywhere on the coset g*<omega>:
        # (g w^i)^m - 1 = g^m - 1 (constant)
        self.z_coset = (pow(self.coset_gen, size, R) - 1) % R
        self.z_coset_inv = pow(self.z_coset, R - 2, R)

    @staticmethod
    def for_constraints(n: int) -> "Domain":
        size = 1
        while size < n:
            size <<= 1
        return Domain(size)

    # -- host NTT ------------------------------------------------------------

    def _ntt(self, values: list[int], omega: int) -> list[int]:
        n = self.size
        assert len(values) == n
        a = list(values)
        # bit-reversal permutation
        j = 0
        for i in range(1, n):
            bit = n >> 1
            while j & bit:
                j ^= bit
                bit >>= 1
            j |= bit
            if i < j:
                a[i], a[j] = a[j], a[i]
        length = 2
        while length <= n:
            wlen = pow(omega, n // length, R)
            for i in range(0, n, length):
                w = 1
                half = length >> 1
                for k in range(i, i + half):
                    u = a[k]
                    v = a[k + half] * w % R
                    a[k] = (u + v) % R
                    a[k + half] = (u - v) % R
                    w = w * wlen % R
            length <<= 1
        return a

    def ntt(self, coeffs: list[int]) -> list[int]:
        """Coefficients -> evaluations on <omega>."""
        return self._ntt(coeffs, self.omega)

    def intt(self, evals: list[int]) -> list[int]:
        """Evaluations on <omega> -> coefficients."""
        a = self._ntt(evals, self.omega_inv)
        return [x * self.size_inv % R for x in a]

    def coset_ntt(self, coeffs: list[int]) -> list[int]:
        """Coefficients -> evaluations on the coset g*<omega>."""
        g = self.coset_gen
        scaled = []
        p = 1
        for c in coeffs:
            scaled.append(c * p % R)
            p = p * g % R
        return self._ntt(scaled, self.omega)

    def coset_intt(self, evals: list[int]) -> list[int]:
        """Evaluations on g*<omega> -> coefficients."""
        a = self._ntt(evals, self.omega_inv)
        out = []
        p = self.size_inv
        gi = self.coset_gen_inv
        for c in a:
            out.append(c * p % R)
            p = p * gi % R
        return out

    def lagrange_at(self, tau: int) -> list[int]:
        """Evaluate all Lagrange basis polynomials at tau:
        L_k(tau) = Z(tau) * w^k / (m * (tau - w^k)), batch-inverted."""
        m = self.size
        z_tau = (pow(tau, m, R) - 1) % R
        if z_tau == 0:
            # tau on the domain: L_k(tau) = delta_k
            out = [0] * m
            p = 1
            for k in range(m):
                if p == tau:
                    out[k] = 1
                p = p * self.omega % R
            return out
        denoms = []
        p = 1
        for _ in range(m):
            denoms.append((tau - p) * m % R)
            p = p * self.omega % R
        invs = batch_inverse(denoms)
        out = []
        p = 1
        for k in range(m):
            out.append(z_tau * p % R * invs[k] % R)
            p = p * self.omega % R
        return out


def batch_inverse(values: list[int]) -> list[int]:
    """Montgomery batch inversion over Fr."""
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * v % R
    inv_all = pow(prefix[n], R - 2, R)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % R
        inv_all = inv_all * values[i] % R
    return out

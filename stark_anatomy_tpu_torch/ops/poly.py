"""Host-side univariate polynomials over F_p (exact Python ints).

Used by the verifier (a handful of evaluations per query) and by tests as
the oracle for the device NTT path. Dense coefficient lists, low-degree
only - O(n^2) interpolation is fine for boundary interpolants and
zerofiers over a few points. The bulk prover math lives in ops/ntt.py.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

from stark_anatomy_tpu_torch.ops.field import PRIME, finv


def _trim(coeffs: List[int]) -> List[int]:
    while coeffs and coeffs[-1] == 0:
        coeffs.pop()
    return coeffs


class Polynomial:
    """Dense univariate polynomial; coeffs[i] multiplies x^i."""

    __slots__ = ("coeffs",)

    def __init__(self, coeffs: Iterable[int]):
        self.coeffs = _trim([c % PRIME for c in coeffs])

    @staticmethod
    def zero() -> "Polynomial":
        return Polynomial([])

    @staticmethod
    def constant(c: int) -> "Polynomial":
        return Polynomial([c])

    @staticmethod
    def x() -> "Polynomial":
        return Polynomial([0, 1])

    def degree(self) -> int:
        """Degree; -1 for the zero polynomial."""
        return len(self.coeffs) - 1

    def is_zero(self) -> bool:
        return not self.coeffs

    def __add__(self, other: "Polynomial") -> "Polynomial":
        n = max(len(self.coeffs), len(other.coeffs))
        a = self.coeffs + [0] * (n - len(self.coeffs))
        b = other.coeffs + [0] * (n - len(other.coeffs))
        return Polynomial([x + y for x, y in zip(a, b)])

    def __sub__(self, other: "Polynomial") -> "Polynomial":
        n = max(len(self.coeffs), len(other.coeffs))
        a = self.coeffs + [0] * (n - len(self.coeffs))
        b = other.coeffs + [0] * (n - len(other.coeffs))
        return Polynomial([x - y for x, y in zip(a, b)])

    def __neg__(self) -> "Polynomial":
        return Polynomial([-c for c in self.coeffs])

    def __mul__(self, other: "Polynomial") -> "Polynomial":
        if self.is_zero() or other.is_zero():
            return Polynomial.zero()
        out = [0] * (len(self.coeffs) + len(other.coeffs) - 1)
        for i, a in enumerate(self.coeffs):
            if a == 0:
                continue
            for j, b in enumerate(other.coeffs):
                out[i + j] = (out[i + j] + a * b) % PRIME
        return Polynomial(out)

    def scale_coeff(self, c: int) -> "Polynomial":
        return Polynomial([a * c for a in self.coeffs])

    def divmod(self, divisor: "Polynomial") -> tuple["Polynomial", "Polynomial"]:
        """Euclidean division; exact long division over the field."""
        if divisor.is_zero():
            raise ZeroDivisionError("polynomial division by zero")
        rem = list(self.coeffs)
        dd = divisor.degree()
        lead_inv = finv(divisor.coeffs[-1])
        quot = [0] * max(len(rem) - dd, 0)
        for i in range(len(rem) - 1, dd - 1, -1):
            if rem[i] == 0:
                continue
            q = rem[i] * lead_inv % PRIME
            quot[i - dd] = q
            for j, b in enumerate(divisor.coeffs):
                rem[i - dd + j] = (rem[i - dd + j] - q * b) % PRIME
        return Polynomial(quot), Polynomial(rem)

    def __floordiv__(self, other: "Polynomial") -> "Polynomial":
        q, r = self.divmod(other)
        if not r.is_zero():
            raise ValueError("polynomial division left a remainder")
        return q

    def evaluate(self, x: int) -> int:
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * x + c) % PRIME
        return acc

    def evaluate_domain(self, xs: Sequence[int]) -> List[int]:
        return [self.evaluate(x) for x in xs]

    def scale_arg(self, c: int) -> "Polynomial":
        """P(c*x): coeffs[i] *= c^i (the coset-shift trick)."""
        out, ci = [], 1
        for a in self.coeffs:
            out.append(a * ci % PRIME)
            ci = ci * c % PRIME
        return Polynomial(out)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Polynomial) and self.coeffs == other.coeffs

    def __repr__(self) -> str:
        return f"Polynomial({self.coeffs})"

    @staticmethod
    def interpolate(xs: Sequence[int], ys: Sequence[int]) -> "Polynomial":
        """Lagrange interpolation, O(n^2); for small point sets only."""
        if len(xs) != len(ys):
            raise ValueError("mismatched point/value lengths")
        if len(set(x % PRIME for x in xs)) != len(xs):
            raise ValueError("interpolation points must be distinct")
        acc = Polynomial.zero()
        for i, (xi, yi) in enumerate(zip(xs, ys)):
            basis = Polynomial.constant(1)
            denom = 1
            for j, xj in enumerate(xs):
                if i == j:
                    continue
                basis = basis * Polynomial([-xj, 1])
                denom = denom * (xi - xj) % PRIME
            acc = acc + basis.scale_coeff(yi * finv(denom))
        return acc

    @staticmethod
    def zerofier(xs: Sequence[int]) -> "Polynomial":
        """prod_i (X - x_i)."""
        acc = Polynomial.constant(1)
        for x in xs:
            acc = acc * Polynomial([-x, 1])
        return acc

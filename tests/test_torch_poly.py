"""PyTorch port, host polynomials and the NTT product: `Polynomial` laws
against the JAX package's class on the same integers, and `poly_mul` against
the JAX package's and against schoolbook (exact equality)."""

import jax.numpy as jnp
import numpy as np
import pytest

from stark_anatomy_tpu.ops import field_jnp as fj
from stark_anatomy_tpu.ops import ntt as ref_ntt
from stark_anatomy_tpu.ops.poly import Polynomial as RefPolynomial
from stark_anatomy_tpu_torch.ops import field_torch as ft
from stark_anatomy_tpu_torch.ops import ntt as nttmod
from stark_anatomy_tpu_torch.ops.field import PRIME, primitive_root_of_unity
from stark_anatomy_tpu_torch.ops.limbs import ints_to_words, to_tensor, words_to_ints
from stark_anatomy_tpu_torch.ops.poly import Polynomial
from stark_anatomy_tpu_torch.reference import to_reference_limbs


def _ints(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(16), "little") % PRIME for _ in range(n)]


def _mont(values):
    return ft.to_mont(to_tensor(ints_to_words(values), "cpu"))


def _from_mont(t):
    return [int(v) for v in words_to_ints(ft.from_mont(t).numpy())]


@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg", "divmod", "scale_arg", "evaluate"])
def test_polynomial_operations_equal_the_reference_class(op):
    a, b = _ints(1, 13), _ints(2, 7)
    pa, pb, ra, rb = Polynomial(a), Polynomial(b), RefPolynomial(a), RefPolynomial(b)
    if op == "add":
        assert (pa + pb).coeffs == (ra + rb).coeffs
    elif op == "sub":
        assert (pa - pb).coeffs == (ra - rb).coeffs and (pa - pa).is_zero()
    elif op == "mul":
        assert (pa * pb).coeffs == (ra * rb).coeffs and (pa * Polynomial.zero()).is_zero()
    elif op == "neg":
        assert (-pa).coeffs == (-ra).coeffs and (pa + (-pa)).degree() == -1
    elif op == "divmod":
        q, r = pa.divmod(pb)
        rq, rr = ra.divmod(rb)
        assert q.coeffs == rq.coeffs and r.coeffs == rr.coeffs
        assert q * pb + r == pa and r.degree() < pb.degree()
        assert (pa * pb) // pb == pa
        with pytest.raises(ValueError):
            pa // pb
        with pytest.raises(ZeroDivisionError):
            pa.divmod(Polynomial.zero())
    elif op == "scale_arg":
        assert pa.scale_arg(12345).coeffs == ra.scale_arg(12345).coeffs
        assert pa.scale_arg(12345).evaluate(7) == pa.evaluate(12345 * 7 % PRIME)
    else:
        xs = _ints(3, 5)
        assert pa.evaluate_domain(xs) == ra.evaluate_domain(xs)
        assert Polynomial.constant(9).evaluate(5) == 9 and Polynomial.x().evaluate(5) == 5


def test_interpolate_and_zerofier_equal_the_reference_and_their_laws():
    xs, ys = _ints(4, 6), _ints(5, 6)
    p = Polynomial.interpolate(xs, ys)
    assert p.coeffs == RefPolynomial.interpolate(xs, ys).coeffs
    assert p.evaluate_domain(xs) == ys and p.degree() <= 5
    z = Polynomial.zerofier(xs)
    assert z.coeffs == RefPolynomial.zerofier(xs).coeffs
    assert z.degree() == 6 and z.evaluate_domain(xs) == [0] * 6 and z.coeffs[-1] == 1
    with pytest.raises(ValueError):
        Polynomial.interpolate(xs, ys[:-1])
    with pytest.raises(ValueError):
        Polynomial.interpolate([1, 1], [2, 3])
    assert "Polynomial([" in repr(p) and p != z and p == Polynomial(p.coeffs + [0, 0])


def test_poly_mul_vs_schoolbook_and_the_reference():
    a, b = _ints(6, 13), _ints(7, 7)
    prod = nttmod.poly_mul(_mont(a), _mont(b))
    assert prod.shape == (4, 19)
    expect = (Polynomial(a) * Polynomial(b)).coeffs
    assert _from_mont(prod) == expect + [0] * (19 - len(expect))
    want = ref_ntt.poly_mul(fj.to_mont(jnp.asarray(to_reference_limbs(to_tensor(ints_to_words(a), "cpu")))),
                            fj.to_mont(jnp.asarray(to_reference_limbs(to_tensor(ints_to_words(b), "cpu")))))
    np.testing.assert_array_equal(to_reference_limbs(prod), np.asarray(want))


def test_poly_mul_pow2_lengths_by_evaluation_and_ntt_evaluates_a_polynomial():
    n = 1 << 8
    a, b = _ints(8, n), _ints(9, n)
    prod = _from_mont(nttmod.poly_mul(_mont(a), _mont(b)))
    assert len(prod) == 2 * n - 1
    pa, pb, pp = Polynomial(a), Polynomial(b), Polynomial(prod)
    for x in _ints(10, 4):
        assert pp.evaluate(x) == pa.evaluate(x) * pb.evaluate(x) % PRIME
    w = primitive_root_of_unity(32)
    coeffs = _ints(11, 32)
    assert _from_mont(nttmod.ntt(_mont(coeffs))) == \
        Polynomial(coeffs).evaluate_domain([pow(w, i, PRIME) for i in range(32)])
    one = nttmod.poly_mul(_mont([5]), _mont([7]))
    assert _from_mont(one) == [35]

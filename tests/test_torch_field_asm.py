"""PyTorch port, csrc/field.cuh: the PTX carry chains of add, sub, cond_sub_p
and mont_mul, read out of the source and interpreted word by word in Python,
against the arithmetic they stand for, against the plain PyTorch versions and
against the JAX package's field_jnp on the same inputs.
No compiler runs on the CPU, so this is what holds the assembly text before
the card does. Exact equality everywhere."""

import os
import random
import re

import numpy as np
import pytest

from stark_anatomy_tpu_torch.ops import _build
from stark_anatomy_tpu_torch.ops import field_torch as ft
from stark_anatomy_tpu_torch.ops.field import PRIME
from stark_anatomy_tpu_torch.ops.limbs import to_numpy, to_tensor

MASK = (1 << 32) - 1
R = 1 << 128
P3 = PRIME >> 96
EDGES = [0, 1, 2, PRIME - 2, PRIME - 1, PRIME, PRIME + 1, R - 1, R - PRIME, (1 << 32) - 1, 1 << 32,
         (1 << 64) - 1, 1 << 64, (1 << 96) - 1, 1 << 96, 1 << 127]


def _asm_blocks(function: str) -> list:
    """The statement lists [(opcode, [operands])] of the asm statements in
    the body of fp::`function`."""
    with open(os.path.join(_build.CSRC, "field.cuh")) as fh:
        src = fh.read()
    body = src[src.index(f"Fe {function}("):]
    body = body[: body.index("\n}\n")]
    blocks = []
    for text in body.split("asm(")[1:]:
        text = text[: text.index("\n      :")]
        statements = []
        for line in re.findall(r'"([^"]*)"', text):
            line = line.replace("\\n", "").replace("\\t", "").split("//")[0].strip().rstrip(";")
            if not line or line in "{}" or line.startswith(".reg"):
                continue
            opcode, rest = line.split(" ", 1)
            statements.append((opcode, [x.strip() for x in rest.split(",")]))
        blocks.append(statements)
    return blocks


def _run(statements: list, regs: dict) -> dict:
    """Interpret PTX integer statements on 32-bit registers with the carry
    flag CC.CF (a borrow for sub); a carry that a statement without .cc
    would drop is an error unless the statement is the last of a mod-2^128
    chain (add / addc into a result word)."""
    carry = 0

    def value(x):
        return int(x) if re.fullmatch(r"-?\d+", x) else regs[x]

    for opcode, args in statements:
        dest, v = args[0], [value(x) for x in args[1:]]
        op = opcode.replace(".u32", "").replace(".b32", "").replace(".s32", "")
        sets = op.endswith(".cc")
        base = op[:-3] if sets else op
        if base == "mov":
            out = v[0]
        elif base in ("mul.lo", "mul.hi"):
            out = (v[0] * v[1]) & MASK if base == "mul.lo" else (v[0] * v[1]) >> 32
        elif base in ("mad.lo", "madc.lo", "mad.hi", "madc.hi"):
            product = v[0] * v[1]
            part = product & MASK if base.endswith("lo") else product >> 32
            out = part + v[2] + (carry if base.startswith("madc") else 0)
            assert sets or out >> 32 == 0, f"{opcode} {args} drops a carry"
        elif base in ("add", "addc"):
            out = v[0] + v[1] + (carry if base == "addc" else 0)
        elif base in ("sub", "subc"):
            out = v[0] - v[1] - (carry if base == "subc" else 0)
        elif base == "or":
            out = v[0] | v[1]
        elif base == "and":
            out = v[0] & v[1]
        elif base == "min":
            out = min(v[0], v[1])
        elif base == "setp.lt":  # signed compare with zero
            assert v[1] == 0
            out = v[0] >> 31
        elif base == "selp":
            out = v[0] if v[2] else v[1]
        else:
            raise AssertionError(f"no model for {opcode}")
        if sets:
            carry = 1 if (out < 0 or out > MASK) else 0
        regs[dest] = out & MASK if base not in ("setp.lt",) else out
    return regs


def _words(x: int, count: int = 4) -> list:
    return [(x >> (32 * i)) & MASK for i in range(count)]


def _number(regs: dict, first: int, count: int) -> int:
    return sum(regs[f"%{first + i}"] << (32 * i) for i in range(count))


def asm_cond_sub_p(v: int, hi: int) -> int:
    (block,) = _asm_blocks("cond_sub_p")
    regs = {f"%{4 + i}": w for i, w in enumerate(_words(v))}
    regs.update({"%8": hi, "%9": P3})
    return _number(_run(block, regs), 0, 4)


def asm_add(a: int, b: int) -> int:
    (block,) = _asm_blocks("add")
    regs = _run(block, {f"%{5 + i}": w for i, w in enumerate(_words(a) + _words(b))})
    return asm_cond_sub_p(_number(regs, 0, 4), regs["%4"])


def asm_sub(a: int, b: int) -> int:
    (block,) = _asm_blocks("sub")
    regs = {f"%{4 + i}": w for i, w in enumerate(_words(a) + _words(b))}
    regs["%12"] = P3
    return _number(_run(block, regs), 0, 4)


def asm_mont_mul(a: int, b: int) -> int:
    product, reduce = _asm_blocks("mont_mul")
    regs = _run(product, {f"%{8 + i}": w for i, w in enumerate(_words(a) + _words(b))})
    t = _number(regs, 0, 8)
    assert t == a * b
    regs = {f"%{5 + i}": w for i, w in enumerate(_words(t, 8))}
    regs["%13"] = P3
    regs = _run(reduce, regs)
    value = _number(regs, 0, 5)
    m = (-a * b * pow(PRIME, -1, R)) % R
    assert value == (a * b + m * PRIME) >> 128  # the 129-bit REDC value
    return asm_cond_sub_p(value & (R - 1), value >> 128)


def _pairs(seed: int, count: int) -> list:
    rng = random.Random(seed)
    pairs = [(a, b) for a in EDGES for b in EDGES]
    for _ in range(count):
        a, b = rng.getrandbits(128), rng.getrandbits(128)
        if rng.random() < 0.2:
            a &= ~((1 << 96) - 1)  # low words zero: the reduction's carry is 0
        if rng.random() < 0.1:
            b = rng.choice(EDGES)
        pairs.append((a, b))
    return pairs


def test_the_source_has_the_chains_this_file_reads():
    assert [len(_asm_blocks(f)) for f in ("cond_sub_p", "add", "sub", "mont_mul")] == [1, 1, 1, 2]
    assert P3 == 0xCB800000 and PRIME == 1 + (P3 << 96)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_add_chain_is_one_conditional_subtract_of_p(seed):
    for a, b in _pairs(seed, 1500):
        s = a + b
        assert asm_add(a, b) == ((s - PRIME) % R if s >= PRIME else s), (hex(a), hex(b))


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_sub_chain_adds_p_back_on_a_borrow(seed):
    for a, b in _pairs(seed, 1500):
        assert asm_sub(a, b) == ((a - b) % R if a >= b else (a - b + PRIME) % R), (hex(a), hex(b))


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_mont_mul_chains_are_the_exact_redc_for_any_128_bit_operands(seed):
    r_inv = pow(R, -1, PRIME)
    for a, b in _pairs(seed, 400):
        got = asm_mont_mul(a, b)
        assert got % PRIME == (a * b * r_inv) % PRIME
        if a < PRIME and b < PRIME:
            assert got < PRIME


@pytest.mark.parametrize("name,chain,plain", [
    ("add", asm_add, ft.add), ("sub", asm_sub, ft.sub), ("mont_mul", asm_mont_mul, ft.mont_mul)])
def test_chains_equal_the_plain_versions_word_for_word(name, chain, plain):
    pairs = _pairs(10, 200)

    def planes(values):
        return to_tensor(np.array([_words(v) for v in values], dtype=np.uint32).T.copy(), "cpu")

    want = to_numpy(plain(planes([a for a, _ in pairs]), planes([b for _, b in pairs])))
    got = np.array([_words(chain(a, b)) for a, b in pairs], dtype=np.uint32).T
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,chain", [("add", asm_add), ("sub", asm_sub), ("mont_mul", asm_mont_mul)])
def test_chains_equal_the_jax_package_word_for_word(name, chain):
    import jax.numpy as jnp

    from stark_anatomy_tpu.ops import field_jnp
    from stark_anatomy_tpu_torch.reference import to_reference_limbs

    pairs = _pairs(11, 200)

    def digits(values):
        words = np.array([_words(v) for v in values], dtype=np.uint32).T.copy()
        return jnp.asarray(to_reference_limbs(to_tensor(words, "cpu")))

    want = np.asarray(getattr(field_jnp, name)(digits([a for a, _ in pairs]), digits([b for _, b in pairs])))
    got = np.asarray(digits([chain(a, b) for a, b in pairs]))
    np.testing.assert_array_equal(got, want)

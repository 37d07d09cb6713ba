#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a).

    python3 chip_smoke.py                 # every phase, needs one card
    python3 chip_smoke.py --phases env,build,kernels --verbose-build   # after a .cu edit
    python3 chip_smoke.py --phases env,build,kernels,mesh

Drives stark_anatomy_tpu_torch only (no JAX anywhere). Phases, each
printing one JSON line when it finishes; any failure raises and the process
exits non-zero:

  env      torch / CUDA / nvcc versions, the card's name and power limit
  build    compile csrc/*.cu into the package's _build/ directory
  kernels  every kernel against its plain PyTorch version on the card, at
           ragged and large sizes, exact equality (tolerance 0: all integer
           math); Blake2b also against hashlib
  golden   chain 1, F = 1024: proof bytes equal tests/golden/, verifies, a
           tampered proof is rejected
  mid      chain 125, F = 2^16: cuda and cpu provers give identical bytes
  airs     Fibonacci and MiMC through the same Stark at full width
           (1 048 481 rows, omicron domain 2^20): cold and warm prove,
           verify, a tampered proof and a wrong output rejected, launches per
           kernel; and a small run of each on cuda and on cpu, bytes identical
  resume   chain 125 with checkpoint_dir=: same bytes as without; a second
           prove resumes (no NTT launched); with the last two FRI snapshots
           deleted it resumes mid-FRI; another seed does not resume
  full     chain 32765, F = 2^24 (the main path at its real size): launch
           counts reset, cold prove, counts read; warm prove; verify; phase
           split; peak device memory
  cli      (needs full) the command-line prover, python3 -m
           stark_anatomy_tpu_torch.prove_rescue, each run a process of its
           own: the full phase's prove to its bytes; --profile production-80
           at chain 32763 (32 queries, 16 grinding bits, F = 2^24) to the
           bytes of the same prove in this process, one pow_nonce, a tampered
           copy rejected; a small production-80 prove with --device cuda and
           --device cpu to identical bytes; the seconds and phase split the
           CLI printed, the grinding time. Then clear_table_caches() here,
           which must free at least the 2^24-point twiddle tables, and the
           native host batch ops against FieldElement on 4096 values
  inv      field_kernels.inv alone at the prove's shape (2^24 elements): the
           launches of one call, device and host time, equal to field_torch.inv
  mesh     the mesh path on the one card (8 shards in a world of one
           process, no process group: the block-local prover, every
           exchange staying on the device): the sharded NTT in its
           three layouts for 2, 8, 128 and 256 shards (256: the column
           transforms one ntt_block a column), the sharded LDE and the
           sharded pair-leaf commit against their single-device versions, and
           chain 32765 through Stark(mesh=make_mesh(8)): the bytes of the
           full phase's proof, cold and warm beside a single-device prove;
           a small run on cuda and on cpu, bytes identical
  dist     the same sharded NTT through a one-process torch.distributed
           group (nccl): the exchange through all_to_all_single; then
           chain 32765 through Stark(mesh=make_mesh(8, group=...)), the
           block-local prover that W processes run, here with W = 1: the
           bytes of the full phase's proof, verifies, cold and warm prove,
           phase split, exchanges, launches, peak device memory
  big      the chunked big-domain prover (Stark._prove_big): chain 32765
           forced through it (_BIG_F_MIN = 1, _BIG_CHUNK = 2^22): the bytes of
           the full phase's proof, cold and warm prove beside full's, peak
           device memory, phase split, launches; then chain 524285
           (16 777 121 rows, O = 2^24, F = 2^28, the first F whose standard
           prove does not fit the 80 GB card) at its real size: the coset
           evaluation at F timed with its peak, then one prove, verify,
           bytes, phase split, launches, peak device memory, host trace
           seconds and host peak RSS; the excluded-row Horner of one chunk,
           its launches counted and its values held to the plain field ops.
           The kernel table holds every kernel at this prove's own shapes
           too (big_cases)
  tune     (only when named in --phases) the NTT passes timed over cuts of
           the stages, tile widths and block sizes

With "full" but without "kernels" in --phases (the F = 2^27 measurement,
``--phases env,build,full --chain 262141``) the script stops after the
proves, without the kernel table.

Then the kernel table (one JSON object: per kernel its launches on the main
path, error against the plain version, time at the main path's shape, the
plain version's time, and the least time the card could take), the card's
name and power limit, and the result line.

Bounds use the H100 SXM data sheet: 3.35e12 B/s of device memory, and for
32-bit integer operations the float32 issue rate outside the tensor cores
(67 TFLOP/s at 2 per FMA = 33.5e12 issue slots/s: integer multiply-adds
issue on the FMA pipe, adds and logic on the ALU pipe beside it). Operation
counts per unit of work are the ones stated in OPS_PER_UNIT below; they are
floors (what the arithmetic cannot do without), so the bound
stays a bound.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np
import torch

DEVICE_MEMORY_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
#: 32-bit integer operations per unit of work (element, butterfly or
#: 128-byte Blake2b block), counted from the arithmetic. add/sub: a 4-word
#: carry chain, a second one for the conditional +-p, 4 selects = 12.
#: mont_mul: 4 rounds of (4 wide multiply-adds of a*b[i], 1 for m*p's top
#: word, ~5 carry adds) = 40, plus the conditional subtract's 12, rounded
#: up to 60 for the negations and carries into the fifth word. A butterfly
#: is one product, one add, one sub = 84 (ntt_grouped: log2 g stages of n/2
#: butterflies). The unit of fp_pow_const and fp_batch_inv is one Montgomery
#: product, counted at the fewest known for the function: a^(p-2) takes
#: field_torch.INV_CHAIN_PRODUCTS (143) of them per element by the addition
#: chain (fp_pow_const's windows do field_kernels.pow_products(p - 2) = 169,
#: in the table beside the bound), and the batch inverse of n elements
#: 3 (n - 1) + 143 (Montgomery's trick and one chain; fp_batch_inv's design
#: does about 4.5 per element). Blake2b: a G is 6 64-bit adds,
#: 4 xors, and rotates by 24, 16 and 63 (the one by 32 is free) at 2
#: operations each = 26; 96 G per block = 2496. zk_coefficients, a
#: coefficient: 16 threefry2x32 blocks of 20 rounds (add, rotate, xor = 60),
#: 5 key injections (10), the counter and the output xor (~6): 16 x 76, then
#: 8 digit pairings, 2 conditional subtracts, one add and two products (8 +
#: 24 + 12 + 120) = 1380, rounded up to 1450 for the 64-bit counters.
#: trace_layout, an element: one Montgomery product by R^2 (60).
OPS_PER_UNIT = {
    "fp_add": 12, "fp_sub": 12, "fp_mont_mul": 60, "fp_butterfly": 84, "fp_pow_const": 60,
    "fp_batch_inv": 60, "ntt_block": 84, "ntt_stage": 84, "ntt_grouped": 84, "blake2b_planes": 2496,
    "zk_coefficients": 1450, "trace_layout": 60,
}
KERNEL_SOURCES = {
    "fp_add": ("stark_anatomy_tpu_torch/csrc/field.cu", "stark_anatomy_tpu/ops/field_pallas.py:140"),
    "fp_sub": ("stark_anatomy_tpu_torch/csrc/field.cu", "stark_anatomy_tpu/ops/field_pallas.py:144"),
    "fp_mont_mul": ("stark_anatomy_tpu_torch/csrc/field.cu", "stark_anatomy_tpu/ops/field_pallas.py:148"),
    "fp_butterfly": ("stark_anatomy_tpu_torch/csrc/field.cu", "stark_anatomy_tpu/ops/field_pallas.py:152"),
    "fp_pow_const": ("stark_anatomy_tpu_torch/csrc/field.cu", "stark_anatomy_tpu/ops/field_pallas.py:266"),
    "fp_batch_inv": ("stark_anatomy_tpu_torch/csrc/inv.cu", "stark_anatomy_tpu/ops/field_pallas.py:401"),
    "ntt_block": ("stark_anatomy_tpu_torch/csrc/ntt.cu", "stark_anatomy_tpu/ops/ntt_pallas.py:95"),
    "ntt_stage": ("stark_anatomy_tpu_torch/csrc/ntt.cu", "stark_anatomy_tpu/ops/ntt_pallas.py:128"),
    "ntt_grouped": ("stark_anatomy_tpu_torch/csrc/ntt.cu", "stark_anatomy_tpu/ops/ntt_pallas.py:242"),
    "blake2b_planes": ("stark_anatomy_tpu_torch/csrc/blake2b.cu", "stark_anatomy_tpu/ops/blake2b_pallas.py:68"),
    # not a Pallas kernel there: jax.random.bits and the field_jnp ops, fused by XLA
    "zk_coefficients": ("stark_anatomy_tpu_torch/csrc/zk.cu", "stark_anatomy_tpu/iop/stark.py:1443"),
    # not a Pallas kernel there: the trace's layout in numpy, then device_put
    "trace_layout": ("stark_anatomy_tpu_torch/csrc/trace_layout.cu", "stark_anatomy_tpu/iop/stark.py:1499"),
}
#: the kernels every Stark.prove launches. fp_butterfly (ntt_stage fuses the
#: same arithmetic in place) and fp_pow_const (inv's chain runs inside
#: fp_batch_inv) are on the ops surface only: a prove launches them no time
#: and the kernels phase and the table hold them against their plain versions.
PROVE_PATH_KERNELS = ("fp_add", "fp_sub", "fp_mont_mul", "fp_batch_inv", "ntt_block", "ntt_stage",
                      "blake2b_planes", "zk_coefficients", "trace_layout")
OPS_SURFACE_ONLY = ("fp_butterfly", "fp_pow_const")
#: most fp_mont_mul launches a cold Rescue-Prime prove at chain 32765 may make
#: (1234 while inv was scans of products; ~470 since it is fp_batch_inv)
MONT_MUL_MAX = 600
#: most fp_batch_inv launches one inv call may make (inv_plan: 5 up to 2^27,
#: 7 above)
INV_LAUNCHES_MAX = 8
#: launched by a prove on a mesh only (the column transforms of the four-step
#: NTT): no time by a single-device prove, at least once by a mesh prove
MESH_ONLY = ("ntt_grouped",)
#: shards of the mesh the mesh phase proves on, = the group size of ntt_grouped
#: in the kernel table
MESH_SHARDS = 8
#: steps of the Fibonacci and MiMC traces of the airs phase: 1 048 481 rows,
#: the omicron domain 2^20 that chain 32765 gives Rescue-Prime
AIR_STEPS = 1048480
#: chain of the cli phase's production-80 prove: 32 * 32763 + 1 + 4 * 32
#: randomizers = 1 048 545 <= 2^20, so O = 2^20 and F = 2^24
P80_CHAIN = 32763
#: chain of the big phase's real-size prove: 32 * 524285 + 1 = 16 777 121
#: rows, O = 2^24, F = 2^28
BIG_CHAIN = 524285
#: threefry key of the kernel table's zk draws (both words with the top bit set)
ZK_KEY = (0x89ABCDEF, 0xFEDCBA98)
GOLDEN = os.path.join(ROOT, "tests", "golden", "proof_rescue_chain1.json")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


# -- inputs ------------------------------------------------------------------


def edge_words(n: int, seed: int, canonical: bool = False) -> torch.Tensor:
    """(4, n) int32 CUDA planes: seeded random 128-bit values with the edge
    values 0, 1, p-1, p, 2^128-1 and limb-straddling ones up front."""
    from stark_anatomy_tpu_torch.ops.field import PRIME
    from stark_anatomy_tpu_torch.ops.limbs import random_felt_words, to_tensor

    rng = np.random.default_rng(seed)
    if canonical:
        words = random_felt_words(rng, n)
        edges = [0, 1, PRIME - 1, 2, (1 << 64) - 1, 1 << 64, (1 << 96) - 1, PRIME - 2]
    else:
        words = rng.integers(0, 1 << 32, size=(4, n), dtype=np.uint32)
        edges = [0, 1, PRIME - 1, PRIME, (1 << 128) - 1, (1 << 64) - 1, 1 << 64,
                 (1 << 96) - 1, 1 << 127, PRIME + 1]
    for i, e in enumerate(edges[: min(len(edges), n)]):
        words[:, i] = [(e >> (32 * j)) & 0xFFFFFFFF for j in range(4)]
    return to_tensor(words, "cuda")


def inv_input(n: int, seed: int) -> torch.Tensor:
    """Canonical (4, n) CUDA planes for inv: edge_words with zeros at both
    ends and in a run in the middle."""
    x = edge_words(n, seed, canonical=True)
    x[:, 0] = 0
    x[:, n - 1] = 0
    x[:, n // 2 : n // 2 + min(5, n // 3)] = 0
    return x


# -- phases ------------------------------------------------------------------


def phase_env() -> dict:
    from stark_anatomy_tpu_torch.ops import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True, capture_output=True, text=True)
    info = {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc.stdout.strip().splitlines()[-2:],
        "gpu": gpu_name_and_limit(),
        "device_name": torch.cuda.get_device_name(0),
    }
    emit("env", **info)
    return info


def phase_build(verbose: bool) -> None:
    from stark_anatomy_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load(verbose=verbose)
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=None if _build.build_seconds is None else round(_build.build_seconds, 3),
         sources=list(_build.SOURCES))


def phase_kernels(results: dict) -> None:
    """Each kernel's wrapper against its plain version on the card."""
    from stark_anatomy_tpu_torch.ops import _build
    from stark_anatomy_tpu_torch.ops import blake2b as b2
    from stark_anatomy_tpu_torch.ops import blake2b_kernels as bk
    from stark_anatomy_tpu_torch.ops import field_kernels as fk
    from stark_anatomy_tpu_torch.ops import field_torch as ft
    from stark_anatomy_tpu_torch.ops import ntt as nttmod
    from stark_anatomy_tpu_torch.ops import ntt_kernels
    from stark_anatomy_tpu_torch.ops.field import PRIME, finv
    from stark_anatomy_tpu_torch.ops.limbs import mont, to_tensor

    report = []

    def check(name: str, case: str, got: torch.Tensor, want: torch.Tensor) -> None:
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        ok = torch.equal(got, want)
        report.append({"kernel": name, "case": case, "equal": ok})
        for k in name.split("+"):
            results.setdefault(k, {"max_abs_err": 0})
            results[k]["max_abs_err"] = max(results[k]["max_abs_err"], err)
        if not ok:
            raise AssertionError(f"{name} [{case}] differs from its plain version (max abs err {err})")

    # field ops: any 128-bit input, ragged and large n, constant operands,
    # strided views and out=.
    for n in (1, 1000, 1 << 20):
        a, b = edge_words(n, 1), edge_words(n, 2).roll(3, dims=1)
        for kname, kfn, pfn in (("fp_add", fk.add, ft.add), ("fp_sub", fk.sub, ft.sub),
                                ("fp_mont_mul", fk.mont_mul, ft.mont_mul)):
            check(kname, f"n={n}", kfn(a, b), pfn(a, b))
            c = mont(123456789) if n > 1 else (1 << 128) - 1
            check(kname, f"n={n} const-b", kfn(a, c), pfn(a, c))
        check("fp_sub", f"n={n} const-a", fk.sub(mont(1), b), ft.sub(mont(1), b))
    big = edge_words(1 << 12, 3)
    half = big.shape[1] // 2
    out = torch.zeros_like(big)
    fk.mont_mul(big[:, :half], big[:, half:], out=out[:, half:])
    check("fp_mont_mul", "strided views + out=", out[:, half:],
          ft.mont_mul(big[:, :half].contiguous(), big[:, half:].contiguous()))

    # pow_const: any 128-bit input (p, p + 1, 2^128 - 1 among the edges),
    # exponents 0 and 1, the edges of the 4-bit windows (15, 16, 17), the
    # Fermat exponent, one of exactly 128 bits, all 128 bits set, seeded
    # random ones and one past the four words (walked in 64-bit windows); a
    # strided view; out=a.
    rng = np.random.default_rng(14)
    seeded = [int(v) for v in rng.integers(0, 1 << 62, size=3, dtype=np.int64)]
    for n in (1, 1000, 1 << 20):
        a = edge_words(n, 14)
        for e in (0, 1, 2, 15, 16, 17, 12345, PRIME - 2, 1 << 127, (1 << 128) - 1, seeded[0],
                  seeded[1] << 64 | seeded[2], (1 << 128) + 5):
            check("fp_pow_const", f"n={n} e={e:#x}", fk.pow_const(a, e), ft.pow_const(a, e))
    want = ft.pow_const(big[:, half:].contiguous(), 12345)
    check("fp_pow_const", "strided view", fk.pow_const(big[:, half:], 12345), want)
    alias = big[:, half:].clone()
    fk.pow_const(alias, 12345, out=alias)
    check("fp_pow_const", "out=a", alias, want)
    fk.pow_const(big[:, half:], (1 << 128) + 5, out=out[:, :half])
    check("fp_pow_const", "windows + out= view", out[:, :half],
          ft.pow_const(big[:, half:].contiguous(), (1 << 128) + 5))

    # inv: fp_batch_inv alone, 0 -> 0: one tile, several, three levels; all
    # zeros; zeros at both ends and in a run; a strided view.
    for n in (1, 1000, (1 << 16) + 3):
        a = inv_input(n, 4)
        want = ft.inv(a)
        check("fp_batch_inv", f"n={n}", fk.inv(a), want)
        zeros = torch.zeros_like(a)
        check("fp_batch_inv", f"n={n} all zero", fk.inv(zeros), zeros)
    wide = torch.cat([edge_words(a.shape[1], 10, canonical=True), a], dim=1)
    check("fp_batch_inv", "strided view", fk.inv(wide[:, a.shape[1]:]), want)

    # butterfly: tensor and by-value twiddle, outputs over the inputs.
    for n in (1, 1000, 1 << 20):
        ev, od, tw = edge_words(n, 15), edge_words(n, 16).roll(3, dims=1), edge_words(n, 17)
        for case, w in (("tensor tw", tw), ("const tw", mont(123456789) if n > 1 else (1 << 128) - 1)):
            want_hi, want_lo = ft.butterfly(ev, od, w)
            hi, lo = fk.butterfly(ev, od, w)
            check("fp_butterfly", f"n={n} {case} hi", hi, want_hi)
            check("fp_butterfly", f"n={n} {case} lo", lo, want_lo)
            e2, o2 = ev.clone(), od.clone()
            fk.butterfly(e2, o2, w, out=(e2, o2))
            check("fp_butterfly", f"n={n} {case} hi over even", e2, want_hi)
            check("fp_butterfly", f"n={n} {case} lo over odd", o2, want_lo)
    buf = big.clone()
    fk.butterfly(buf[:, :half], buf[:, half:], mont(5), out=(buf[:, :half], buf[:, half:]))
    want_hi, want_lo = ft.butterfly(big[:, :half].contiguous(), big[:, half:].contiguous(), mont(5))
    check("fp_butterfly", "strided views in place", buf, torch.cat([want_hi, want_lo], dim=1))

    # NTT: forward and inverse, below / at / above the block size; each
    # kernel against its own plain version, and the whole transform against
    # the constant-geometry plain transform.
    for n in (1 << 5, 1 << 10, 1 << 16, 1 << 20):
        x = edge_words(n, 5, canonical=True)
        log_n = n.bit_length() - 1
        log_block = min(ntt_kernels.LOG_BLOCK_MAX, log_n)
        for inverse in (False, True):
            tw = nttmod._twiddles(n, inverse, "cuda")
            scale = mont(finv(n)) if inverse else None
            case = f"n={n} inverse={inverse}"
            got = ntt_kernels.ntt_block(x, tw, log_block, scale)
            check("ntt_block", case, got, ntt_kernels.ntt_block_plain(x, tw, log_block, scale))
            for s in range(log_block + 1, log_n + 1):
                want = ntt_kernels.ntt_stage_plain(got, tw, s)
                check("ntt_stage", f"{case} s={s}", ntt_kernels.ntt_stage(got, tw, s), want)
            check("ntt_block+ntt_stage", case + " whole", ntt_kernels.transform(x, tw, scale),
                  ntt_kernels.transform_plain(x, tw, scale))

    # every size up to the main path's through pass_plan: ntt_block's pass,
    # each ntt_stage pass against the stage-by-stage plain version, the whole
    # against transform_plain; the scale on and off in both directions at a
    # few sizes. Above 2^20 both directions only at the sizes the proves
    # drive (2^22, 2^24): the plain versions take most of this phase's time.
    for log_n in range(1, 25):
        n = 1 << log_n
        x = edge_words(n, 30 + log_n, canonical=True)
        plan = ntt_kernels.pass_plan(log_n)
        for inverse in ((False,) if log_n in (21, 23) else (False, True)):
            tw = nttmod._twiddles(n, inverse, "cuda")
            scales = (None, mont(finv(n))) if log_n in (5, 13, 22) else \
                ((mont(finv(n)),) if inverse else (None,))
            for scale in scales:
                case = f"plan log_n={log_n} inverse={inverse} scale={scale is not None}"
                got = ntt_kernels.ntt_block(x, tw, plan[0][1], scale)
                check("ntt_block", case, got, ntt_kernels.ntt_block_plain(x, tw, plan[0][1], scale))
                for s, last in plan[1:]:
                    want = ntt_kernels.ntt_stages_plain(got, tw, s, last)
                    check("ntt_stage", f"{case} s={s}..{last}",
                          ntt_kernels.ntt_stage(got, tw, s, last), want)
                check("ntt_block+ntt_stage", case + " whole", ntt_kernels.transform(x, tw, scale),
                      ntt_kernels.transform_plain(x, tw, scale))
    torch.cuda.empty_cache()

    # cuts of the stages that are not the plan's
    for n, cuts in ((1 << 9, [[(1, 1), (2, 2), (3, 9)], [(1, 4), (5, 9)]]),
                    (1 << 16, [[(1, 3), (4, 5), (6, 6), (7, 16)], [(1, 10), (11, 16)], [(1, 6), (7, 16)]]),
                    (1 << 20, [[(1, 7), (8, 10), (11, 20)], [(1, 9), (10, 18), (19, 20)]])):
        x = edge_words(n, 8, canonical=True)
        for inverse in (False, True):
            tw = nttmod._twiddles(n, inverse, "cuda")
            scale = mont(finv(n)) if inverse else None
            whole = ntt_kernels.transform_plain(x, tw, scale)
            for cut in cuts:
                case = f"n={n} inverse={inverse} cut={cut}"
                got = ntt_kernels.ntt_block(x, tw, cut[0][1], scale)
                check("ntt_block", case, got, ntt_kernels.ntt_block_plain(x, tw, cut[0][1], scale))
                for s, last in cut[1:]:
                    want = ntt_kernels.ntt_stages_plain(got, tw, s, last)
                    check("ntt_stage", f"{case} s={s}..{last}",
                          ntt_kernels.ntt_stage(got, tw, s, last), want)
                check("ntt_block+ntt_stage", case + " whole", got, whole)

    # grouped NTT: n/g independent size-g transforms, natural order in and
    # out; the edge group sizes 2 and 128, ragged n (one group, three, a
    # block and a bit), any 128-bit input; forward and with the inverse's scale.
    for g in (2, 4, 8, 16, 128):
        for n in (g, 3 * g, 1024 + 5 * g, 1 << 20):
            x = edge_words(n, 18 + g)
            for inverse in (False, True):
                tw = nttmod._twiddles(g, inverse, "cuda")
                scale = mont(finv(g)) if inverse else None
                check("ntt_grouped", f"g={g} n={n} inverse={inverse}",
                      ntt_kernels.ntt_grouped(x, tw, g, scale),
                      ntt_kernels.ntt_grouped_plain(x, tw, g, scale))
    x = edge_words(1 << 12, 19, canonical=True)
    check("ntt_grouped", "against ntt of every group",
          nttmod.grouped_ntt(x, 128),
          torch.cat([nttmod.ntt(x[:, i : i + 128].contiguous()) for i in range(0, 1 << 12, 128)], dim=1))

    # Blake2b: leaf and node lengths, ragged and large n; hashlib on a sample.
    for msg_len in (32, 64, 128, 192):
        for n in (1000, 1 << 20):
            rng = np.random.default_rng(msg_len + n)
            planes = rng.integers(0, 1 << 32, size=((msg_len + 3) // 4, n), dtype=np.uint32)
            msg = to_tensor(planes, "cuda")
            got = bk.blake2b_planes(msg, msg_len)
            check("blake2b_planes", f"len={msg_len} n={n}", got, b2.blake2b_planes_plain(msg, msg_len))
            sample = b2.digests_to_bytes(got[:, :64].cpu().numpy())
            raw = np.ascontiguousarray(planes[:, :64].T).astype("<u4").view(np.uint8)
            for i in range(64):
                if sample[i] != hashlib.blake2b(raw[i].tobytes(), digest_size=64).digest():
                    raise AssertionError(f"blake2b_planes len={msg_len} disagrees with hashlib")
    # a quick time of each kernel at n = 2^20 (the table after the full
    # phase times them at the main path's shapes)
    n = 1 << 20
    a, b = edge_words(n, 6), edge_words(n, 7)
    c = inv_input(n, 8)
    tw = nttmod._twiddles(n, False, "cuda")
    tw_g = nttmod._twiddles(MESH_SHARDS, False, "cuda")
    msg = torch.cat([a, b, a, b])
    ms = {
        "fp_add": time_ms(lambda: fk.add(a, b)),
        "fp_sub": time_ms(lambda: fk.sub(a, b)),
        "fp_mont_mul": time_ms(lambda: fk.mont_mul(a, b)),
        "fp_butterfly": time_ms(lambda: fk.butterfly(a, b, b)),
        "fp_pow_const": time_ms(lambda: fk.pow_const(a, PRIME - 2)),
        "fp_batch_inv": time_ms(lambda: fk.inv(c)),
        "ntt_block": time_ms(lambda: ntt_kernels.ntt_block(a, tw, ntt_kernels.LOG_BLOCK_MAX)),
        "ntt_stage": time_ms(lambda: ntt_kernels.ntt_stage(b, tw, 11, 20)),
        "ntt_grouped": time_ms(lambda: ntt_kernels.ntt_grouped(a, tw_g, MESH_SHARDS)),
        "blake2b_planes": time_ms(lambda: bk.blake2b_planes(msg, 64)),
    }
    counts = _build.launch_counts()
    emit("kernels", cases=len(report), all_equal=all(r["equal"] for r in report),
         kernels=[{"name": k, "equal": all(r["equal"] for r in report if k in r["kernel"].split("+")),
                   "ms_at_n_2e20": round(ms[k], 4), "launches": counts[k]} for k in sorted(ms)])


def rescue_setup(chain: int, checks: int, device: str):
    from stark_anatomy_tpu_torch.iop.stark import Stark
    from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir

    rp = RescuePrime()
    air = RescuePrimeAir(rp, chain_length=chain)
    return rp, air, Stark(air, expansion_factor=4, num_colinearity_checks=checks, device=device)


def tamper_leaf(proof: bytes) -> bytes:
    """The proof with one opened boundary-quotient value changed."""
    from stark_anatomy_tpu_torch.ops.field import PRIME

    items = json.loads(proof)
    for item in items:
        if "bq_leaves" in item:
            leaf = item["bq_leaves"][0][1]
            leaf[0] = str((int(leaf[0]) + 1) % PRIME)
    out = json.dumps(items, separators=(",", ":")).encode()
    if out == proof:
        raise AssertionError("tampering changed nothing")
    return out


def phase_golden() -> None:
    """Chain 1, F = 1024 on the card: the checked-in proof bytes."""
    with open(GOLDEN, "rb") as fh:
        golden = fh.read()
    rp, air, stark = rescue_setup(1, 2, "cuda")
    boundary = air.boundary_constraints(rp.hash(20260817))
    proof = stark.prove(rp.trace(20260817), boundary, randomizer_seed=b"golden-v1")
    if proof != golden:
        raise AssertionError("the card's proof differs from tests/golden/proof_rescue_chain1.json")
    if not stark.verify(proof, boundary):
        raise AssertionError("golden proof does not verify")
    if stark.verify(tamper_leaf(proof), boundary):
        raise AssertionError("a tampered proof verified")
    emit("golden", bytes=len(proof), equal_golden=True, verifies=True, tampered_rejected=True)


def phase_mid() -> None:
    """Chain 125, F = 2^16: device FRI rounds; cuda and cpu bytes agree."""
    from stark_anatomy_tpu_torch.ops import _build

    proofs = {}
    for device in ("cuda", "cpu"):
        rp, air, stark = rescue_setup(125, 16, device)
        trace = rp.trace_bytes(7, 125)
        boundary = air.boundary_constraints(int.from_bytes(trace[-1, 0].tobytes(), "little"))
        t0 = time.perf_counter()
        before = _build.launch_counts()
        proofs[device] = stark.prove(trace, boundary, randomizer_seed=b"mid-v1")
        after = _build.launch_counts()
        launched = sum(after.values()) - sum(before.values())
        if (device == "cpu") != (launched == 0):
            raise AssertionError(f"device={device} launched {launched} kernels")
        seconds = time.perf_counter() - t0
        if not stark.verify(proofs[device], boundary):
            raise AssertionError(f"mid proof from {device} does not verify")
        proofs[device + "_s"] = round(seconds, 3)
    if proofs["cuda"] != proofs["cpu"]:
        raise AssertionError("cuda and cpu provers disagree at F = 2^16")
    emit("mid", fri_domain=stark.fri_domain_length, bytes=len(proofs["cuda"]), identical=True,
         cuda_prove_s=proofs["cuda_s"], cpu_prove_s=proofs["cpu_s"])


def air_setup(name: str, num_steps: int, device: str):
    """(stark, byte trace, output) of a Fibonacci or MiMC AIR, default profile;
    the trace is built on the host."""
    from stark_anatomy_tpu_torch.iop.stark import Stark
    from stark_anatomy_tpu_torch.models.fibonacci import FibonacciAir
    from stark_anatomy_tpu_torch.models.mimc import MiMCAir

    if name == "fibonacci":
        air = FibonacciAir(num_steps=num_steps)
        trace = air.trace_bytes()
    else:
        air = MiMCAir(num_steps=num_steps)
        trace = air.trace_bytes(20260817)
    stark = Stark(air, expansion_factor=4, num_colinearity_checks=16, device=device)
    return stark, trace, int.from_bytes(trace[-1, 0].tobytes(), "little")


def require_prove_path(launches: dict, what: str, mesh: bool = False) -> None:
    """Fail unless every kernel of the prove path was launched in `launches`
    and the ops-surface-only ones were not; the mesh-only ones must have been
    launched by a prove on a mesh and by no other."""
    path = PROVE_PATH_KERNELS + (MESH_ONLY if mesh else ())
    missing = [k for k in path if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what} never launched: {missing}")
    stray = [k for k in OPS_SURFACE_ONLY + (() if mesh else MESH_ONLY) if launches[k] != 0]
    if stray:
        raise AssertionError(f"{what} launched kernels that are not on its path: {stray}")
    # a transform is one ntt_block and at most two ntt_stage passes (up to 2^30)
    if launches["ntt_stage"] > 2 * launches["ntt_block"]:
        raise AssertionError(f"{what} launched ntt_stage {launches['ntt_stage']} times for "
                             f"{launches['ntt_block']} transforms")
    unknown = sorted(set(launches) - set(PROVE_PATH_KERNELS) - set(OPS_SURFACE_ONLY) - set(MESH_ONLY))
    if unknown:
        raise AssertionError(f"kernels neither on the prove path nor named ops-surface-only: {unknown}")


def phase_airs(num_steps: int = AIR_STEPS) -> dict:
    """Fibonacci (2 registers, degree 1, no constants) and MiMC (1 register,
    degree 3, one periodic column) through the same Stark at full width."""
    from stark_anatomy_tpu_torch.ops import _build
    from stark_anatomy_tpu_torch.ops import ntt as nttmod
    from stark_anatomy_tpu_torch.ops.field import PRIME
    from stark_anatomy_tpu_torch.utils import telemetry

    out = {}
    for name in ("fibonacci", "mimc"):
        t0 = time.perf_counter()
        stark, trace, output = air_setup(name, num_steps, "cuda")
        trace_s = time.perf_counter() - t0
        boundary = stark.air.boundary_constraints(output)

        def prove() -> tuple:
            torch.cuda.synchronize()
            t = time.perf_counter()
            proof = stark.prove(trace, boundary, randomizer_seed=b"airs-v1")
            torch.cuda.synchronize()
            return proof, time.perf_counter() - t

        nttmod.clear_twiddle_cache()  # cold = no twiddle table cached
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        cold, cold_s = prove()
        launches = _build.launch_counts()
        require_prove_path(launches, f"the {name} prove")
        t0 = time.perf_counter()
        accepted = stark.verify(cold, boundary)
        verify_s = time.perf_counter() - t0
        if not accepted:
            raise AssertionError(f"the full-width {name} proof does not verify")
        if stark.verify(tamper_leaf(cold), boundary):
            raise AssertionError(f"a tampered {name} proof verified")
        if stark.verify(cold, stark.air.boundary_constraints((output + 1) % PRIME)):
            raise AssertionError(f"a {name} proof verified against a wrong output")
        telemetry.reset()
        warm, warm_s = prove()
        if warm != cold:
            raise AssertionError(f"two {name} proves with one seed differ")
        split = {k: round(v["seconds"], 4) for k, v in telemetry.report().items()}
        out[name] = dict(
            rows=stark.trace_length, registers=stark.num_registers,
            omicron_domain=stark.omicron_domain_length,
            fri_domain=stark.fri_domain_length, host_trace_s=round(trace_s, 3),
            cold_prove_s=round(cold_s, 3), warm_prove_s=round(warm_s, 3),
            verify_s=round(verify_s, 3), verifies=True, tampered_rejected=True,
            wrong_output_rejected=True, proof_bytes=len(cold), launches=launches,
            phase_split_warm_s=split, peak_device_bytes=torch.cuda.max_memory_allocated(),
        )
        del stark, trace
        # a small run of the same AIR (F = 2^12) on both devices, one seed
        small = {}
        for device in ("cuda", "cpu"):
            stark, trace, output = air_setup(name, 900 if name == "fibonacci" else 180, device)
            boundary = stark.air.boundary_constraints(output)
            small[device] = stark.prove(trace, boundary, randomizer_seed=b"airs-small")
            if not stark.verify(small[device], boundary):
                raise AssertionError(f"small {name} proof from {device} does not verify")
        if small["cuda"] != small["cpu"]:
            raise AssertionError(f"cuda and cpu provers disagree on the small {name} run")
        out[name]["small_fri_domain"] = stark.fri_domain_length
        out[name]["small_cuda_cpu_identical"] = True
    emit("airs", **out)
    return out


def phase_resume() -> None:
    """Checkpoint/resume at chain 125 (F = 2^16), on the card."""
    import glob
    import tempfile

    from stark_anatomy_tpu_torch.ops import _build

    rp, air, stark = rescue_setup(125, 16, "cuda")
    trace = rp.trace_bytes(7, 125)
    boundary = air.boundary_constraints(int.from_bytes(trace[-1, 0].tobytes(), "little"))
    plain = stark.prove(trace, boundary, randomizer_seed=b"resume-v1")
    rounds = stark.fri.num_rounds

    def prove(seed: bytes, directory: str) -> tuple:
        _build.reset_launch_counts()
        proof = stark.prove(trace, boundary, randomizer_seed=seed, checkpoint_dir=directory)
        return proof, _build.launch_counts()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as d:
        first, counts = prove(b"resume-v1", d)
        if first != plain:
            raise AssertionError("a prove with checkpoint_dir= differs from one without")
        if counts["ntt_block"] == 0:
            raise AssertionError("the first prove on an empty directory launched no NTT")
        snaps = sorted(glob.glob(os.path.join(d, "stark-fri-r*.npz")))
        if len(snaps) != rounds or not os.path.exists(os.path.join(d, "stark-pre-fri.npz")):
            raise AssertionError(f"expected a pre-FRI snapshot and {rounds} FRI ones, found {snaps}")
        second, counts = prove(b"resume-v1", d)
        if second != plain or counts["ntt_block"] != 0:
            raise AssertionError(f"the second prove did not resume to the same bytes: {counts}")
        resumed_launches = dict(counts)
        for r in (rounds - 1, rounds - 2):
            for ext in ("npz", "json"):
                os.remove(os.path.join(d, f"stark-fri-r{r}.{ext}"))
        third, counts = prove(b"resume-v1", d)
        if third != plain or counts["ntt_block"] != 0:
            raise AssertionError(f"the mid-FRI resume did not give the same bytes: {counts}")
        other, counts = prove(b"resume-v2", d)
        if other == plain or counts["ntt_block"] == 0 or not stark.verify(other, boundary):
            raise AssertionError("another seed on the same directory resumed a stale snapshot")
    emit("resume", fri_domain=stark.fri_domain_length, fri_rounds=rounds, bytes=len(plain),
         checkpointed_equals_plain=True, resumed_identical=True, mid_fri_resumed_identical=True,
         other_seed_recomputed=True, launches_of_full_resume=resumed_launches)


def phase_full(chain: int) -> tuple:
    """The main path at its real size: Rescue-Prime chain, default profile,
    trace from the native generator; prove (cold, then warm) and verify.
    Returns what it emitted and (trace, boundary, proof) for the mesh phase."""
    from stark_anatomy_tpu_torch import native
    from stark_anatomy_tpu_torch.ops import _build
    from stark_anatomy_tpu_torch.ops import ntt as nttmod
    from stark_anatomy_tpu_torch.utils import telemetry

    rp, air, stark = rescue_setup(chain, 16, "cuda")
    t0 = time.perf_counter()
    trace = rp.trace_bytes(11, chain)
    trace_s = time.perf_counter() - t0
    boundary = air.boundary_constraints(int.from_bytes(trace[-1, 0].tobytes(), "little"))

    def prove() -> tuple:
        torch.cuda.synchronize()
        t = time.perf_counter()
        proof = stark.prove(trace, boundary, randomizer_seed=b"full-v1")
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t

    nttmod.clear_twiddle_cache()  # cold = no twiddle table cached
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    cold, cold_s = prove()
    launches = _build.launch_counts()
    t0 = time.perf_counter()
    accepted = stark.verify(cold, boundary)
    verify_s = time.perf_counter() - t0
    if not accepted:
        raise AssertionError("the full-size proof does not verify")
    require_prove_path(launches, "the main path")
    if launches["fp_mont_mul"] > MONT_MUL_MAX or launches["fp_batch_inv"] > INV_LAUNCHES_MAX:
        raise AssertionError(f"the main path launched fp_mont_mul {launches['fp_mont_mul']} times "
                             f"(at most {MONT_MUL_MAX}) and fp_batch_inv {launches['fp_batch_inv']} "
                             f"times (at most {INV_LAUNCHES_MAX})")
    if stark.verify(tamper_leaf(cold), boundary):
        raise AssertionError("a tampered full-size proof verified")

    telemetry.reset()
    warm, warm_s = prove()
    if warm != cold:
        raise AssertionError("two proves with one seed differ")
    split = {k: round(v["seconds"], 4) for k, v in telemetry.report().items()}
    info = dict(
        chain=chain, rows=stark.trace_length, registers=stark.num_registers,
        omicron_domain=stark.omicron_domain_length,
        fri_domain=stark.fri_domain_length, native_trace=native.available(),
        trace_s=round(trace_s, 3), cold_prove_s=round(cold_s, 3), warm_prove_s=round(warm_s, 3),
        verify_s=round(verify_s, 3), verifies=True, tampered_rejected=True,
        proof_bytes=len(cold), launches=launches, phase_split_warm_s=split,
        peak_device_bytes=torch.cuda.max_memory_allocated(),
    )
    emit("full", **info)
    return info, (trace, boundary, cold)


def run_cli(argv: list) -> tuple:
    """The command-line prover in a process of its own, from the repo root
    (the kernels are already built): (stdout, wall seconds). Fails unless it
    exits 0 and prints ACCEPT."""
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "stark_anatomy_tpu_torch.prove_rescue", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if done.returncode != 0 or "ACCEPT" not in done.stdout:
        raise AssertionError(f"prove_rescue {' '.join(argv)} exited {done.returncode}:\n"
                             f"{done.stdout[-2000:]}\n{done.stderr[-4000:]}")
    return done.stdout, wall


def cli_numbers(stdout: str) -> dict:
    """The seconds and bytes the CLI printed, and its phase split."""
    import re

    def one(pattern: str) -> str:
        found = re.search(pattern, stdout, re.M)
        if found is None:
            raise AssertionError(f"the CLI printed no line matching {pattern!r}")
        return found.group(1)

    return dict(
        trace_s=float(one(r"^trace generated in ([0-9.]+)s")),
        prove_s=float(one(r"^proved in ([0-9.]+)s")),
        proof_bytes=int(one(r"; proof = (\d+) bytes$")),
        verify_s=float(one(r"^verified in ([0-9.]+)s")),
        split_s={k: float(v) for k, v in re.findall(r"^  (\S+): ([0-9.]+)s(?: host, [0-9.]+s device)?$",
                                                     stdout, re.M)},
    )


def check_native_batch_ops() -> None:
    """native.available(), and the six host batch ops equal to FieldElement
    on 4096 seeded values with 0, 1 and p - 1 among them."""
    from stark_anatomy_tpu_torch import FieldElement, PRIME, native

    n = 4096
    if not native.available():
        raise AssertionError("the native host library did not build or load")
    rng = np.random.default_rng(80)
    a = [0, 1, PRIME - 1] + [int.from_bytes(rng.bytes(16), "little") % PRIME for _ in range(n - 3)]
    b = a[::-1]
    fa, fb = [FieldElement(x) for x in a], [FieldElement(x) for x in b]
    for name, got, want in (
        ("add_batch", native.add_batch(a, b), [(x + y).value for x, y in zip(fa, fb)]),
        ("sub_batch", native.sub_batch(a, b), [(x - y).value for x, y in zip(fa, fb)]),
        ("mul_batch", native.mul_batch(a, b), [(x * y).value for x, y in zip(fa, fb)]),
        ("inv_batch", native.inv_batch(a), [x.inverse().value if x.value else 0 for x in fa]),
        *((f"pow_batch e={e}", native.pow_batch(a, e), [x.pow(e).value for x in fa])
          for e in (0, 1, PRIME - 2, (1 << 128) - 1)),
    ):
        if got != want:
            raise AssertionError(f"native.{name} differs from FieldElement")
    g, acc, want = FieldElement(a[5]), FieldElement(1), []
    for _ in range(n):
        want.append(acc.value)
        acc = acc * g
    if native.powers(g.value, n) != want:
        raise AssertionError("native.powers differs from FieldElement")


def phase_cli(chain: int, full_proof: bytes) -> dict:
    """The command-line prover (python3 -m stark_anatomy_tpu_torch.prove_rescue)
    on the card, each run a process of its own: (a) the full phase's prove,
    to its bytes; (b) the production-80 profile at chain P80_CHAIN (F = 2^24),
    to the bytes of the same prove in this process, one pow_nonce, a tampered
    copy rejected; (c) a small production-80 prove with --device cuda and
    --device cpu, to identical bytes; (d) clear_table_caches() in this
    process, which must free at least the F-point twiddle tables; (e) the
    native host batch ops against FieldElement."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from stark_anatomy_tpu_torch import clear_table_caches
    from stark_anatomy_tpu_torch.iop.stark import Stark
    from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir
    from stark_anatomy_tpu_torch.ops import ntt as nttmod

    torch.cuda.empty_cache()  # leave the card's memory to the CLI's processes
    info: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as d:
        def prove(name: str, argv: list) -> bytes:
            path = os.path.join(d, name + ".bin")
            stdout, wall = run_cli([*argv, "--out", path])
            info[name] = dict(wall_s=round(wall, 3), **cli_numbers(stdout))
            with open(path, "rb") as fh:
                return fh.read()

        # (a) the main path through the CLI
        default = prove("default", ["--input", "11", "--chain", str(chain), "--checks", "16",
                                    "--seed", "full-v1"])
        if default != full_proof:
            raise AssertionError("the CLI's proof differs from the full phase's")
        # (b) production-80 at F = 2^24, against the same prove in this process
        p80 = prove("production_80", ["--input", "11", "--profile", "production-80",
                                      "--chain", str(P80_CHAIN), "--seed", "cli-p80"])
        rp = RescuePrime()
        air = RescuePrimeAir(rp, chain_length=P80_CHAIN)
        stark = Stark.from_profile("production-80", air, device="cuda")
        if stark.fri_domain_length != 1 << 24:
            raise AssertionError(f"production-80 at chain {P80_CHAIN}: F = {stark.fri_domain_length}")
        trace = rp.trace_bytes(11, P80_CHAIN)
        boundary = air.boundary_constraints(int.from_bytes(trace[-1, 0].tobytes(), "little"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        here = stark.prove(trace, boundary, randomizer_seed=b"cli-p80")
        torch.cuda.synchronize()
        info["production_80"]["in_process_prove_s"] = round(time.perf_counter() - t0, 3)
        if here != p80:
            raise AssertionError("the CLI's production-80 proof differs from Stark.from_profile's")
        nonces = [next(iter(item)) for item in json.loads(p80)].count("pow_nonce")
        if nonces != 1:
            raise AssertionError(f"the production-80 proof holds {nonces} pow_nonce items")
        if stark.verify(tamper_leaf(p80), boundary):
            raise AssertionError("a tampered production-80 proof verified")
        del stark, trace
        # (c) a small production-80 prove on both devices, the two processes together
        with ThreadPoolExecutor(2) as pool:
            small = {dev: pool.submit(prove, f"small_{dev}", [
                "--input", "5", "--profile", "production-80", "--chain", "3", "--seed", "cli-small",
                "--device", dev]) for dev in ("cuda", "cpu")}
            small = {dev: future.result() for dev, future in small.items()}
        if small["cuda"] != small["cpu"]:
            raise AssertionError("the CLI's small production-80 proofs differ between cuda and cpu")
    # (d) the caches of this process, after full and the in-process prove of (b)
    f_tables = sum(t.numel() * t.element_size() for (n, _inv, dev), t in nttmod._TWIDDLE_CACHE.items()
                   if n == 1 << 24 and dev.startswith("cuda"))
    if f_tables == 0:
        raise AssertionError("no 2^24-point twiddle table was cached before clear_table_caches()")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    clear_table_caches()
    drop = before - torch.cuda.memory_allocated()
    if drop < f_tables:
        raise AssertionError(f"clear_table_caches() freed {drop} B, less than the {f_tables} B "
                             "of the 2^24-point twiddle tables")
    # (e) the native host batch ops
    check_native_batch_ops()
    split80 = info["production_80"]["split_s"]
    fri_default = info["default"]["split_s"].get("prove.fri")
    out = dict(
        **info, p80_chain=P80_CHAIN, p80_proof_bytes=len(p80), p80_pow_nonces=nonces,
        p80_equals_in_process=True, p80_tampered_rejected=True, default_equals_full=True,
        small_cuda_cpu_identical=True, small_bytes=len(small["cuda"]),
        grind_s=split80.get("prove.fri.grind"),
        grind_share_of_prove=split80.get("prove.fri.grind", 0.0) / info["production_80"]["prove_s"],
        fri_s_p80_over_default=(split80.get("prove.fri", 0.0) / fri_default) if fri_default else None,
        twiddle_bytes_f=f_tables, memory_drop_bytes=drop, native_available=True,
        native_batch_ops_equal=True,
    )
    emit("cli", **out)
    return out


def phase_inv(log_n: int = 24) -> dict:
    """field_kernels.inv alone at the prove's shape (n = F = 2^24): the
    launches of one call, device time (CUDA events) and host wall time with a
    synchronise on both sides, and the result held to field_torch.inv. The
    phase prints its line before it checks the launches, so that it also
    times an inv that takes another route (an earlier version of the package)."""
    from stark_anatomy_tpu_torch.ops import _build
    from stark_anatomy_tpu_torch.ops import field_kernels as fk
    from stark_anatomy_tpu_torch.ops import field_torch as ft

    n = 1 << log_n
    x = inv_input(n, 25)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    y = fk.inv(x)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.launch_counts().items() if v}
    equal = torch.equal(y, ft.inv(x))
    del y
    ms = time_ms(lambda: fk.inv(x), reps=10)
    host_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fk.inv(x)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    info = dict(n=n, launches_one_call=launches, ms=ms, host_ms=host_ms, equal=equal)
    emit("inv", **info)
    if not equal:
        raise AssertionError(f"inv at n = {n} differs from field_torch.inv")
    if set(launches) != {"fp_batch_inv"} or launches["fp_batch_inv"] > INV_LAUNCHES_MAX:
        raise AssertionError(f"one inv call at n = {n} launched {launches}: expected fp_batch_inv "
                             f"alone, at most {INV_LAUNCHES_MAX} times")
    return info


def check_sharded_ntt(mesh, x: torch.Tensor, what: str) -> int:
    """sharded_ntt on `mesh` in its three layout pairs, both directions,
    against ntt / intt (tolerance 0), with the exchanges of each counted
    (3 / 2 / 2). Returns the number of transforms compared."""
    from stark_anatomy_tpu_torch.ops import ntt as nttmod
    from stark_anatomy_tpu_torch.ops.limbs import to_numpy, to_tensor
    from stark_anatomy_tpu_torch.parallel import CYCLIC, NATURAL, sharded_ntt
    from stark_anatomy_tpu_torch.reference import cyclic_to_natural, natural_to_cyclic

    s = mesh.shards
    x_cyclic = to_tensor(natural_to_cyclic(to_numpy(x), s), "cuda")
    done = 0
    for inverse in (False, True):
        want = nttmod.intt(x) if inverse else nttmod.ntt(x)
        for lin, lout, exchanges in ((NATURAL, NATURAL, 3), (NATURAL, CYCLIC, 2), (CYCLIC, NATURAL, 2)):
            given = x_cyclic if lin == CYCLIC else x
            before = mesh.exchanges
            got = sharded_ntt(given, mesh, inverse, layout_in=lin, layout_out=lout)
            torch.cuda.synchronize()
            if mesh.exchanges - before != exchanges:
                raise AssertionError(f"{what} S={s} {lin}->{lout}: {mesh.exchanges - before} "
                                     f"exchanges, expected {exchanges}")
            if lout == CYCLIC:
                got = to_tensor(cyclic_to_natural(to_numpy(got), s), "cuda")
            if not torch.equal(got, want):
                raise AssertionError(f"{what} S={s} {lin}->{lout} inverse={inverse} differs from "
                                     "the single-device transform")
            done += 1
    return done


def full_inputs(chain: int, full_run: tuple | None) -> tuple:
    """(trace, boundary, proof) of the full phase, or made here the same way
    when that phase did not run."""
    if full_run is not None:
        return full_run
    rp, air, single = rescue_setup(chain, 16, "cuda")
    trace = rp.trace_bytes(11, chain)
    boundary = air.boundary_constraints(int.from_bytes(trace[-1, 0].tobytes(), "little"))
    return trace, boundary, single.prove(trace, boundary, randomizer_seed=b"full-v1")


def phase_mesh(chain: int = 32765, full_run: tuple | None = None, log_n: int = 20,
               shard_counts: tuple = (2, 8, 128, 256)) -> dict:
    """The mesh path on the one card: MESH_SHARDS shards in a world of one
    process, made without a process group."""
    from stark_anatomy_tpu_torch.iop.merkle import commit_columns
    from stark_anatomy_tpu_torch.iop.stark import Stark
    from stark_anatomy_tpu_torch.ops import _build
    from stark_anatomy_tpu_torch.ops import ntt as nttmod
    from stark_anatomy_tpu_torch.ops.field import GENERATOR
    from stark_anatomy_tpu_torch.parallel import commit_sharded, make_mesh, sharded_lde
    from stark_anatomy_tpu_torch.utils import telemetry

    n = 1 << log_n
    # (a) the sharded NTT against ntt / intt
    x = edge_words(n, 21, canonical=True)
    transforms = sum(check_sharded_ntt(make_mesh(s), x, "sharded_ntt") for s in shard_counts)

    # (b) the sharded LDE of one column, n -> 16 n, against intt + coset_evaluate
    mesh = make_mesh(MESH_SHARDS)
    lde_len = 16 * n
    got = sharded_lde(x, lde_len, GENERATOR, mesh)
    want = nttmod.coset_evaluate(nttmod.intt(x), lde_len, GENERATOR)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("sharded_lde differs from intt + coset_evaluate")
    del got, want
    lde_ms = time_ms(lambda: sharded_lde(x, lde_len, GENERATOR, mesh), reps=3)
    single_lde_ms = time_ms(lambda: nttmod.coset_evaluate(nttmod.intt(x), lde_len, GENERATOR), reps=3)

    # (c) the sharded pair-leaf commit of two columns of the LDE's length
    cols = [edge_words(lde_len, 22, canonical=True), edge_words(lde_len, 23, canonical=True)]
    tree, ref = commit_sharded(cols, mesh, pair=True), commit_columns(cols, pair=True)
    opened = (0, lde_len // 4 + 1, lde_len // 2 - 1)
    if tree.root != ref.root or any(tree.open(i) != ref.open(i) for i in opened) \
            or tree.open_multi(opened) != ref.open_multi(opened):
        raise AssertionError("commit_sharded differs from commit_columns")
    commit_ms = time_ms(lambda: commit_sharded(cols, mesh, pair=True), reps=3)
    single_commit_ms = time_ms(lambda: commit_columns(cols, pair=True), reps=3)
    del cols, tree, ref, x
    torch.cuda.empty_cache()

    # (d) the path at full width: Stark on the mesh, the full phase's inputs
    rp, air, single = rescue_setup(chain, 16, "cuda")
    trace, boundary, want_proof = full_inputs(chain, full_run)
    sharded = Stark(air, expansion_factor=4, num_colinearity_checks=16, mesh=mesh)

    def prove(stark) -> tuple:
        torch.cuda.synchronize()
        t = time.perf_counter()
        proof = stark.prove(trace, boundary, randomizer_seed=b"full-v1")
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t

    nttmod.clear_twiddle_cache()  # cold = no twiddle or cross table cached
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    exchanges = mesh.exchanges
    cold, cold_s = prove(sharded)
    launches = _build.launch_counts()
    exchanges = mesh.exchanges - exchanges
    peak = torch.cuda.max_memory_allocated()
    require_prove_path(launches, "the mesh prove", mesh=True)
    if launches["ntt_grouped"] < 2 * single.num_registers:
        raise AssertionError(f"the mesh prove launched ntt_grouped {launches['ntt_grouped']} times")
    if cold != want_proof:
        raise AssertionError("the mesh prove's bytes differ from the single-device proof")
    if not sharded.verify(cold, boundary):
        raise AssertionError("the mesh proof does not verify")
    # warm, in turns with the single-device prover: single, mesh, mesh, single
    _, _ = prove(single)
    _build.reset_launch_counts()
    _, single_a = prove(single)
    require_prove_path(_build.launch_counts(), "a single-device prove after the mesh prove")
    telemetry.reset()
    warm, warm_a = prove(sharded)
    split = {k: round(v["seconds"], 4) for k, v in telemetry.report().items()}
    _, warm_b = prove(sharded)
    _, single_b = prove(single)
    if warm != cold:
        raise AssertionError("two mesh proves with one seed differ")

    # (e) a small run on the mesh, on the card and on the CPU
    small = {}
    for device in ("cuda", "cpu"):
        rp1, air1, _ = rescue_setup(1, 2, device)
        stark = Stark(air1, expansion_factor=4, num_colinearity_checks=2,
                      mesh=make_mesh(MESH_SHARDS, device))
        boundary1 = air1.boundary_constraints(rp1.hash(4242))
        small[device] = stark.prove(rp1.trace(4242), boundary1, randomizer_seed=b"mesh")
        if not stark.verify(small[device], boundary1):
            raise AssertionError(f"the small mesh proof from {device} does not verify")
    if small["cuda"] != small["cpu"]:
        raise AssertionError("cuda and cpu mesh provers disagree on the small run")

    info = dict(
        shards=MESH_SHARDS, processes=mesh.world, sharded_ntt_n=n, shard_counts=list(shard_counts),
        sharded_transforms_equal=transforms, exchanges_nat_nat_cyc_nat=[3, 2, 2],
        lde=f"{n} -> {lde_len}", sharded_lde_ms=round(lde_ms, 4), single_lde_ms=round(single_lde_ms, 4),
        commit=f"2 columns x {lde_len}, pair leaves", commit_sharded_ms=round(commit_ms, 4),
        commit_columns_ms=round(single_commit_ms, 4), commit_equal=True,
        chain=chain, fri_domain=sharded.fri_domain_length, equals_single_device_proof=True,
        verifies=True, cold_prove_s=round(cold_s, 3), warm_prove_s=[round(warm_a, 3), round(warm_b, 3)],
        single_warm_prove_s=[round(single_a, 3), round(single_b, 3)], exchanges_per_prove=exchanges,
        launches=launches, phase_split_warm_s=split, peak_device_bytes=peak,
        small_cuda_cpu_identical=True,
    )
    emit("mesh", **info)
    return info


def phase_dist(chain: int = 32765, full_run: tuple | None = None, log_n: int = 20) -> dict:
    """Through a torch.distributed group of this one process (nccl): the
    sharded NTT (Mesh._exchange through all_to_all_single on the card),
    then the block-local prove that W processes run, here at W = 1, on the
    full phase's inputs: its bytes, cold and warm times, phase split,
    exchanges, launches and peak device memory."""
    import tempfile

    from stark_anatomy_tpu_torch.iop.stark import Stark
    from stark_anatomy_tpu_torch.ops import _build
    from stark_anatomy_tpu_torch.ops import ntt as nttmod
    from stark_anatomy_tpu_torch.parallel import distributed, make_mesh
    from stark_anatomy_tpu_torch.utils import telemetry

    rp, air, _ = rescue_setup(chain, 16, "cuda")
    trace, boundary, want_proof = full_inputs(chain, full_run)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as d:
        if not distributed.init("file://" + os.path.join(d, "store"), 1, 0, device="cuda"):
            raise AssertionError("distributed.init did not initialise a process group")
        try:
            mesh = make_mesh(MESH_SHARDS, group=distributed.world_group())
            if mesh.world != 1:
                raise AssertionError("expected a one-process group")
            # a mesh with a group exchanges through all_to_all_single, also when
            # the group is this process alone
            x = edge_words(1 << log_n, 24, canonical=True)
            done = check_sharded_ntt(mesh, x, "sharded_ntt over a process group")
            backend = torch.distributed.get_backend(mesh.group)
            del x

            stark = Stark(air, expansion_factor=4, num_colinearity_checks=16, mesh=mesh)
            block = stark.fri_domain_length // mesh.world

            def prove() -> tuple:
                torch.cuda.synchronize()
                t = time.perf_counter()
                proof = stark.prove(trace, boundary, randomizer_seed=b"full-v1")
                torch.cuda.synchronize()
                return proof, time.perf_counter() - t

            nttmod.clear_twiddle_cache()  # cold = no twiddle or cross table cached
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            exchanges = mesh.exchanges
            cold, cold_s = prove()
            launches = _build.launch_counts()
            exchanges = mesh.exchanges - exchanges
            peak = torch.cuda.max_memory_allocated()
            require_prove_path(launches, "the group prove", mesh=True)
            if cold != want_proof:
                raise AssertionError("the group prove's bytes differ from the full phase's proof")
            if not stark.verify(cold, boundary):
                raise AssertionError("the group prove's proof does not verify")
            telemetry.reset()
            warm, warm_s = prove()
            split = {k: round(v["seconds"], 4) for k, v in telemetry.report().items()}
            if warm != cold:
                raise AssertionError("two group proves with one seed differ")
        finally:
            torch.distributed.destroy_process_group()
    info = dict(
        backend=backend, processes=1, shards=MESH_SHARDS, sharded_transforms_equal=done,
        chain=chain, fri_domain=stark.fri_domain_length, block_columns=block,
        proof_bytes=len(cold), equals_full_proof=True, verifies=True, cold_prove_s=round(cold_s, 3),
        warm_prove_s=round(warm_s, 3), exchanges_per_prove=exchanges, launches=launches,
        phase_split_warm_s=split, peak_device_bytes=peak,
    )
    emit("dist", **info)
    return info


def phase_big(chain: int = 32765, full_run: tuple | None = None, full: dict | None = None,
              big_chain: int = BIG_CHAIN) -> dict:
    """The chunked big-domain prover. 1: chain `chain` forced through it
    (_BIG_F_MIN = 1, _BIG_CHUNK = 2^22, restored after), held to the full
    phase's proof: cold and warm prove, peak, phase split, launches. 2: chain
    `big_chain` at its real size, where Stark routes to it by itself: the
    coset evaluation of an F/4-coefficient polynomial at F timed with its
    peak; then one prove, verify, bytes, phase split, launches, peak, host
    trace seconds and host peak RSS; then the excluded-row Horner of one
    chunk, its launches counted."""
    import resource

    from stark_anatomy_tpu_torch.iop import stark as stark_mod
    from stark_anatomy_tpu_torch.ops import _build
    from stark_anatomy_tpu_torch.ops import field_kernels as fk
    from stark_anatomy_tpu_torch.ops import field_torch as ft
    from stark_anatomy_tpu_torch.ops import ntt as nttmod
    from stark_anatomy_tpu_torch.ops.field import GENERATOR
    from stark_anatomy_tpu_torch.ops.limbs import mont
    from stark_anatomy_tpu_torch.utils import telemetry

    def run(stark, trace, boundary) -> dict:
        """One cold prove from an emptied cache and zeroed counts."""
        nttmod.clear_twiddle_cache()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        telemetry.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        proof = stark.prove(trace, boundary, randomizer_seed=b"full-v1")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        return dict(proof=proof, seconds=seconds, launches=_build.launch_counts(),
                    peak=torch.cuda.max_memory_allocated(),
                    split={k: round(v["seconds"], 4) for k, v in telemetry.report().items()})

    # 1. the forced path at the full phase's size
    trace, boundary, want = full_inputs(chain, full_run)
    rp, air, stark = rescue_setup(chain, 16, "cuda")
    saved = stark_mod._BIG_F_MIN, stark_mod._BIG_CHUNK
    stark_mod._BIG_F_MIN, stark_mod._BIG_CHUNK = 1, 1 << 22
    try:
        if not stark._big:
            raise AssertionError("the forced Stark does not take the big path")
        cold = run(stark, trace, boundary)
        require_prove_path(cold["launches"], "the forced big path")
        if cold["proof"] != want:
            raise AssertionError("the forced big path's bytes differ from the full phase's proof")
        if not stark.verify(cold["proof"], boundary):
            raise AssertionError("the forced big path's proof does not verify")
        telemetry.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = stark.prove(trace, boundary, randomizer_seed=b"full-v1")
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm_split = {k: round(v["seconds"], 4) for k, v in telemetry.report().items()}
        if warm != want:
            raise AssertionError("two forced big-path proves with one seed differ")
        forced = dict(
            chain=chain, fri_domain=stark.fri_domain_length, chunk=stark._big_chunk_len(),
            proof_bytes=len(cold["proof"]), equals_full_proof=True, verifies=True,
            cold_prove_s=round(cold["seconds"], 3), warm_prove_s=round(warm_s, 3),
            full_warm_prove_s=full["warm_prove_s"] if full else None,
            peak_device_bytes=cold["peak"],
            full_peak_device_bytes=full["peak_device_bytes"] if full else None,
            launches=cold["launches"], phase_split_warm_s=warm_split,
        )
    finally:
        stark_mod._BIG_F_MIN, stark_mod._BIG_CHUNK = saved
    del trace, boundary, want, stark, cold, warm

    # 2. the real size
    rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    t0 = time.perf_counter()
    rp, air, stark = rescue_setup(big_chain, 16, "cuda")
    trace = rp.trace_bytes(11, big_chain)
    trace_s = time.perf_counter() - t0
    boundary = air.boundary_constraints(int.from_bytes(trace[-1, 0].tobytes(), "little"))
    f = stark.fri_domain_length
    if not stark._big:
        raise AssertionError(f"chain {big_chain} (F = {f}) does not take the big path")

    # the coset evaluation at F (the trace LDE's and the zk codeword's), on
    # the empty card; warm: its twiddle table cached by the first call
    nttmod.clear_twiddle_cache()
    torch.cuda.empty_cache()
    coeffs = fk.to_mont(edge_words(f // 4, 31, canonical=True))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    nttmod.coset_evaluate(coeffs, f, GENERATOR)
    torch.cuda.synchronize()
    coset = {"cold_host_ms": (time.perf_counter() - t0) * 1e3,
             "peak_bytes_above_input": torch.cuda.max_memory_allocated() - base,
             "warm_ms": time_ms(lambda: nttmod.coset_evaluate(coeffs, f, GENERATOR), reps=2)}
    del coeffs
    nttmod.clear_twiddle_cache()
    torch.cuda.empty_cache()

    big = run(stark, trace, boundary)
    require_prove_path(big["launches"], "the big path")
    t0 = time.perf_counter()
    accepted = stark.verify(big["proof"], boundary)
    verify_s = time.perf_counter() - t0
    if not accepted:
        raise AssertionError(f"the F = {f} proof does not verify")
    if stark.verify(tamper_leaf(big["proof"]), boundary):
        raise AssertionError(f"a tampered F = {f} proof verified")
    blk = stark._big_chunk_len()
    # the excluded-row factor's Horner (_comb_chunked's, once a chunk) on one
    # chunk of points: its launches counted, its values held to the plain ops
    excluded = stark._excluded_coeffs()
    xc = fk.to_mont(edge_words(blk, 37, canonical=True))
    _build.reset_launch_counts()
    got = stark_mod._horner(excluded, xc, torch.empty_like(xc))
    torch.cuda.synchronize()
    horner = {k: v for k, v in _build.launch_counts().items() if v}
    want = ft.mont_mul(xc, mont(excluded[-1]))
    for d in range(len(excluded) - 2, -1, -1):
        if d < len(excluded) - 2:
            want = ft.mont_mul(want, xc)
        want = ft.add(want, mont(excluded[d]))
    if not torch.equal(got, want):
        raise AssertionError("the excluded-row Horner differs from the plain field ops")
    del xc, got, want
    info = dict(
        forced=forced, chain=big_chain, rows=stark.trace_length, omicron_domain=stark.omicron_domain_length,
        fri_domain=f, chunk=blk, chunks=f // blk, registers=stark.num_registers,
        horner_coefficients=len(excluded), horner_launches_per_chunk=horner,
        host_trace_s=round(trace_s, 3), coset_evaluation=coset, prove_s=round(big["seconds"], 3),
        verify_s=round(verify_s, 3), verifies=True, tampered_rejected=True, proof_bytes=len(big["proof"]),
        phase_split_s=big["split"], launches=big["launches"], peak_device_bytes=big["peak"],
        host_peak_rss_bytes_before=rss_before,
        host_peak_rss_bytes=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
    )
    emit("big", **info)
    return info


def layout_case(o: int, rows: int, registers: int, seed: int) -> tuple:
    """trace_layout's inputs as a prove of `rows` trace rows on the omicron
    domain `o` uploads them: the (rows, registers, 16) byte trace and the
    (registers, 4, o - rows) pad words, on the card."""
    from stark_anatomy_tpu_torch.ops import trace_layout
    from stark_anatomy_tpu_torch.ops.limbs import random_felt_words, words_to_bytes

    rng = np.random.default_rng(seed)
    trace = words_to_bytes(random_felt_words(rng, rows * registers)).reshape(rows, registers, 16).copy()
    return trace_layout.upload(trace, np.stack([random_felt_words(rng, o - rows) for _ in range(registers)]), "cuda")


def table_cases(n: int, registers: int, o: int, rows: int) -> tuple:
    """The kernels' calls at the shapes a prove with FRI domain `n`,
    `registers` trace columns and `rows` trace rows on the omicron domain `o`
    gives them: name -> (kernel call, plain call,
    units of work, bytes moved, launches per call[, the call to time when the
    compared one carries a copy]), and name -> the shape in words."""
    from stark_anatomy_tpu_torch.ops import blake2b as b2
    from stark_anatomy_tpu_torch.ops import blake2b_kernels as bk
    from stark_anatomy_tpu_torch.ops import field_kernels as fk
    from stark_anatomy_tpu_torch.ops import field_torch as ft
    from stark_anatomy_tpu_torch.ops import ntt as nttmod
    from stark_anatomy_tpu_torch.ops import ntt_kernels, trace_layout
    from stark_anatomy_tpu_torch.ops.field import PRIME
    from stark_anatomy_tpu_torch.utils import threefry

    # fp_pow_const is on the ops surface: held at the shape the prove gave it
    # while inv's scans bottomed out in a Fermat power (timed at 2^20 and n
    # besides, in phase_table)
    n_pow = 1024
    e_inv = PRIME - 2
    log_n = n.bit_length() - 1
    plan = ntt_kernels.pass_plan(log_n)
    log_block, late = plan[0][1], plan[1:]
    late_stages = sum(last - s + 1 for s, last in late)
    a, b = edge_words(n, 11), edge_words(n, 12).roll(5, dims=1)
    x = edge_words(n, 13, canonical=True)
    tw = nttmod._twiddles(n, False, "cuda")
    g = MESH_SHARDS  # the mesh prove's column transforms: n / g groups of g
    tw_g = nttmod._twiddles(g, False, "cuda")
    # the boundary-quotient tree's pair leaves: both halves of every register
    leaves = n // 2
    msg_len = 32 * registers
    if registers > 2:
        raise AssertionError("table_cases builds leaves of at most 2 registers")
    msg = torch.cat([t[:, sl] for sl in (slice(0, leaves), slice(leaves, n))
                     for t in (a, b)[:registers]], dim=0)

    def passes(y):
        for s, last in late:
            ntt_kernels.ntt_stage(y, tw, s, last)
        return y

    def passes_plain(y):
        for s, last in late:
            y = ntt_kernels.ntt_stages_plain(y, tw, s, last)
        return y

    blocked = ntt_kernels.ntt_block(x, tw, log_block)
    scratch = blocked.clone()
    xp = x[:, :n_pow].contiguous()
    xi = inv_input(n, 26)
    body, tail = layout_case(o, rows, registers, 27)

    def both(pair):
        return torch.cat(list(pair), dim=1)

    # (kernel call, plain call, units of work, bytes moved, launches a call
    # [, {"timed": the call to time when the compared one carries a copy}])
    cases = {
        "fp_add": (lambda: fk.add(a, b), lambda: ft.add(a, b), n, 48 * n, 1),
        "fp_sub": (lambda: fk.sub(a, b), lambda: ft.sub(a, b), n, 48 * n, 1),
        "fp_mont_mul": (lambda: fk.mont_mul(a, b), lambda: ft.mont_mul(a, b), n, 48 * n, 1),
        # launched no time by a prove (ops surface only): held at n = F
        "fp_butterfly": (lambda: both(fk.butterfly(a, b, x)), lambda: both(ft.butterfly(a, b, x)),
                         n, 80 * n, 1, {"timed": lambda: fk.butterfly(a, b, x)}),
        # the least work for a^(p-2) is the 143-product chain, not the
        # kernel's 169 windowed products
        "fp_pow_const": (lambda: fk.pow_const(xp, e_inv), lambda: ft.pow_const(xp, e_inv),
                         ft.INV_CHAIN_PRODUCTS * n_pow, 32 * n_pow, 1),
        # the whole call (inv_plan's launches); the least work is one read and
        # one write an element and Montgomery's 3 (n - 1) products + the chain
        "fp_batch_inv": (lambda: fk.inv(xi), lambda: ft.inv(xi),
                         3 * (n - 1) + ft.INV_CHAIN_PRODUCTS, 32 * n, 1),
        # a pass over stages s..last reads and writes the codeword once and
        # reads what it needs of the master table once: 2^(k-1) row factors,
        # k = last - s + 1, and 2^(s-1) column factors (none for ntt_block)
        "ntt_block": (lambda: ntt_kernels.ntt_block(x, tw, log_block),
                      lambda: ntt_kernels.ntt_block_plain(x, tw, log_block),
                      log_block * (n // 2), 32 * n + 16 * (1 << (log_block - 1)), 1),
        # the plan's later passes run and the time is divided by their number
        "ntt_stage": (lambda: passes(blocked.clone()), lambda: passes_plain(blocked),
                      late_stages * (n // 2),
                      sum(32 * n + 16 * ((1 << (last - s)) + (1 << (s - 1))) for s, last in late),
                      max(len(late), 1),
                      {"timed": lambda: passes(scratch)}),
        # launched by a prove on a mesh only
        "ntt_grouped": (lambda: ntt_kernels.ntt_grouped(x, tw_g, g),
                        lambda: ntt_kernels.ntt_grouped_plain(x, tw_g, g),
                        (g.bit_length() - 1) * (n // 2), 32 * n, 1),
        "blake2b_planes": (lambda: bk.blake2b_planes(msg, msg_len),
                           lambda: b2.blake2b_planes_plain(msg, msg_len),
                           leaves, (msg_len + 64) * leaves, 1),
        # the zk draw of degree_target + 1 = n/4 coefficients (expansion 4 on
        # every driven path): 16 B written a coefficient
        "zk_coefficients": (lambda: threefry.zk_coefficients(ZK_KEY, n // 4, "cuda"),
                            lambda: threefry.zk_coefficients_plain(ZK_KEY, n // 4, "cuda"),
                            n // 4, 16 * (n // 4), 1),
        # 16 B read and 16 B written an element
        "trace_layout": (lambda: trace_layout.mont_planes(body, tail),
                         lambda: trace_layout.mont_planes_plain(body, tail),
                         o * registers, 32 * o * registers, 1),
    }
    shapes = {name: f"n={n}" for name in cases}
    shapes["fp_pow_const"] = f"n={n_pow} e=p-2"
    shapes["ntt_block"] = f"n={n} s=1..{log_block}"
    shapes["ntt_stage"] = f"n={n} s=" + ",".join(f"{s}..{last}" for s, last in late)
    shapes["ntt_grouped"] = f"n={n} g={g}"
    shapes["blake2b_planes"] = f"{msg_len} B x {leaves}"
    shapes["zk_coefficients"] = f"n={n // 4}"
    shapes["trace_layout"] = f"O={o} T={rows} w={registers}"
    return cases, shapes


def zk_cases():
    """The zk draw at the shapes the benchmark's F = 2^26 prove and the big
    path give it: the whole draw of n = 2^24, and the big path's last chunk
    of _BIG_CHUNK columns of n = 2^26 (F = 2^28) as draw_chunk passes it (an
    index tensor into an out= view), and as a range. Yields (name, shape,
    kernel call, plain call)."""
    from stark_anatomy_tpu_torch.iop import stark as stark_mod
    from stark_anatomy_tpu_torch.utils import threefry

    n = 1 << 24
    yield ("zk_coefficients", f"n={n}", lambda: threefry.zk_coefficients(ZK_KEY, n, "cuda"),
           lambda: threefry.zk_coefficients_plain(ZK_KEY, n, "cuda"))
    n, blk = 1 << 26, stark_mod._BIG_CHUNK
    cols = range(n - blk, n)
    index = torch.arange(cols.start, cols.stop, device="cuda")
    out = torch.empty((4, 2 * blk), dtype=torch.int32, device="cuda")

    def chunk(columns):
        return threefry.zk_coefficients(ZK_KEY, n, "cuda", columns, out=out[:, blk:]).clone()

    plain = lambda: threefry.zk_coefficients_plain(ZK_KEY, n, "cuda", index)  # noqa: E731
    yield "zk_coefficients", f"n={n} columns {cols.start}..{cols.stop} index, out= view", \
        lambda: chunk(index), plain
    yield "zk_coefficients", f"n={n} columns {cols.start}..{cols.stop} range", \
        lambda: threefry.zk_coefficients(ZK_KEY, n, "cuda", cols), plain


def in_pieces(fn, *args, piece: int = 1 << 24) -> torch.Tensor:
    """fn of column-independent (k, n) arguments, applied to pieces of
    `piece` columns and concatenated: a plain version whose int64
    temporaries would not fit the card in one piece."""
    n = args[0].shape[1]
    return torch.cat([fn(*(a[:, i : i + piece] for a in args)) for i in range(0, n, piece)], dim=1)


def big_cases(f: int, blk: int, registers: int, o: int, rows: int):
    """The kernels' calls at the shapes the big path (FRI domain f, chunks of
    blk columns, `registers` trace columns of `rows` rows on the omicron
    domain o) gives them: yields (name, shape,
    kernel call, plain call) one case at a time, the inputs of each group
    of cases made just before it. The field ops at a chunk and at f (the F-point scalings
    and conversions), fp_batch_inv at a chunk (one a _bq_domain_chunk),
    ntt_block and every ntt_stage pass of the f-point coset transforms,
    blake2b_planes on a chunk's pair leaves (bq: 32 * registers B, zk and
    FRI round 0: 32 B), on a chunk's first node level (128 B) and on FRI
    round 1's standard commit (32 B x f/4), trace_layout on the whole trace.
    The plain versions at f run in pieces (in_pieces; the NTT's:
    ntt_kernels.PLAIN_PIECE butterflies)."""
    from stark_anatomy_tpu_torch.ops import blake2b as b2
    from stark_anatomy_tpu_torch.ops import blake2b_kernels as bk
    from stark_anatomy_tpu_torch.ops import field_kernels as fk
    from stark_anatomy_tpu_torch.ops import field_torch as ft
    from stark_anatomy_tpu_torch.ops import ntt as nttmod
    from stark_anatomy_tpu_torch.ops import ntt_kernels, trace_layout

    body, tail = layout_case(o, rows, registers, 44)
    yield ("trace_layout", f"O={o} T={rows} w={registers}", lambda: trace_layout.mont_planes(body, tail),
           lambda: trace_layout.mont_planes_plain(body, tail))
    del body, tail
    ops = (("fp_add", fk.add, ft.add), ("fp_sub", fk.sub, ft.sub), ("fp_mont_mul", fk.mont_mul, ft.mont_mul))
    x = edge_words(f, 43, canonical=True)  # the edge values up front
    for n in (blk, f):
        a = x[:, :n].contiguous()
        b = a.roll(5, dims=1)
        for name, kernel, plain in ops:
            yield name, f"n={n}", lambda: kernel(a, b), lambda: in_pieces(plain, a, b)
        del a, b
    xi = inv_input(blk, 45)
    yield "fp_batch_inv", f"n={blk}", lambda: fk.inv(xi), lambda: ft.inv(xi)
    del xi

    log_f = f.bit_length() - 1
    plan = ntt_kernels.pass_plan(log_f)
    log_block = plan[0][1]
    tw = nttmod._twiddles(f, False, "cuda")
    yield ("ntt_block", f"n={f} s=1..{log_block}", lambda: ntt_kernels.ntt_block(x, tw, log_block),
           lambda: ntt_kernels.ntt_block_plain(x, tw, log_block))
    y = ntt_kernels.ntt_block(x, tw, log_block)
    del x
    for s, last in plan[1:]:
        yield ("ntt_stage", f"n={f} s={s}..{last}", lambda: ntt_kernels.ntt_stage(y.clone(), tw, s, last),
               lambda: ntt_kernels.ntt_stages_plain(y, tw, s, last))
        ntt_kernels.ntt_stage(y, tw, s, last)  # the next pass's input
    del y, tw
    nttmod.clear_twiddle_cache()

    for msg_len, leaves in ((32 * registers, blk), (32, blk), (128, blk // 2), (32, f // 4)):
        msg = torch.cat([edge_words(leaves, 50 + k) for k in range(msg_len // 16)], dim=0)
        yield ("blake2b_planes", f"{msg_len} B x {leaves}", lambda: bk.blake2b_planes(msg, msg_len),
               lambda: in_pieces(lambda m: b2.blake2b_planes_plain(m, msg_len), msg))
        del msg


def phase_table(results: dict, full: dict, airs: dict | None, mesh: dict | None,
                inv: dict | None = None, dist: dict | None = None, big: dict | None = None) -> list:
    """Each kernel held against its plain version at the shapes of EVERY
    driven path (the Rescue-Prime prove of the full phase and, where the airs
    phase ran, the Fibonacci and MiMC proves: each path's own FRI domain,
    late NTT stages and leaf width), then timed beside
    the plain version at the full phase's shapes; bounds from those sizes.
    `launches` is the full phase's count, for a mesh-only kernel the mesh
    phase's; the airs, mesh, dist and big phases' counts stand beside it.
    Where the big phase ran, every kernel it launched is held at that
    prove's own shapes too (big_cases), before the other paths' tables."""
    from stark_anatomy_tpu_torch.ops import field_kernels as fk
    from stark_anatomy_tpu_torch.ops import field_torch as ft
    from stark_anatomy_tpu_torch.ops.field import PRIME
    from stark_anatomy_tpu_torch.utils import threefry

    def shape_of(info: dict) -> tuple:
        return info["fri_domain"], info["registers"], info["omicron_domain"], info["rows"]

    paths = {"rescue_prime": shape_of(full)}
    for air, info in (airs or {}).items():
        paths[air] = shape_of(info)
    main = paths["rescue_prime"]
    compared: dict = {}  # (kernel, shape) -> max abs err

    def compare(name: str, kernel, plain, shape: str) -> int:
        if (name, shape) not in compared:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} differs from its plain version at {shape} (max abs err {err})")
            compared[(name, shape)] = err
        return compared[(name, shape)]

    compared_at = {name: [] for name in OPS_PER_UNIT}
    if big:
        for name, shape, kernel, plain in big_cases(big["fri_domain"], big["chunk"], big["registers"],
                                                    big["omicron_domain"], big["rows"]):
            compared_at[name].append({"paths": ["big"], "shape": shape,
                                      "max_abs_err": compare(name, kernel, plain, shape)})
        torch.cuda.empty_cache()
    for key in sorted(set(paths.values()) - {main}) + [main]:
        cases, shapes = table_cases(*key)
        for name, case in cases.items():
            compared_at[name].append({
                "paths": [p for p, k in paths.items() if k == key], "shape": shapes[name],
                "max_abs_err": compare(name, case[0], case[1], shapes[name])})
        if key != main:
            del cases
            torch.cuda.empty_cache()
    for name, shape, kernel, plain in zk_cases():
        compared_at[name].append({"paths": ["f26" if "columns" not in shape else "big"], "shape": shape,
                                  "max_abs_err": compare(name, kernel, plain, shape)})
    torch.cuda.empty_cache()

    n = main[0]
    table = []
    for name, (kernel, plain, units, nbytes, per_call, *opts) in cases.items():
        opts = opts[0] if opts else {}
        ms = time_ms(opts.get("timed", kernel), reps=5) / per_call
        plain_ms = time_ms(plain, reps=1) / per_call
        bytes_ms = nbytes / DEVICE_MEMORY_BYTES_PER_S * 1e3 / per_call
        ops_ms = OPS_PER_UNIT[name] * units / INT32_OPS_PER_S * 1e3 / per_call
        source, replaces = KERNEL_SOURCES[name]
        err = max(c["max_abs_err"] for c in compared_at[name])
        table.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": (mesh if mesh and name in MESH_ONLY else full)["launches"][name],
            "max_abs_err": max(err, results.get(name, {}).get("max_abs_err", 0)),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "shape": shapes[name], "compared_at": compared_at[name],
        })
        if airs:
            table[-1].update({f"launches_{air}": info["launches"][name] for air, info in airs.items()})
        if mesh:
            table[-1]["launches_mesh"] = mesh["launches"][name]
        if dist:
            table[-1]["launches_dist"] = dist["launches"][name]
        if big:
            table[-1]["launches_big"] = big["launches"][name]
            table[-1]["launches_big_forced"] = big["forced"]["launches"][name]
    # the whole n-point transform (ntt_block and the ntt_stage passes of
    # pass_plan) beside the least time the card could take for it
    from stark_anatomy_tpu_torch.ops import ntt as nttmod
    from stark_anatomy_tpu_torch.ops import ntt_kernels

    x = edge_words(n, 13, canonical=True)
    tw = nttmod._twiddles(n, False, "cuda")
    transform_ms = time_ms(lambda: ntt_kernels.transform(x, tw), reps=5)
    log_n = n.bit_length() - 1
    transform_bound_ms = max(OPS_PER_UNIT["ntt_stage"] * log_n * (n // 2) / INT32_OPS_PER_S,
                             32 * n / DEVICE_MEMORY_BYTES_PER_S) * 1e3
    for row in table:
        if row["name"] in ("ntt_block", "ntt_stage"):
            row.update(transform_ms=transform_ms, transform_bound_ms=transform_bound_ms,
                       transform_passes=ntt_kernels.pass_plan(log_n))
    # fp_pow_const is launch-bound at n = 1024: its time where the
    # arithmetic shows, beside the operations bound there (the chain's 143
    # products an element; the kernel's own windowed count stands beside it)
    e_inv = PRIME - 2
    pow_row = next(row for row in table if row["name"] == "fp_pow_const")
    pow_row["bound_products_per_element"] = ft.INV_CHAIN_PRODUCTS
    pow_row["kernel_products_per_element"] = fk.pow_products(e_inv)
    for size in (1 << 20, n):
        y = x[:, :size]
        pow_row[f"ms_n_{size}"] = time_ms(lambda: fk.pow_const(y, e_inv), reps=3)
        pow_row[f"bound_ms_n_{size}"] = max(
            OPS_PER_UNIT["fp_pow_const"] * ft.INV_CHAIN_PRODUCTS * size / INT32_OPS_PER_S,
            32 * size / DEVICE_MEMORY_BYTES_PER_S) * 1e3
    zk_row = next(row for row in table if row["name"] == "zk_coefficients")
    size = 1 << 24
    zk_row[f"ms_n_{size}"] = time_ms(lambda: threefry.zk_coefficients(ZK_KEY, size, "cuda"), reps=5)
    zk_row[f"bound_ms_n_{size}"] = max(OPS_PER_UNIT["zk_coefficients"] * size / INT32_OPS_PER_S,
                                       16 * size / DEVICE_MEMORY_BYTES_PER_S) * 1e3
    # trace_layout at the larger cells' omicron domains (prod80.f26, f28: 159
    # pad rows), beside the route it replaces on the card, mont_planes_plain:
    # a permute, a concatenation and one to_mont launch a column
    from stark_anatomy_tpu_torch.ops import trace_layout

    layout_row = next(row for row in table if row["name"] == "trace_layout")
    for o in (1 << 22, 1 << 24):
        body, tail = layout_case(o, o - 159, main[1], 28)
        layout_row[f"ms_o_{o}"] = time_ms(lambda: trace_layout.mont_planes(body, tail), reps=5)
        layout_row[f"plain_ms_o_{o}"] = time_ms(lambda: trace_layout.mont_planes_plain(body, tail), reps=5)
        layout_row[f"bound_ms_o_{o}"] = 32 * o * main[1] / DEVICE_MEMORY_BYTES_PER_S * 1e3
        del body, tail
    inv_row = next(row for row in table if row["name"] == "fp_batch_inv")
    inv_row["launches_per_call"] = len(fk.inv_plan(n)) * 2 - 1
    if inv:
        inv_row["host_ms"] = inv["host_ms"]
    return table


def phase_tune(out_dir: str | None) -> None:
    """(Only when named in --phases.) Times of the NTT passes at n = 2^20 and
    2^24 for several cuts of the stages, tile widths and block sizes, launched
    with explicit values: the readings behind pass_plan, tile_cols and
    tile_threads in ops/ntt_kernels.py. Times only; the output is not read."""
    from stark_anatomy_tpu_torch.ops import _build
    from stark_anatomy_tpu_torch.ops import ntt as nttmod

    rows = []
    for log_n, cuts in ((20, [[10, 10], [7, 7, 6], [8, 6, 6], [9, 6, 5]]),
                        (24, [[8, 8, 8], [10, 7, 7], [9, 8, 7], [8, 9, 7], [6, 9, 9], [10, 10, 4]])):
        x = edge_words(1 << log_n, 40, canonical=True)
        tw = nttmod._twiddles(1 << log_n, False, "cuda")
        y = torch.empty_like(x)
        table = (tw.data_ptr(), tw.stride(0))
        for cut in cuts:
            first = 1
            for k in cut:
                last = first + k - 1
                for log_cols in (2, 3, 4, 5):
                    if k + log_cols > 13 or (first > 1 and log_cols > first - 1):
                        continue
                    for log_threads in (7, 8, 9, 10):
                        if first == 1:
                            args = ("ntt_block", x.data_ptr(), x.stride(0), y.data_ptr(), y.stride(0),
                                    *table, log_n, k, log_cols, log_threads, 0, 0, 0, 0, 0)
                        else:
                            args = ("ntt_stage", y.data_ptr(), y.stride(0), *table, log_n, first, last,
                                    log_cols, log_threads)
                        rows.append({"log_n": log_n, "cut": cut, "kernel": args[0], "stages": [first, last],
                                     "log_cols": log_cols, "log_threads": log_threads,
                                     "ms": round(time_ms(lambda: _build.launch(*args), reps=3), 4)})
                first = last + 1
    best = {}
    for row in rows:
        key = (row["log_n"], row["kernel"], tuple(row.get("stages", ())))
        if key not in best or row["ms"] < best[key]["ms"]:
            best[key] = row
    emit("tune", gpu=gpu_name_and_limit(), best=list(best.values()))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "tune.json"), "w") as fh:
            json.dump({"gpu": gpu_name_and_limit(), "rows": rows}, fh, indent=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--phases",
                    default="env,build,kernels,golden,mid,airs,resume,full,cli,inv,mesh,dist,big")
    ap.add_argument("--verbose-build", action="store_true", help="print ptxas resource usage")
    ap.add_argument("--chain", type=int, default=32765, help="chain length of the full phase")
    ap.add_argument("--out", default=None, help="directory for chip_smoke.json / tune.json")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs one CUDA card",
              file=sys.stderr)
        return 1
    import stark_anatomy_tpu_torch  # noqa: F401  (fails here if the package is absent)

    results: dict = {}
    t_start = time.perf_counter()
    if "env" in phases:
        phase_env()
    if "build" in phases:
        phase_build(args.verbose_build)
    if "kernels" in phases:
        phase_kernels(results)
    if "tune" in phases:
        phase_tune(args.out)
    if "golden" in phases:
        phase_golden()
    if "mid" in phases:
        phase_mid()
    airs = phase_airs() if "airs" in phases else None
    if "resume" in phases:
        phase_resume()
    if "full" not in phases:
        if "inv" in phases:
            phase_inv()
        if "mesh" in phases:
            phase_mesh(args.chain)
        if "dist" in phases:
            phase_dist(args.chain)
        if "big" in phases:
            phase_big(args.chain)
        emit("done", seconds=round(time.perf_counter() - t_start, 1), partial=True)
        return 0
    full, full_run = phase_full(args.chain)
    cli = phase_cli(args.chain, full_run[2]) if "cli" in phases else None
    inv = phase_inv() if "inv" in phases else None
    mesh = phase_mesh(args.chain, full_run) if "mesh" in phases else None
    dist = phase_dist(args.chain, full_run) if "dist" in phases else None
    big = phase_big(args.chain, full_run, full) if "big" in phases else None
    del full_run
    if "kernels" not in phases:
        emit("done", seconds=round(time.perf_counter() - t_start, 1), partial=True)
        return 0
    table = phase_table(results, full, airs, mesh, inv, dist, big)
    emit("done", seconds=round(time.perf_counter() - t_start, 1))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
            json.dump({"gpu": gpu_name_and_limit(), "full": full, "cli": cli, "inv": inv, "airs": airs,
                       "mesh": mesh, "dist": dist, "big": big, "kernels": table},
                      fh, indent=1)
    print(json.dumps({"kernels": table}), flush=True)
    print(gpu_name_and_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

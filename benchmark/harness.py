"""One run of one cell: set-up, the measured window, the traced proves, the
reference's check, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file that the harness finds by the name BENCHMARK.json gives it:

    configs/<config>.json     the configuration as it is run (BENCHMARK.json
                              names the file)
    airs/<air>.py             the program's side of the AIR that the
                              configuration's "air"."name" names: build()
                              and statements()
    reference/<air>.py        the plain reference of that AIR: from_config()
    traffic/<traffic>.json    the traffic mix, read by generator.py
    metrics/<metric>.py       a reader: read(ctx) -> number, or None where
                              the run holds nothing to read
    kernels/<kernel>.json     {"metric": <roofline>}: the device time of
                              kernel <kernel> counts against that roofline

The program under test is the PyTorch and CUDA package; the harness takes
from it the prover (Stark, the AIR, the native trace generator), its spans
(utils/telemetry) and its kernels' names in the device trace.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import glob
import importlib.util
import json
import multiprocessing
import os
import statistics
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field

from benchmark import devtrace, generator, work
from benchmark.reference.verifier import Verifier, judge

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
PROGRAM = "stark_anatomy_tpu_torch"
#: top-level modules that may not be loaded in a run's process: the JAX
#: package this program was ported from, and JAX itself
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "stark_anatomy_tpu")
#: proves before the window: the first loads the kernels and fills the
#: program's tables, the second runs as every later one does
WARMUP_PROVES = 2
#: proves under torch.profiler after the window of a traced run
PROFILED_PROVES = 3


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def _reader(name: str):
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)  # [(metric entry, reader)]
    per_layer: list = field(default_factory=list)


def resolve(name: str) -> Cell:
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == workload["config"])

    def metrics(kind: str) -> list:
        return [(m, _reader(m["name"])) for m in bench[kind] if name in m.get("workloads", [name])]

    return Cell(
        name=name, chips=workload["chips"],
        config=load_json(os.path.join(ROOT, config["file"])),
        traffic=load_json(os.path.join(BENCH_DIR, "traffic", workload["traffic"] + ".json")),
        end_to_end=metrics("end_to_end"), per_layer=metrics("per_layer"),
    )


def kernel_metrics() -> dict:
    """kernel name -> the roofline metric its device time counts against."""
    return {os.path.basename(p)[: -len(".json")]: load_json(p)["metric"]
            for p in sorted(glob.glob(os.path.join(BENCH_DIR, "kernels", "*.json")))}


def foreign_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def children() -> list:
    """The pids of this process's living children (Linux), else []."""
    pids = []
    for path in glob.glob(f"/proc/{os.getpid()}/task/*/children"):
        try:
            with open(path) as fh:
                pids += [int(p) for p in fh.read().split()]
        except OSError:
            pass
    return sorted(set(pids))


def reap_children(timeout: float = 30.0) -> list:
    """Stop multiprocessing's resource tracker, which a spawn pool starts and
    which otherwise outlives the pool until this process exits, then wait
    for every other child of this process; one still alive after `timeout`
    seconds is killed and waited for. Returns the pids that were killed."""
    tracker = getattr(sys.modules.get("multiprocessing.resource_tracker"), "_resource_tracker", None)
    if tracker is not None and getattr(tracker, "_fd", None) is not None:
        tracker._stop()
    deadline, killed = time.monotonic() + timeout, []
    for pid in children():
        try:
            while os.waitpid(pid, os.WNOHANG) == (0, 0):
                if time.monotonic() >= deadline:
                    os.kill(pid, 9)
                    killed.append(pid)
                    os.waitpid(pid, 0)
                    break
                time.sleep(0.05)
        except ChildProcessError:
            pass
    return killed


def process_start() -> float:
    """The epoch second this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            boot = next(int(line.split()[1]) for line in fh if line.startswith("btime"))
        return boot + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def air_module(kind: str, config: dict):
    """The module airs/<air>.py (kind "airs") or reference/<air>.py (kind
    "reference") of the AIR the configuration names."""
    name = config["air"]["name"]
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not name.isidentifier() or not os.path.exists(path):
        raise KeyError(f"no {kind}/{name}.py for the AIR {name!r}")
    module_name = f"benchmark.{kind}.{name}"  # the name its objects pickle under
    if module_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[module_name]
            raise
    return sys.modules[module_name]


def reference_air(config: dict):
    return air_module("reference", config).from_config(config["air"])


def make_plan(cell: "Cell", seed: int) -> generator.Plan:
    return generator.plan(cell.traffic, cell.config, seed, reference_air(cell.config).rows)


class Program:
    """The system under test, set up for one cell and its statements."""

    def __init__(self, config: dict, plan: generator.Plan, device: str):
        import torch

        from stark_anatomy_tpu_torch.iop.stark import Stark

        airs = air_module("airs", config)
        self.air = airs.build(config["air"], plan.length)
        self.stark = Stark(self.air, device=device, **config["stark"])
        self.statements = airs.statements(self.air, list(plan.inputs))
        self.cuda = torch.device(device).type == "cuda"
        self._torch = torch

    def sync(self) -> None:
        if self.cuda:
            self._torch.cuda.synchronize()

    def prove(self, plan: generator.Plan, index: int) -> tuple:
        """(statement, proof or None, seconds) of prove `index`, the device
        drained on both sides of the timed call."""
        k = plan.statement(index)
        trace, boundary = self.statements[k]
        self.sync()
        t0 = time.perf_counter()
        try:
            proof = self.stark.prove(trace, boundary, randomizer_seed=plan.prove_seed(index))
            self.sync()
        except Exception:  # a failed prove is counted, and the loop goes on
            traceback.print_exc(file=sys.stderr)
            proof = None
        return k, proof, time.perf_counter() - t0

    def free(self) -> None:
        """Drop the prover and the program's cached tables."""
        import stark_anatomy_tpu_torch as pkg

        self.stark = None
        clear = getattr(pkg, "clear_table_caches", None)
        if clear is not None:
            clear()
        gc.collect()
        if self.cuda:
            self._torch.cuda.empty_cache()


@contextlib.contextmanager
def mirrored_spans():
    """Open a torch.profiler range beside every span of the program's
    telemetry, so that the device trace can name what the host was doing."""
    from torch.profiler import record_function

    from stark_anatomy_tpu_torch.utils import telemetry

    original = telemetry.phase

    @contextlib.contextmanager
    def phase(name):
        with record_function(name), original(name):
            yield

    patched = []
    for mod_name, mod in list(sys.modules.items()):
        if mod_name.split(".")[0] != PROGRAM or mod is None:
            continue
        for attr, value in list(vars(mod).items()):
            if value is original:
                setattr(mod, attr, phase)
                patched.append((mod, attr))
    try:
        yield
    finally:
        for mod, attr in patched:
            setattr(mod, attr, original)


def profile_proves(program: Program, plan: generator.Plan, first_index: int, count: int) -> tuple:
    """Proofs of `count` proves under torch.profiler, and the trace reduced."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if program.cuda else [])
    proofs = []
    with mirrored_spans(), profile(activities=activities) as prof:
        for i in range(count):
            with record_function(devtrace.PROVE_SPAN):
                proofs.append(program.prove(plan, first_index + i)[:2])
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return proofs, devtrace.reduce(path)
    finally:
        os.remove(path)


def reference_verifier(config: dict, plan: generator.Plan) -> Verifier:
    """The reference verifier of the statements' proofs; it also holds the
    prove's domains as the reference derives them."""
    s = config["stark"]
    return Verifier(reference_air(config), s["expansion_factor"], s["num_colinearity_checks"],
                    s["grinding_bits"], s["num_randomizers"], plan.length)


def repeats(values: list) -> list:
    """For each value, whether an earlier one equals it (None never does)."""
    seen, out = set(), []
    for v in values:
        out.append(v is not None and v in seen)
        seen.add(v)
    return out


def check(config: dict, plan: generator.Plan, traces: list, proofs: list, workers: int) -> dict:
    """The reference's judgement of a run's outputs: every number with its
    limit, and the proofs that failed. Each statement's trace is checked row
    by row and its output read from it; every proof, a (statement, proof or
    None) pair, is verified against its statement's output, and no proof,
    boundary-quotient root or zk root may repeat an earlier one: every prove
    has its own randomizer seed, which draws the padding rows under the
    boundary quotients and the zk codeword. With workers > 1 the work runs
    in that many processes."""
    verifier = reference_verifier(config, plan)
    air = verifier.air
    outputs = [air.output(t) if t.ndim == 3 and len(t) else 0 for t in traces]
    returned = [(p, outputs[k]) for k, p in proofs if p is not None]
    with contextlib.ExitStack() as stack:
        pool = None
        if workers > 1:
            pool = stack.enter_context(concurrent.futures.ProcessPoolExecutor(
                max_workers=workers, mp_context=multiprocessing.get_context("spawn")))
        step = max(1, -(-len(returned) // workers))
        chunks = [returned[k:k + step] for k in range(0, len(returned), step)]
        judged = [judge(verifier, c) if pool is None else pool.submit(judge, verifier, c) for c in chunks]
        faults = sum(air.trace_faults(t, x, plan.length, pool) for t, x in zip(traces, plan.inputs))
        judged = [j if pool is None else j.result() for j in judged]
    if workers > 1:
        reap_children()
    rejected = [bad for j in judged for bad in j[0]]
    roots = [r for j in judged for r in j[1]]
    bq_repeated = repeats([r and r[0] for r in roots])
    zk_repeated = repeats([r and r[1] for r in roots])
    repeated = repeats([p for p, _ in returned])
    failed = len(proofs) - len(returned) + sum(map(any, zip(rejected, bq_repeated, zk_repeated, repeated)))
    return {
        "trace_faults": {"value": faults, "limit": 0},
        "proves_failed": {"value": len(proofs) - len(returned), "limit": 0},
        "proofs_rejected": {"value": sum(rejected), "limit": 0},
        "proofs_repeated": {"value": sum(repeated), "limit": 0},
        "bq_roots_repeated": {"value": sum(bq_repeated), "limit": 0},
        "zk_roots_repeated": {"value": sum(zk_repeated), "limit": 0},
    }, failed


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float | None = None, workers: int | None = None) -> tuple:
    """(result, check lines) of one run of `cell`."""
    t_start = process_start() if t_start is None else t_start
    import torch

    from stark_anatomy_tpu_torch.utils import telemetry

    plan = make_plan(cell, seed)
    program = Program(cell.config, plan, device)
    for i in range(WARMUP_PROVES):
        program.prove(plan, -1 - i)
    if program.cuda:
        torch.cuda.reset_peak_memory_stats()
    telemetry.reset()
    setup_s = time.time() - t_start

    proofs, walls = [], []
    t0 = time.perf_counter()
    while True:
        k, proof, wall = program.prove(plan, len(proofs))
        proofs.append((k, proof))
        walls.append(wall)
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    phases = {k: v["seconds"] for k, v in telemetry.report().items()}
    peak = torch.cuda.max_memory_allocated() if program.cuda else 0

    profiled = None
    if trace:
        more, profiled = profile_proves(program, plan, len(proofs), PROFILED_PROVES)
        proofs += more
    device_info = {
        "platform": "gpu" if program.cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if program.cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    if profiled is not None:
        device_info.update(busy_s=profiled["busy_s"], window_s=profiled["window_s"])
    traces = [t for t, _ in program.statements]
    program.free()
    del program

    t_check = time.perf_counter()
    checks, failed = check(cell.config, plan, traces, proofs,
                           workers if workers is not None else min(8, os.cpu_count() or 1))
    check_s = time.perf_counter() - t_check
    ctx = {
        "proves": len(walls), "window_s": window_s, "walls": walls, "setup_s": setup_s,
        "peak_bytes": peak, "phases": phases, "profile": profiled,
        "work": work.prove_work(reference_verifier(cell.config, plan)), "kernel_metric": kernel_metrics(),
    }
    metrics = {}
    for entry, read in (cell.per_layer if trace else cell.end_to_end):
        value = read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()) and bool(walls),
        "attempted": len(proofs),
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
    }
    if profiled is not None:
        top = sorted(profiled["ops"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(profiled["gaps"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [list(kv) for kv in top], "idle_gaps": [list(kv) for kv in gaps]}
    result["checks"] = checks
    lines = [
        "window: " + json.dumps({"proves": len(walls), "seconds": window_s, "reference_check_s": check_s,
                                 "walls": walls,
                                 "phases_per_prove": {k: v / len(walls) for k, v in sorted(phases.items())}}),
    ] + [f"check {name}: {c['value']} (limit {c['limit']})" for name, c in checks.items()]
    return result, lines


def phase_ms(ctx: dict, name: str, minus: tuple = ()) -> float | None:
    """Milliseconds a window prove spent in the program's span `name`, less
    its child spans `minus`; None where the span never opened."""
    phases = ctx["phases"]
    if name not in phases:
        return None
    return (phases[name] - sum(phases.get(m, 0.0) for m in minus)) / ctx["proves"] * 1e3


def roofline(ctx: dict, metric: str, work_key: str) -> float | None:
    """Percent of the device time of the kernels attributed to `metric`
    that the least time of the prove's `work_key` work would take."""
    prof = ctx["profile"]
    if prof is None:
        return None
    device_s = sum(s for k, s in prof["kernels"].items() if ctx["kernel_metric"].get(k) == metric)
    if device_s <= 0:
        return None
    return 100.0 * ctx["work"][work_key] * prof["proves"] / device_s


def p90(values: list) -> float:
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[-1]

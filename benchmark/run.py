"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout holding ``BENCHMARK.json``, ``benchmark/`` and the
program (``yolo_puncture_tpu_torch``), on a machine with a CUDA card.  The cell
is ``benchmark/workloads/<cell>.json``; it names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``), and the configuration names its system
(``benchmark/systems/<system>.py``, whose seam ``systems/__init__.py``
describes).  Each metric that ``BENCHMARK.json`` gives the cell is read by
``benchmark/metrics/<metric>.py``.  This harness knows no model: the system
makes the inputs and weights, builds the program, hands its steps in and
checks them against its plain reference.

Set-up is the system's set-up and two warm-up steps.  The window then hands
steps in for ``--seconds``: step i + 1 is handed in before step i's outputs are
waited for, so two steps are in flight (one, where a step returns its outputs
already on the host), and the state is carried from step to step.  With
``--trace 1`` two short stretches in the middle of the window run under
``torch.profiler``: one plain (device busy time, the layers' device time), one
with Python stacks (which call launched each kernel).  After the window the
system frees the program and its plain reference (fp32, TF32 off) recomputes
the first step and ``check_steps`` more, drawn from the seed, from the same
inputs, weights and state; each number with a limit in the cell's file is
compared with it.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``compared``: each compared number with its limit); the last
lines of standard error repeat the compared numbers.  Without a card, or with
fewer cards than the cell asks for, it prints no result and exits with 2; if
JAX, flax or the JAX package was loaded, with 3.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.autograd.profiler import record_function  # noqa: E402

from benchmark.tracefile import Trace  # noqa: E402

IMPORTED = time.perf_counter()

HERE = Path(__file__).resolve().parent
BUILD = ROOT / "build" / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "yolo_puncture_tpu")
WARMUP_STEPS = 2
PLAIN_TRACE_STEPS, STACK_TRACE_STEPS = 3, 1
NAME_CHARS = 160            # a kernel's templated name is cut here in the breakdown


def _named(kind: str, name: str, suffix: str = ".json") -> Path:
    path = HERE / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file named {name!r} ({path})")
    return path


def load_json(kind: str, name: str) -> Dict:
    """``benchmark/<kind>/<name>.json``: a cell (``workloads``), a configuration
    (``configs``) or a traffic mix (``traffic``)."""
    return json.loads(_named(kind, name).read_text())


def _load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` loaded by its path: a metric's reader or a system."""
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", _named(kind, name, ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, overrides: Optional[Dict] = None) -> Dict:
    """The cell's file with its configuration and traffic mix loaded;
    ``overrides`` = {"config": {...}, "traffic": {...}, "limits": {...}} replaces
    entries, and the limits whole (the CPU tests shrink the sizes, and set limits
    for them, so)."""
    cell = load_json("workloads", name)
    cell["cfg"] = load_json("configs", cell["config"])
    cell["tr"] = load_json("traffic", cell["traffic"])
    for part, key in (("config", "cfg"), ("traffic", "tr")):
        for k, v in ((overrides or {}).get(part) or {}).items():
            if isinstance(v, dict) and isinstance(cell[key].get(k), dict):
                cell[key][k] = {**cell[key][k], **v}
            else:
                cell[key][k] = v
    if overrides and "limits" in overrides:
        cell["limits"] = dict(overrides["limits"])
    return cell


def cell_metrics(name: str, trace: bool) -> List[Dict]:
    """``BENCHMARK.json``'s metrics for the cell: its end-to-end metrics, or with
    ``trace`` its per-layer ones (each entry's ``workloads`` key, when there is
    one, names the cells it applies to)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [m for m in spec["per_layer" if trace else "end_to_end"] if name in m.get("workloads", [name])]


def read_metric(name: str, run) -> Optional[float]:
    return _load_module("metrics", name).read(run)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every number the cell's file gives a limit is finite and
    within it; a number without a limit is printed, not compared."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)


@dataclasses.dataclass
class Run:
    """What the metric readers read (``benchmark/metrics/*.py``)."""
    cfg: Dict
    traffic: Dict
    setup_s: float = 0.0
    steps: List[Dict] = dataclasses.field(default_factory=list)  # hand, ret, done (host seconds), frames
    window_s: float = 0.0
    peak_bytes: int = 0
    step_flops: int = 0
    trace: Optional[Trace] = None              # the plain profiled stretch
    trace_window: Optional[tuple] = None       # (start, end) in its microseconds
    trace_steps: int = 0                       # steps completed in that window
    plain_step_s: float = 0.0                  # seconds a step, over the steps no profiler touched
    stack_trace: Optional[Trace] = None        # the stretch profiled with Python stacks


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: Optional[Dict] = None, fault=None, t_start: Optional[float] = None):
    """Set up, measure and check one run of the cell.  Returns (result dict, the
    compared numbers with their limits).  ``fault(step)`` may wrap the system's
    timed step (the tests plant faults so)."""
    t_start = PROCESS_START if t_start is None else t_start
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(name, overrides)
    cfg, tr = cell["cfg"], cell["tr"]
    system_mod = _load_module("systems", cfg["system"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    BUILD.mkdir(parents=True, exist_ok=True)

    # -- set-up: the system's, then the warm-up -------------------------------------------------------
    marks = [("python, torch", IMPORTED), ("card, cell", time.perf_counter())]
    system = system_mod.setup(cell, seed, dev, lambda part: marks.append((part, time.perf_counter())), fault)
    limits = cell["limits"]
    unknown = sorted(set(limits) - set(system.names))
    if unknown:
        raise ValueError(f"the cell's limits name {unknown}, which system {cfg['system']!r} does not compare")

    def hand(i, state, into):
        with record_function("bench::handin"):
            rec, state = system.hand(i, state, into)
        rec["i"] = i
        return rec, state

    def wait(rec):
        with record_function("bench::wait"):
            event = rec.pop("event", None)
            if event is not None:
                event.synchronize()
                rec["done"] = time.perf_counter()

    n_check = 1 + tr["check_steps"]
    ring = [system.outputs() for _ in range(2)]
    check_bufs = [system.outputs() for _ in range(n_check)]
    state = system.initial()
    for i in range(WARMUP_STEPS):
        rec, state = hand(i, state, ring[0])
        wait(rec)
    g = torch.Generator().manual_seed(int(seed) % (2 ** 63))
    check_at = sorted(float(x) for x in (0.15 + 0.8 * torch.rand(tr["check_steps"], generator=g)))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    del state

    # -- the window ----------------------------------------------------------------------------------
    run = Run(cfg=cfg, traffic=tr)
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    marks.append(("warm-up", t0))
    print("# set-up s: " + ", ".join(f"{n} {b - a:.2f}" for (_, a), (n, b) in zip([("", t_start)] + marks, marks)),
          file=sys.stderr)
    stop_at = t0 + seconds
    plan = []                                   # (start at, steps, with stacks) of the profiled stretches
    if trace:
        plan = [(t0 + 0.35 * seconds, PLAIN_TRACE_STEPS, False), (t0 + 0.65 * seconds, STACK_TRACE_STEPS, True)]
    profs, active = [], None                    # active: (profiler, last step to wait for, stacks)
    profiled = []                               # (from, to) host seconds of each profiled stretch
    state, pending, i = system.initial(), None, 0
    checked: List[Dict] = []
    while True:
        now = time.perf_counter()
        if now >= stop_at and not plan and active is None:
            break                               # a traced run goes on until its stretches are profiled
        if active is None and plan and now >= plan[0][0]:
            _, n, stacks = plan.pop(0)
            acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
            prof = torch.profiler.profile(activities=acts, with_stack=stacks)
            profiled.append([time.perf_counter(), None])
            prof.start()
            active = (prof, i + n - 1, stacks)
        is_check = len(checked) < n_check and (i == 0 or (now - t0) >= check_at[len(checked) - 1] * seconds)
        buf = check_bufs[len(checked)] if is_check else ring[i % 2]
        pre = state
        rec, state = hand(i, state, buf)
        if is_check:
            checked.append({"i": i, "pre": pre, "post": state, "out": buf})
        if pending is not None:
            wait(pending)
            run.steps.append(pending)
            if active is not None and pending["i"] >= active[1]:
                profs.append(_stop(active, name))
                profiled[-1][1] = time.perf_counter()
                active = None
        pending = rec
        i += 1
    wait(pending)
    run.steps.append(pending)
    if active is not None:
        profs.append(_stop(active, name))
        profiled[-1][1] = time.perf_counter()
    run.window_s = run.steps[-1]["done"] - t0
    run.plain_step_s = _plain_step_s(run.steps, profiled)
    attempted = sum(s["frames"] for s in run.steps)
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated()

    # -- traces ---------------------------------------------------------------------------------------
    if trace:
        run.step_flops = system.step_flops()
    for path, stacks in profs:
        tr_obj = Trace.load(path)
        if stacks:
            run.stack_trace = tr_obj
        else:
            waits = sorted(tr_obj.ranges.get("bench::wait", []))
            if len(waits) >= 2:
                run.trace, run.trace_window, run.trace_steps = tr_obj, (waits[0][1], waits[-1][1]), len(waits) - 1

    print(f"# window: {len(run.steps)} steps in {run.window_s:.3f} s; traces read in "
          f"{time.perf_counter() - run.steps[-1]['done']:.2f} s", file=sys.stderr)
    thirds = [0, 0, 0]
    for st in run.steps:
        thirds[min(2, int(3 * (st["done"] - t0) / run.window_s))] += st["frames"]
    print("# pace: frames/s by thirds of the window " + ", ".join(
        f"{n / (run.window_s / 3):.1f}" for n in thirds)
          + f"; a step {1e3 * run.plain_step_s:.1f} ms unprofiled"
          + (f", {(run.trace_window[1] - run.trace_window[0]) / 1e3 / run.trace_steps:.1f} ms profiled"
             if run.trace is not None else ""), file=sys.stderr)
    t_check = time.perf_counter()
    # -- the check: the program freed, the reference on the same inputs, weights and state -------------
    del state, pending, profs
    numbers = system.check(checked)
    print(f"# check: steps {[c['i'] for c in checked]} in {time.perf_counter() - t_check:.2f} s; readings "
          + ", ".join(f"{k} {v!r}" for k, v in numbers.items()), file=sys.stderr)
    correct = judge(numbers, limits)

    # -- metrics ------------------------------------------------------------------------------------------
    metrics = {}
    for m in cell_metrics(name, trace):
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": run.peak_bytes}}
    if trace and run.trace is not None:
        a, b = run.trace_window
        result["device"]["busy_s"] = run.trace.busy((a, b)) / 1e6
        result["device"]["window_s"] = (b - a) / 1e6
        result["breakdown"] = breakdown(run.trace, (a, b))
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in system.names if k in limits}
    result["compared"] = compared
    return result, compared


def _plain_step_s(steps: List[Dict], profiled: List[List[float]]) -> float:
    """Mean seconds between consecutive steps' outputs reaching the host, over
    the steps from whose hand-in to whose outputs no profiler ran."""
    gaps = [b["done"] - a["done"] for a, b in zip(steps, steps[1:])
            if not any(b["hand"] < q and b["done"] > p for p, q in profiled)]
    return sum(gaps) / len(gaps) if gaps else 0.0


def _stop(active, name: str):
    """Stop a profiled stretch and write its trace at once: exported after a
    later session has run, a trace's device events all read time 0."""
    prof, _, stacks = active
    prof.stop()
    path = BUILD / f"trace-{name}-{'stacks' if stacks else 'plain'}.json"
    prof.export_chrome_trace(str(path))
    return path, stacks


def breakdown(trace: Trace, window) -> Dict:
    """The ten device operations that took most time in the window, and the ten
    longest idle gaps, each named by the host range in which it began."""
    totals: Dict[str, float] = {}
    for d in trace.device:
        if d["end"] > window[0] and d["start"] < window[1]:
            totals[d["name"]] = totals.get(d["name"], 0.0) + (min(d["end"], window[1]) - max(d["start"], window[0]))
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    ops = [(n if len(n) <= NAME_CHARS else n[:NAME_CHARS] + "…", t) for n, t in ops]
    gaps = sorted(trace.gaps(window), key=lambda g: -(g[1] - g[0]))[:10]
    named = []
    for a, b in gaps:
        inside = [(s, n) for n, spans in trace.ranges.items() for s, e, _ in spans if s <= a <= e]
        inside += [(s, n) for s, e, n in trace.host_ops if s <= a <= e]
        named.append([max(inside)[1] if inside else "host", (b - a) / 1e6])
    return {"device_ops": [[n, s / 1e6] for n, s in ops], "idle_gaps": named}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the program on the card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell asks for {cell['chips']} cards, {torch.cuda.device_count()} are visible", file=sys.stderr)
        return 2
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    torch.set_num_threads(1)    # the step's work is on the card: no host thread pool to spin beside the loop
    result, compared = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    print(f"# {_power_limit()}", file=sys.stderr)
    for k, v in compared.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout holding ``BENCHMARK.json``, ``benchmark/`` and the
program (``yolo_puncture_tpu_torch``), on a machine with a CUDA card.  The cell
is ``benchmark/workloads/<cell>.json``; it names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``).  Each metric that ``BENCHMARK.json``
gives the cell is read by ``benchmark/metrics/<metric>.py``.

Set-up draws the frames and the weights from the seed on the card, builds the
program's fused seg+track step with them and runs two warm-up steps.  The
window then plays the recording for ``--seconds``: each step uploads its batch
from pinned memory, runs the step, and copies its outputs (best box, score,
valid flag, best-slot mask, id map) back into pinned memory; step i + 1 is
handed in before step i's outputs are read, so two batches are in flight, and
the tracker's memory is carried from step to step.  With ``--trace 1`` two
short stretches in the middle of the window run under ``torch.profiler``: one
plain (device busy time, the layers' device time), one with Python stacks
(which call launched each kernel).  After the window the program is freed and
the plain reference (``benchmark/reference/``, fp32, TF32 off) recomputes the
first step and ``check_steps`` more, drawn from the seed, from the same frames,
weights and memory; ``check.py`` compares them.

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

from benchmark import check, reckon, system, traffic as traffic_mod, weights  # noqa: E402
from benchmark.reference import tracker as rt  # noqa: E402
from benchmark.reference import yolo as ry  # noqa: E402
from benchmark.tracefile import Trace  # noqa: E402

IMPORTED = time.perf_counter()

HERE = Path(__file__).resolve().parent
BUILD = ROOT / "build" / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "yolo_puncture_tpu")
WARMUP_STEPS = 2
PLAIN_TRACE_STEPS, STACK_TRACE_STEPS = 3, 1
REF_BLOCK = 16
NAME_CHARS = 160            # a kernel's templated name is cut here in the breakdown


def load_cell(name: str, overrides: Optional[Dict] = None) -> Dict:
    """The cell's file with its configuration and traffic mix loaded;
    ``overrides`` = {"config": {...}, "traffic": {...}, "limits": {...}} replaces
    entries, and the limits whole (the CPU tests shrink the sizes, and set limits
    for them, so)."""
    path = HERE / "workloads" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no cell named {name!r} ({path})")
    cell = json.loads(path.read_text())
    cell["cfg"] = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    cell["tr"] = traffic_mod.load(cell["traffic"])
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
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


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


class HostEvent:
    """A CPU stand-in for ``torch.cuda.Event``: the work is done when recorded."""

    def record(self):
        pass

    def synchronize(self):
        pass


def _host_outputs(cfg: Dict, B: int, pinned: bool) -> Dict[str, torch.Tensor]:
    """Host buffers for one step's outputs: the best slot's box, score, valid
    flag and mask (letterbox resolution), and the id map (tracker resolution)."""
    size, (h, w) = cfg["detector"]["imgsz"], reckon.tracker_hw(cfg)
    shapes = {"boxes": ((B, 4), torch.float32), "scores": ((B,), torch.float32), "valid": ((B,), torch.bool),
              "mask": ((B, size, size), torch.uint8), "ids": ((B, h, w), torch.uint8)}
    return {k: torch.empty(shape, dtype=dt, pin_memory=pinned) for k, (shape, dt) in shapes.items()}


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
    compared numbers with their limits).  ``fault(step)`` may wrap the program's
    step (the tests plant faults so)."""
    t_start = PROCESS_START if t_start is None else t_start
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(name, overrides)
    cfg, tr = cell["cfg"], cell["tr"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    served = getattr(torch, cfg["dtype"])
    BUILD.mkdir(parents=True, exist_ok=True)

    # -- set-up: frames, weights, the program, warm-up ------------------------------------------------
    marks = [("python, torch", IMPORTED), ("card, cell", time.perf_counter())]
    frames = traffic_mod.frames(tr, seed, dev)
    marks.append(("frames", time.perf_counter()))
    ref_det = weights.detector(cfg, seed, frames[0][:16], dev, served)
    ref_net = weights.tracker(cfg, seed, frames[0], dev, served)
    marks.append(("weights", time.perf_counter()))
    step, mem0 = system.build(cfg, tr, weights.served_state(ref_det, served),
                              weights.served_state(ref_net, served), dev)
    marks.append(("program", time.perf_counter()))
    if fault is not None:
        step = fault(step)
    conf, B, n_batches = tr["conf"], tr["batch"], tr["distinct_batches"]
    new_event = (lambda: torch.cuda.Event()) if cuda else HostEvent

    def hand(i, mem, chk, out_buf):
        with record_function("bench::handin"):
            t_hand = time.perf_counter()
            batch = frames[i % n_batches].to(dev, non_blocking=True)
            out, mem = step(mem, batch, conf, chk)
            t_ret = time.perf_counter()
            for k, buf in out_buf.items():
                buf.copy_(out[k], non_blocking=True)
            ev = new_event()
            ev.record()
        return {"i": i, "hand": t_hand, "ret": t_ret, "event": ev, "frames": B}, out, mem

    def wait(rec):
        with record_function("bench::wait"):
            rec["event"].synchronize()
            rec["done"] = time.perf_counter()
        del rec["event"]

    n_check = 1 + tr["check_steps"]
    ring = [_host_outputs(cfg, B, cuda) for _ in range(2)]
    check_bufs = [_host_outputs(cfg, B, cuda) for _ in range(n_check)]
    chk, mem = torch.zeros((), device=dev), mem0
    for i in range(WARMUP_STEPS):
        rec, out, mem = hand(i, mem, chk, ring[0])
        wait(rec)
    g = torch.Generator().manual_seed(int(seed) % (2 ** 63))
    check_at = sorted(float(x) for x in (0.15 + 0.8 * torch.rand(tr["check_steps"], generator=g)))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    del out, mem

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
    mem, chk, pending, i = mem0, torch.zeros((), device=dev), None, 0
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
        pre = mem
        rec, out, mem = hand(i, mem, chk, buf)
        chk = out["chk"]
        if is_check:
            checked.append({"i": i, "pre": pre, "post": mem, "out": buf})
        del out
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
        run.step_flops = reckon.step_flops(cfg, tr)
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
    # -- the check: the program freed, the reference on the same frames, weights and memory ---------------
    del step, mem, mem0, chk, pending, profs
    t = cfg["tracker"]
    hw = reckon.tracker_hw(cfg)
    lt_cap = t["max_long_term_elements"] if tr["long_term"] else 8
    ref_trk = rt.Tracker(ref_net, hw, t["window"], tr["long_term"], t["num_prototypes"], t["full_res_ids"])
    frames_read, ids_read, gaps = [], [], []
    size = cfg["detector"]["imgsz"]
    for c in checked:
        f = frames[c["i"] % n_batches].to(dev)
        for a in range(0, B, REF_BLOCK):
            head = ry.head_outputs(ref_det, f[a:a + REF_BLOCK], size)
            prog = {k: v[a:a + REF_BLOCK] for k, v in c["out"].items()}
            frames_read.append(check.per_frame(prog, head, conf, ref_det.num, size))
            del head
        st = (rt.initial_state(hw[0] // 16, hw[1] // 16, t["max_objects"], t["mem_frames"], lt_cap, dev)
              if c["i"] == 0 else rt.state_from(c["pre"], dev))
        st_after, ids = ref_trk.step(st, f)
        ids_read.append(check.ids_readings(c["out"]["ids"], ids))
        gaps.append(rt.state_gap(st_after, rt.state_from(c["post"], dev)))
    numbers = check.combine(frames_read, ids_read, gaps)
    print(f"# check: steps {[c['i'] for c in checked]} in {time.perf_counter() - t_check:.2f} s; readings "
          + ", ".join(f"{k} {v!r}" for k, v in numbers.items()), file=sys.stderr)
    limits = cell["limits"]
    correct = check.judge(numbers, limits)

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
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in check.NAMES if k in limits}
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

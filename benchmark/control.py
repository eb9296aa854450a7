"""The control of the correctness check: the reference put in the program's
place, computed in fp8 (the nearest precision below the configuration's bf16),
read by the same comparison as the program.  Its readings are the upper end
of each limit; the program's readings on the same steps are the lower end.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--program] [--steps n]

For each seed it draws the cell's frames and weights, then for the first
``steps`` steps of the recording (by default as many as a run checks; the
memory carried by the fp32 reference) compares the fp8 reference with the fp32 one, with ``--program`` also the
program's step, from the same memory, on the same frames; the witness (the fp32
reference on frames one grey level off, ``check.witness_frames``) is read too,
and the detector's gaps are held against its.  One JSON line a seed.  It runs
no measured window; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import check, reckon, run as harness, traffic as traffic_mod, weights  # noqa: E402
from benchmark.systems import segtrack  # noqa: E402
from benchmark.reference import tracker as rt  # noqa: E402
from benchmark.reference import yolo as ry  # noqa: E402
from benchmark.reference.blocks import set_numerics  # noqa: E402
from benchmark.reference.numerics import Fp8Numerics  # noqa: E402


@torch.no_grad()
def readings(name: str, seed: int, device: str = "cuda", steps: Optional[int] = None, program: bool = False,
             overrides: Optional[Dict] = None) -> Dict[str, Dict[str, float]]:
    """{"control": numbers[, "program": numbers], "witness": numbers} over the
    first ``steps`` steps; the witness is the fp32 reference itself on the frames
    with one grey level added to a third of the pixels: how far the network moves
    under a change far below any rounding of the program's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(name, overrides)
    cfg, tr = cell["cfg"], cell["tr"]
    steps = 1 + tr["check_steps"] if steps is None else steps
    dev = torch.device(device)
    served = getattr(torch, cfg["dtype"])
    frames = traffic_mod.frames(tr, seed, dev)
    det32 = weights.detector(cfg, seed, frames[0][:16], dev, served)
    net32 = weights.tracker(cfg, seed, frames[0], dev, served)
    det8 = set_numerics(copy.deepcopy(det32), Fp8Numerics())
    net8 = set_numerics(copy.deepcopy(net32), Fp8Numerics())
    t = cfg["tracker"]
    hw = reckon.tracker_hw(cfg)
    lt_cap = t["max_long_term_elements"] if tr["long_term"] else 8
    mk = lambda net: rt.Tracker(net, hw, t["window"], tr["long_term"], t["num_prototypes"], t["full_res_ids"])  # noqa: E731
    trk32, trk8 = mk(net32), mk(net8)
    prog_step = mem = None
    if program:
        prog_step, mem = segtrack.build(cfg, tr, weights.served_state(det32, served),
                                        weights.served_state(net32, served), dev)
    st = rt.initial_state(hw[0] // 16, hw[1] // 16, t["max_objects"], t["mem_frames"], lt_cap, dev)
    reads = {"control": ([], [], []), "program": ([], [], []), "witness": ([], [], [])}
    chk = torch.zeros((), device=dev)
    size = cfg["detector"]["imgsz"]
    for i in range(steps):
        f = frames[i % tr["distinct_batches"]].to(dev)
        st_after, ids = trk32.step(st, f)
        ctl_after, ctl_ids = trk8.step(st, f)
        outs = {"control": (_best_slot(det8, f, cfg, tr), ctl_ids, ctl_after)}
        fp = check.witness_frames(f, seed)
        wit_after, wit_ids = trk32.step(st, fp)
        outs["witness"] = (_best_slot(det32, fp, cfg, tr), wit_ids, wit_after)
        if program:
            pre = mem if i == 0 else _program_memory(mem, st)
            out, mem = prog_step(pre, f, tr["conf"], chk)
            outs["program"] = (out, out["ids"], rt.state_from(mem, dev))
        for who, (out, out_ids, after) in outs.items():
            fr, idr, gp = reads[who]
            for a in range(0, f.shape[0], segtrack.REF_BLOCK):
                head = ry.head_outputs(det32, f[a:a + segtrack.REF_BLOCK], size)
                fr.append(check.per_frame({k: v[a:a + segtrack.REF_BLOCK] for k, v in out.items() if k != "chk"},
                                          head, tr["conf"], det32.num, size))
            idr.append(check.ids_readings(out_ids, ids))
            gp.append(rt.state_gap(st_after, after))
        st = st_after
    out = {k: check.combine(*v) for k, v in reads.items() if v[0]}
    for who in ("control", "program"):
        if who in out:
            out[who].update(check.witness_ratios(out[who], out["witness"]))
    return out


def _best_slot(model, f, cfg, tr):
    """``segtrack.reference_best_slot`` over the step's frames in blocks of ``REF_BLOCK``."""
    out = {}
    for a in range(0, f.shape[0], segtrack.REF_BLOCK):
        for k, v in segtrack.reference_best_slot(model, f[a:a + segtrack.REF_BLOCK], cfg, tr).items():
            out.setdefault(k, []).append(v)
    return {k: torch.cat(v) for k, v in out.items()}


def _program_memory(mem, st: rt.TrackerState):
    """The program's memory holding the reference's state, in the program's types,
    so that each checked step starts from the same memory on both sides."""
    dt = mem.keys.dtype
    return mem._replace(keys=st.keys.to(dt), values=st.values.to(dt), sensory=st.sensory.to(mem.sensory.dtype),
                        valid=torch.tensor(st.valid, device=mem.valid.device), write_pos=st.write_pos,
                        usage=st.usage.clone(), lt_keys=st.lt_keys.to(mem.lt_keys.dtype),
                        lt_values=st.lt_values.to(mem.lt_values.dtype), lt_valid=st.lt_valid.clone(),
                        lt_pos=st.lt_pos, active=st.active.clone(), frame_idx=st.frame_idx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=None, help="steps read (default: as many as a run checks)")
    ap.add_argument("--program", action="store_true", help="read the program's step beside the control")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(args.workload, seed, "cuda", args.steps, args.program)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Experiments on the port's hand-written kernels ``proto_decode`` and ``decode_tail``,
on one NVIDIA GPU, with ``chip_smoke.py``'s cases, limits and timers.

    python3 scripts/kernel_experiments_torch.py check      # build (nvcc -Xptxas -v), each kernel against its plain version
    python3 scripts/kernel_experiments_torch.py time       # both kernels at the main path's shapes, and per stage
    python3 scripts/kernel_experiments_torch.py variants   # edited copies of the sources: error and time of each

``check`` is what a new kernel's first call on the card should be.  ``variants``
copies the package to a temporary directory once per variant, edits one source
there (the repository's files are never touched), builds it and reports how far
the kernel is from its plain version and how long it takes: copies that must
fail their limit (the decode tail on a single TF32 product; the proto decode
with the ragged last vector of P unwritten) and copies that show what a design
step buys (an IEEE reciprocal in the sigmoid; loads or stores compiled out; a
running accumulator in the fp32 tail).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOAD = "load_vec(pb + static_cast<size_t>(m) * P + p0, pr[m]);"
STORE = "store_vec(dst, v);"
NO_LOAD = (LOAD, "{ pr[m][0] = 0.01f * threadIdx.x; pr[m][1] = 0.02f * m; pr[m][2] = 0.03f; pr[m][3] = 0.04f; }")
NO_STORE = (STORE, "if (v[0] + v[3] == -123.f) " + STORE)
# (name, kernel, source, [(old, new), ...], what it shows)
VARIANTS = [
    ("as shipped", "proto", "proto_decode.cu", [], "the reference point"),
    ("ragged tail unwritten", "proto", "proto_decode.cu",
     [("if (p0 + e < P) store_one(dst + e, v[e]);", "if (p0 + PX <= P) store_one(dst + e, v[e]);")],
     "must fail where P % 4 != 0"),
    ("IEEE reciprocal", "proto", "proto_decode.cu",
     [("__fdividef(1.f, 1.f + __expf(-acc[e]))", "__frcp_rn(1.f + __expf(-acc[e]))")], "what rcp.approx buys"),
    ("no loads", "proto", "proto_decode.cu", [NO_LOAD], "time without the proto loads (results wrong)"),
    ("no stores", "proto", "proto_decode.cu", [NO_STORE], "time without the mask stores (results wrong)"),
    ("no loads, no stores", "proto", "proto_decode.cu", [NO_LOAD, NO_STORE], "the arithmetic alone (results wrong)"),
    ("as shipped", "tail", "decode_tail.cu", [], "the reference point"),
    ("single TF32 product", "tail", "decode_tail.cu",
     [("for (int prod = 0; prod < 3; ++prod)", "for (int prod = 2; prod < 3; ++prod)")], "must fail 2e-4"),
    ("running accumulator", "tail", "decode_tail.cu",
     [("wgmma_tf32(part[t],", "wgmma_tf32(acc[t],"), ("acc[t][i] += part[t][i];", "acc[t][i] += 0.f * part[t][i];")],
     "what the from-zero sums cost and buy"),
]


def setup():
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("kernel_experiments_torch: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch, cs, torch.device("cuda")


def guarded(fn, *args):
    """``fn(*args)``, an AssertionError printed instead of raised."""
    try:
        return fn(*args)
    except AssertionError as e:
        print(f"  FAILS: {e}", flush=True)
        return None


def time_proto(torch, cs, device):
    from yolo_puncture_tpu_torch.ops.kernels import proto_decode as pd

    launch = pd.kernel_fn()
    for B in (4, 1):
        protos, coeffs, boxes = cs.proto_decode_inputs(B, 32, 160, 160, 32, 7, device)
        out = torch.empty((B, 32, 160, 160), dtype=torch.float32, device=device)
        pflat = protos.reshape(B, 32, -1)

        def raw(threshold):
            a = pd.kernel_args(protos, coeffs, boxes, out, threshold, True)
            return lambda: launch(*a)

        ev = cs.interleaved_times_ms({"kernel": raw(None), "matmul": lambda: torch.matmul(coeffs, pflat)}, repeats=3)
        gr = {n: sorted(cs.graph_time_ms(m) for _ in range(3))
              for n, m in (("kernel", lambda: raw(None)), ("kernel by logit", lambda: raw(0.5)),
                           ("matmul", lambda: (lambda: torch.matmul(coeffs, pflat))))}
        print(f"proto_decode B={B} N=32 160x160 ms: launched " + ", ".join(f"{n} {t[1]:.5f}" for n, t in ev.items())
              + "; from a CUDA graph " + ", ".join(f"{n} {t[1]:.5f}" for n, t in gr.items()), flush=True)


def time_tail(torch, cs, device, per_stage=True):
    from yolo_puncture_tpu_torch.ops.kernels import decode_tail as dt

    net = cs.needle_network(device)
    for Nf, dtype in ((5, torch.float32), (1, torch.float32), (5, torch.bfloat16), (1, torch.bfloat16)):
        params = net.decoder.tail_params(dtype)
        hidden, f8p, f4p = cs.tail_inputs(Nf, 4, 30, 54, dtype, 13, device)
        oskip = dt.skip_plane(params, f4p)
        y8 = torch.empty((Nf * 4, 60, 108, 64), dtype=dtype, device=device)
        out = torch.empty((Nf, 4, 120, 216), dtype=torch.float32, device=device)
        args, launch = dt.kernel_args(params, hidden, f8p, oskip, y8, out), dt.kernel_fn()
        ms = sorted(cs.cuda_time_ms(lambda: launch(*args), iters=50, warmup=5) for _ in range(3))
        print(f"decode_tail N={Nf} No=4 30x54 {str(dtype)[6:]}: {ms[1]:.4f} ms ({ms[0]:.4f}-{ms[2]:.4f})", flush=True)
    if per_stage:  # the two stages apart, by kernel name
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            for dtype in (torch.float32, torch.bfloat16):
                params = net.decoder.tail_params(dtype)
                hidden, f8p, f4p = cs.tail_inputs(5, 4, 30, 54, dtype, 13, device)
                for _ in range(3):
                    dt.decode_tail(params, hidden, f8p, f4p)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if "tail_stage_kernel" in e.key:
                total = getattr(e, "device_time_total", None) or e.cuda_time_total
                print(f"  {e.key[:70]}: {total / e.count / 1e3:.4f} ms a launch", flush=True)


def child(kernel: str) -> None:
    """In a copy: every case of the kernel against its plain version, then its time."""
    torch, cs, device = setup()
    if kernel == "proto":
        for i, case in enumerate(cs.PROTO_CASES):
            guarded(cs.check_proto_decode_case, case, device, 100 + i)
        time_proto(torch, cs, device)
    else:
        net = cs.needle_network(device)
        for i, case in enumerate(cs.TAIL_CASES):
            guarded(cs.check_decode_tail_case, net.decoder.tail_params(torch.float32), case, device, 300 + i)
        time_tail(torch, cs, device, per_stage=False)


def variants() -> None:
    setup()
    for name, kernel, source, edits, why in VARIANTS:
        with tempfile.TemporaryDirectory() as d:
            for item in ("chip_smoke.py", "yolo_puncture_tpu_torch", "scripts"):
                src = os.path.join(ROOT, item)
                (shutil.copytree if os.path.isdir(src) else shutil.copy)(src, os.path.join(d, item))
            os.makedirs(os.path.join(d, "resources", "weights"))
            shutil.copy(os.path.join(ROOT, "resources", "weights", "tracker_propagation_needle.msgpack"),
                        os.path.join(d, "resources", "weights"))
            path = os.path.join(d, "yolo_puncture_tpu_torch", "csrc", source)
            text = open(path).read()
            for old, new in edits:
                if old not in text:
                    sys.exit(f"variant '{name}': '{old}' is not in {source}")
                text = text.replace(old, new)
            open(path, "w").write(text)
            print(f"=== {source}, {name} ({why})", flush=True)
            r = subprocess.run([sys.executable, os.path.join(d, "scripts", os.path.basename(__file__)), "_child", kernel],
                               cwd=d, capture_output=True, text=True)
            keep = [ln for ln in r.stdout.splitlines()
                    if "FAILS" in ln or " ms" in ln or (kernel == "tail" and "max abs diff" in ln)]
            print("\n".join(keep) if r.returncode == 0 else r.stdout[-2000:] + r.stderr[-2000:], flush=True)


def main() -> int:
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what == "_child":
        child(sys.argv[2])
    elif what == "variants":
        variants()
    elif what in ("check", "time"):
        torch, cs, device = setup()
        from yolo_puncture_tpu_torch import _build

        _build.build_all(verbose=True)
        if what == "check":
            print("proto_decode: largest soft difference", cs.check_proto_decode(device))
            print("decode_tail: largest difference", cs.check_decode_tail(cs.needle_network(device), device))
        else:
            time_proto(torch, cs, device)
            time_tail(torch, cs, device)
    else:
        sys.exit(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""How far CUPTI's kernel timestamps stray from the host's clock inside a
``torch.profiler`` session on the card, and what that costs a trace.

Runs sessions of ``--calls`` one-kernel calls, alternately in a bare
``torch.profiler.profile`` (the block starts as the recording window opens)
and in the port's ``device_trace`` (a warm-up step, then ``WINDOW_PAD_S`` on
either side of the block), with 0 and then ``--load`` busy host processes
beside them, in a fresh process: the misplaced first records that the
warm-up step absorbs show only late in a long one (``chip_smoke.py``'s
``tracing`` line holds both defences there). For each session it reads the
exported trace: the kernel records, the launch records, and the least gap
from a launch to its kernel (matched by correlation id; a negative gap puts
the kernel before its own launch). Prints one JSON line per load and kind,
then the card's name and power limit.

    python tools/trace_window_probe.py [--sessions 40] [--calls 20] [--load 16]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from video_transformer_tpu_torch.utils.tracing import WARMUP_LAUNCHES, WINDOW_PAD_S, device_trace  # noqa: E402


def read_trace(path: Path) -> dict:
    events = json.loads(path.read_text(encoding="utf-8"))["traceEvents"]
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e.get("name", "")}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    gaps = [float(k["ts"]) - launches[k["args"]["correlation"]] for k in kernels
            if k.get("args", {}).get("correlation") in launches]
    return {"kernels": len(kernels), "launches": len(launches), "least_gap_us": min(gaps) if gaps else None}


def session(kind: str, calls: int, out: Path) -> dict:
    x = torch.zeros(1024, device="cuda")
    torch.cuda.synchronize()
    if kind == "bare":
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                x.add_(1)
            torch.cuda.synchronize()
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
    else:
        with device_trace(out):
            for _ in range(calls):
                x.add_(1)
            torch.cuda.synchronize()
    return read_trace(out / "trace.json")


def summarize(rows: list[dict], calls: int) -> dict:
    gaps = sorted(r["least_gap_us"] for r in rows if r["least_gap_us"] is not None)
    return {"sessions": len(rows), "all_kernels": sum(r["kernels"] == calls for r in rows),
            "some_lost": sum(0 < r["kernels"] < calls for r in rows), "none": sum(r["kernels"] == 0 for r in rows),
            "launches_recorded": sum(r["launches"] == calls for r in rows),
            "least_gap_us": gaps[0] if gaps else None, "median_least_gap_us": gaps[len(gaps) // 2] if gaps else None,
            "negative_gap_sessions": sum(g < 0 for g in gaps)}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sessions", type=int, default=40, help="sessions of each kind under each load")
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--load", type=int, default=16, help="busy host processes in the second round")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_window_probe: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        for load in (0, args.load):
            hogs = [subprocess.Popen([sys.executable, "-c", "while 1: pass"]) for _ in range(load)]
            try:
                rows: dict[str, list[dict]] = {"bare": [], "device_trace": []}
                for i in range(args.sessions):
                    for kind in rows:
                        rows[kind].append(session(kind, args.calls, Path(tmp) / f"{kind}_{load}_{i}"))
            finally:
                for hog in hogs:
                    hog.kill()
                    hog.wait()
            for kind, kind_rows in rows.items():
                print(json.dumps({"load": load, "kind": kind, "calls": args.calls, "window_pad_s": WINDOW_PAD_S,
                                  "warmup_launches": WARMUP_LAUNCHES,
                                  **summarize(kind_rows, args.calls)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

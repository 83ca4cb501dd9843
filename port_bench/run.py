#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result as the last line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names the entry
(``entries/<name>.py``) that drives one call of the program. The run makes the pool
from the seed, builds what the entry needs, warms up, then calls the program in a
closed loop (one caller, the next call when the last returns) for ``--seconds``.
With ``--trace 0`` it reports the cell's end-to-end metrics: the mix's rate (bytes
of the calls over all the time of the window) and ``setup_s`` (process start to the
first timed call); the result's ``setup`` says whether the run compiled the kernel
library and how long that took, so that a checkout's first run is told apart. With
``--trace 1`` the window runs under ``torch.profiler`` and it reports the cell's
per-layer metrics, each read by ``layer_metrics/<metric>.py``.
Either way a seeded sample of the window's answers is compared with the plain
reference once the window has closed; each number compared is printed with its
limit, on the last lines of standard error and under ``checks`` in the result.

Exits non-zero with no result where there is no CUDA card or fewer than the cell
asks for, where a JAX module or the JAX package is loaded, or where a set-up step
fails.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import imports, stats, stream, trace as trace_lib  # noqa: E402

imports.check_loaded("harness import")

# the program's caches, at fixed paths inside the checkout
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / _dir)

STAGE_PASS_CALLS = 3


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's configuration, mix and metrics, found by name in ``bench``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"port_bench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    mix = load_json(bench_dir(root) / "traffic" / f"{cell['traffic']}.json")

    def listed(m):
        return "workloads" not in m or workload in m["workloads"]
    return {"cell": cell, "config": config, "mix": mix,
            "end_to_end": [m for m in bench["end_to_end"] if listed(m)],
            "per_layer": [m for m in bench["per_layer"] if listed(m)]}


def bench_dir(root: Path) -> Path:
    """The benchmark's folder in the checkout at ``root``."""
    return root / HERE.name


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
             "clocks.mem,temperature.gpu,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def window(call, calls, seconds: float, keep, cell, device, call_files: list) -> dict:
    """The closed loop: calls until ``seconds`` have passed; each call's answers kept
    when ``keep`` says so."""
    import torch

    total = attempted = failed = 0
    kept, errors, call_s = [], [], []
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        files = next(calls)
        attempted += len(files)
        t = time.perf_counter()
        try:
            with torch.profiler.record_function("port_bench.call"):
                answers = call(files)
        except Exception:  # a failed call counts its files as failed; the loop goes on
            failed += len(files)
            if not errors:
                errors.append(traceback.format_exc())
            answers = None
        else:
            total += cell.call_bytes(files)
        call_s.append(time.perf_counter() - t)
        call_files.append(files)
        if answers is not None and keep(cell.answer_bytes(answers)):
            kept.append((files, answers))
        # ``answers`` stays referenced until the next call returns, as a caller that
        # consumes a window's results while the next is processed holds them
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - start
    return {"bytes": total, "seconds": elapsed, "calls": len(call_s),
            "kept_bytes": sum(cell.answer_bytes(a) for _, a in kept),
            "attempted": attempted, "failed": failed, "kept": kept, "errors": errors,
            # single calls on the host's clock: printed, never a metric
            "call_ms_p50": 1000 * stats.percentile(call_s, 50),
            "call_ms_p95": 1000 * stats.percentile(call_s, 95),
            "call_ms_max": 1000 * max(call_s)}


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             control: str = None, root: Path = ROOT, t0: float = None) -> dict:
    """One run of a resolved cell on ``device``; -> the result's fields (and
    ``setup`` parts, ``checks``). ``control`` puts the reference in the program's
    place."""
    import torch

    t0 = T0 if t0 is None else t0
    config, mix = spec["config"], spec["mix"]
    entry = load_module(bench_dir(root) / "entries" / f"{mix['entry']}.py",
                        f"port_bench_entry_{mix['entry']}")
    cell = entry.Cell(config, mix, seed, device, trace)
    parts = {"imports_s": time.perf_counter() - t0}
    t = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        from dxt_lossless_transform_tpu_torch import backend
        parts["cuda_init_s"] = time.perf_counter() - t
        t = time.perf_counter()
        # the checkout's first run compiles the kernel library: recorded apart
        parts["library_built"] = not backend.library_path().exists()
        backend.library()
        parts["library_s"] = time.perf_counter() - t
        t = time.perf_counter()
    cell.make_pool()
    parts["pool_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cell.reference_setup()
    parts["reference_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cell.program_setup()
    call = cell.call if control is None else cell.control(control)
    calls = stream.calls(cell.sizes, mix, seed)
    warm = None
    for files in cell.warmup_calls(calls):
        # each call's answers held until the next returns, as the window holds them,
        # and the last through the window, so that the host heap enters it grown
        warm = call(files)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    parts["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0

    call_files = []
    keep = stream.keeper(mix, seed)
    run = lambda: window(call, calls, seconds, keep, cell, device, call_files)  # noqa: E731
    if trace:
        win, events = trace_lib.profile(run, device)
    else:
        win = run()
    memory_peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                   else 0)
    records = None
    if trace:
        records = trace_lib.reduce(events)
        records["bound_s"] = sum(cell.bound_seconds(f) for f in call_files)
        records["bytes"] = win["bytes"]
        if hasattr(cell, "stage_pass") and control is None:
            records.update(cell.stage_pass(calls, STAGE_PASS_CALLS))
    imports.check_loaded("after the window")
    del warm

    cell.release()
    del call
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.check(win["kept"])
    correct = win["failed"] == 0 and all(
        (v <= lim) if kind == "max" else (v >= lim) for v, kind, lim in checks.values())

    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            reader = load_module(bench_dir(root) / "layer_metrics" / f"{m['name']}.py",
                                 f"port_bench_metric_{m['name']}")
            value = reader.read(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rate_name = mix["rate_metric"]
        for m in spec["end_to_end"]:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == rate_name and win["seconds"] > 0:
                metrics[rate_name] = {"value": stats.rate_mb_per_s(win["bytes"],
                                                                   win["seconds"]),
                                      "unit": m["unit"]}
    return {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
            "metrics": metrics, "memory_peak_bytes": memory_peak, "records": records,
            "setup": dict(parts, setup_s=setup_s), "window": {
                k: v for k, v in win.items() if k not in ("kept", "errors")},
            "errors": win["errors"],
            "checks": {k: {"value": v, kind: lim} for k, (v, kind, lim) in checks.items()}}


def result_line(res: dict, device, trace: bool) -> dict:
    import torch

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
           "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"], "device": dev}
    if trace:
        rec = res["records"]
        dev["busy_s"], dev["window_s"] = rec["busy_s"], rec["window_s"]
        out["breakdown"] = {"device_ops": rec["device_ops"], "idle_gaps": rec["idle_gaps"]}
    setup = res["setup"]
    built = bool(setup.get("library_built"))
    # set-up with the kernel library's build apart: the build, and the rest
    out["setup"] = {"library_built": built,
                    "build_s": setup.get("library_s", 0.0) if built else 0.0,
                    "setup_without_build_s": setup["setup_s"]
                    - (setup.get("library_s", 0.0) if built else 0.0)}
    out["checks"] = res["checks"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    spec = resolve(bench, args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    res = run_cell(spec, args.seed, args.seconds, bool(args.trace), device)
    print(json.dumps({"card": card_line(), "workload": args.workload, "seed": args.seed,
                      "setup": res["setup"], "window": res["window"],
                      **({"records": {k: v for k, v in res["records"].items()
                                      if k not in ("device_ops", "idle_gaps")}}
                         if res["records"] else {})}), flush=True)
    for err in res["errors"]:
        print(err, file=sys.stderr)
    imports.check_loaded("before the result")
    for name, c in res["checks"].items():
        limit = " ".join(f"{k} {v}" for k, v in c.items() if k != "value")
        print(f"check {name}: {c['value']} ({limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result_line(res, device, bool(args.trace))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

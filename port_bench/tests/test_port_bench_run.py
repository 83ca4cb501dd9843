"""A whole run of each cell on the CPU at a small size, with the program, with each
control in its place, and with its timed path broken underneath."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from port_bench import run

CPU = torch.device("cpu")
BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def small(spec: dict) -> dict:
    spec["config"] = dict(spec["config"], sizes=[[64, 3], [32, 3], [16, 2]])
    if "bytes" in spec["mix"]["cut"]:
        spec["mix"] = dict(spec["mix"], cut={"bytes": 60_000})
    return spec


def run_small(name, trace=False, control=None, root=run.ROOT, seconds=0.5, seed=2 ** 31 + 3):
    spec = small(run.resolve(run.load_json(root / "BENCHMARK.json"), name, root))
    return run.run_cell(spec, seed, seconds, trace, CPU, control=control, root=root,
                        t0=time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct_and_its_line_has_the_contract_keys(name, trace, monkeypatch):
    res = run_small(name, trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, \
        (res["checks"], res["errors"][:1])
    assert res["checks"]["compared"]["value"] > 0
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "test card")
    line = json.loads(json.dumps(run.result_line(res, CPU, trace)))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    spec = run.resolve(BENCH, name)
    assert line["setup"]["library_built"] is False and line["setup"]["build_s"] == 0
    assert line["setup"]["setup_without_build_s"] == pytest.approx(res["setup"]["setup_s"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device ran: the readers of device metrics find nothing and say so
        for m in ("kernels.build_roofline", "device.build_idle"):
            assert m not in line["metrics"]
    else:
        want = {m["name"] for m in spec["end_to_end"]}
        assert set(line["metrics"]) == want
        for m in line["metrics"].values():
            assert m["value"] > 0 and m["unit"]


@pytest.mark.parametrize("name", CELLS)
def test_every_control_comes_out_not_correct(name):
    entry = run.load_module(run.bench_dir(run.ROOT) / "entries" /
                            f"{run.resolve(BENCH, name)['mix']['entry']}.py", "e")
    assert entry.CONTROLS
    for control in entry.CONTROLS:
        assert run_small(name, control=control)["correct"] is False, control


def _break(monkeypatch, name, how):
    """Break the timed path underneath the harness."""
    from dxt_lossless_transform_tpu_torch.parallel import pipeline

    real = pipeline.BatchProcessor.process

    def process(self, payloads):
        out = real(self, payloads)
        if how == "altered":
            r = out[len(out) // 2]
            out[len(out) // 2] = pipeline.BatchResult(
                r.index, bytes([r.transformed[0] ^ 1]) + r.transformed[1:], r.settings)
            return out
        return out[: len(out) // 2]  # half of the batch left out
    monkeypatch.setattr(pipeline.BatchProcessor, "process", process)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("how", ["altered", "half"])
def test_a_broken_timed_path_comes_out_not_correct(name, how, monkeypatch):
    _break(monkeypatch, name, how)
    res = run_small(name)
    assert res["correct"] is False
    bad = sum(c["value"] for k, c in res["checks"].items() if k != "compared")
    assert bad > 0


def test_a_new_mix_is_new_files_only(tmp_path):
    """A traffic mix, a configuration and a cell added as data files and entries in
    BENCHMARK.json, with no file of the benchmark edited."""
    shutil.copytree(run.ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "port_bench" / "traffic" / "build-pairs.json").write_text(json.dumps(
        {"entry": "batch_transform", "rate_metric": "build_MBps", "order": "passes",
         "cut": {"files": 2}, "max_batch": 64, "warmup_calls": 1,
         "check_share": 1.0, "check_bytes": 1 << 30}))
    if not any(c["name"] == "bc1-skyrim-mods" for c in bench["configs"]):
        bench["configs"].append({"name": "bc1-skyrim-mods", "source": "upstream's BC1 corpus",
                                 "file": "port_bench/configs/bc1-skyrim-mods.json",
                                 "reduced": ["files"], "why": "BC1"})
    bench["workloads"].append({"name": "bc1-skyrim-mods.build-pairs",
                               "config": "bc1-skyrim-mods", "traffic": "build-pairs",
                               "chips": 1, "why": "two files a call"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("bc1-skyrim-mods.build-pairs")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_small("bc1-skyrim-mods.build-pairs", root=tmp_path)
    assert res["correct"] and res["attempted"] % 2 == 0
    assert set(res["metrics"]) == {"build_MBps", "setup_s"}


def test_no_card_exits_non_zero_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=run.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_on_the_card(name, cuda_device):
    spec = small(run.resolve(BENCH, name))
    res = run.run_cell(spec, 7, 1.0, True, cuda_device, t0=time.perf_counter())
    assert res["correct"] and res["records"]["busy_s"] > 0

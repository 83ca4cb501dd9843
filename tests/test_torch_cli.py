"""The port's CLI (``dxt_lossless_transform_tpu_torch.cli``) on the CPU: the
counterpart of every case of ``tests/test_cli.py``, and the port's trees against the
JAX CLI's, byte for byte, in both directions."""

import pytest

from dxt_lossless_transform_tpu.cli.main import main as jax_main
from dxt_lossless_transform_tpu.utils import testgen
from dxt_lossless_transform_tpu_torch import backend
from dxt_lossless_transform_tpu_torch.cli import main as cli_main
from dxt_lossless_transform_tpu_torch.errors import DeviceUnavailableError
from dxt_lossless_transform_tpu_torch.parallel import pipeline

PRESETS = ["low", "medium", "optimal", "max"]


def main(argv):
    return cli_main.main(["--device", "cpu", *argv])


def tree_files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in root.rglob("*") if p.is_file()}


@pytest.fixture()
def tree(tmp_path):
    src = tmp_path / "in"
    (src / "sub").mkdir(parents=True)
    (src / "a.dds").write_bytes(testgen.make_dds("BC1", 32, 32, seed=1))
    (src / "sub" / "b.dds").write_bytes(testgen.make_dds("BC3", 16, 16, seed=2))
    (src / "junk.txt").write_bytes(b"not a dds")
    return tmp_path


@pytest.fixture()
def mixed(tmp_path):
    """BC1-BC5 (with mip chains), BC7, BC6H and the three RGB layouts, and junk."""
    src = tmp_path / "mixed"
    (src / "sub").mkdir(parents=True)
    for i, fmt in enumerate(["BC1", "BC2", "BC3", "BC4", "BC5"]):
        (src / f"{fmt}.dds").write_bytes(testgen.make_dds(fmt, 64, 32, 3, seed=i))
        (src / "sub" / f"{fmt}_small.dds").write_bytes(
            testgen.make_dds(fmt, 16, 16, seed=10 + i))
    for i, fmt in enumerate(["BC7", "BC6H"]):
        (src / f"{fmt}.dds").write_bytes(testgen.make_dx10_dds(fmt, 64, 64, 2, seed=20 + i))
    for i, layout in enumerate(["rgba8888", "bgra8888", "bgr888"]):
        (src / f"{layout}.dds").write_bytes(
            testgen.make_uncompressed_dds(layout, 32, 24, seed=30 + i))
    (src / "junk.txt").write_bytes(b"not a dds")
    return src


@pytest.mark.parametrize("preset", PRESETS)
def test_cli_roundtrip_tree(tree, preset):
    src, out, back = tree / "in", tree / "out", tree / "back"
    rc = main(["transform", str(src), str(out), "--preset", preset])
    assert rc == 1  # junk.txt fails -> nonzero, but DDS files processed
    assert (out / "a.dds").exists() and (out / "sub" / "b.dds").exists()
    assert not (out / "junk.txt").exists()
    rc = main(["untransform", str(out), str(back)])
    assert rc == 0
    assert (back / "a.dds").read_bytes() == (src / "a.dds").read_bytes()
    assert (back / "sub" / "b.dds").read_bytes() == (src / "sub" / "b.dds").read_bytes()


def test_cli_single_file(tree):
    src = tree / "in" / "a.dds"
    out = tree / "single.t"
    back = tree / "single.dds"
    assert main(["transform", str(src), str(out), "--preset", "low"]) == 0
    assert main(["untransform", str(out), str(back)]) == 0
    assert back.read_bytes() == src.read_bytes()


def test_cli_batched_transform_matches_per_file(tree):
    src = tree / "in"
    out_b, out_f, back = tree / "outb", tree / "outf", tree / "backb"
    assert main(["transform", str(src), str(out_b), "--preset", "medium",
                 "--batch"]) == 1  # junk.txt still fails per-file
    assert main(["transform", str(src), str(out_f), "--preset", "medium",
                 "--no-batch"]) == 1
    for rel in ("a.dds", "sub/b.dds"):
        assert (out_b / rel).read_bytes() == (out_f / rel).read_bytes(), rel
    assert main(["untransform", str(out_b), str(back)]) == 0
    for rel in ("a.dds", "sub/b.dds"):
        assert (back / rel).read_bytes() == (src / rel).read_bytes(), rel


@pytest.mark.parametrize("preset", ["optimal", "max"])
def test_cli_batched_zstd_presets_match_per_file(tree, preset):
    src = tree / "in"
    out_b, out_f, back = tree / "outbz", tree / "outfz", tree / "backz"
    assert main(["transform", str(src), str(out_b), "--preset", preset]) == 1
    assert main(["transform", str(src), str(out_f), "--preset", preset,
                 "--no-batch"]) == 1
    for rel in ("a.dds", "sub/b.dds"):
        assert (out_b / rel).read_bytes() == (out_f / rel).read_bytes(), rel
    assert main(["untransform", str(out_b), str(back)]) == 0
    for rel in ("a.dds", "sub/b.dds"):
        assert (back / rel).read_bytes() == (src / rel).read_bytes(), rel


def test_cli_batches_bc1(tree, monkeypatch):
    """BC1's format tag is 0; the classification still sends BC1 files to the
    batch (the JAX CLI's truth test sends them per file, with the same bytes)."""
    made = []
    original = cli_main._batch_processors_for_preset

    def recording(*args, **kwargs):
        make = original(*args, **kwargs)
        return lambda fmt: made.append(fmt) or make(fmt)

    monkeypatch.setattr(cli_main, "_batch_processors_for_preset", recording)
    assert main(["transform", str(tree / "in"), str(tree / "out"), "--preset",
                 "medium"]) == 1
    assert sorted(made) == ["bc1", "bc3"]


def test_cli_batched_bc7_dx10_tree(tmp_path):
    src = tmp_path / "in7"
    src.mkdir()
    for i in range(4):
        (src / f"t{i}.dds").write_bytes(testgen.make_dx10_dds("BC7", 64, 64, seed=i))
    (src / "h.dds").write_bytes(testgen.make_dx10_dds("BC6H", 32, 32, seed=9))
    out, back = tmp_path / "out7", tmp_path / "back7"
    assert main(["transform", str(src), str(out), "--preset", "medium",
                 "--batch"]) == 0
    assert main(["untransform", str(out), str(back)]) == 0
    for f in src.iterdir():
        assert (back / f.name).read_bytes() == f.read_bytes(), f.name


def test_cli_batched_untransform_matches_per_file(tree, monkeypatch):
    """The load path: batched untransform (default) agrees byte-for-byte with
    --no-batch and restores the originals, with streaming windows forced small
    (several flushes) and batches of two."""
    src = tree / "in"
    (src / "big.dds").write_bytes(testgen.make_dds("BC1", 128, 128, seed=5))
    (src / "big2.dds").write_bytes(testgen.make_dds("BC2", 128, 128, seed=6))
    out = tree / "outu"
    assert main(["transform", str(src), str(out), "--preset", "low"]) == 1
    monkeypatch.setattr(cli_main, "_STREAM_WINDOW_BYTES", 1 << 12)
    back_b, back_f = tree / "backub", tree / "backuf"
    assert main(["untransform", str(out), str(back_b), "--batch",
                 "--max-batch", "2"]) == 0
    assert main(["untransform", str(out), str(back_f), "--no-batch"]) == 0
    for rel in ("a.dds", "sub/b.dds", "big.dds", "big2.dds"):
        assert (back_b / rel).read_bytes() == (back_f / rel).read_bytes(), rel
        assert (back_b / rel).read_bytes() == (src / rel).read_bytes(), rel


def test_cli_transform_stream_windows(tree, monkeypatch):
    """Transform batch path with a window of one byte (a flush per file): the
    outputs equal those of one window."""
    monkeypatch.setattr(cli_main, "_STREAM_WINDOW_BYTES", 1)
    src = tree / "in"
    out_w, out_f = tree / "outw", tree / "outwf"
    assert main(["transform", str(src), str(out_w), "--preset", "medium"]) == 1
    monkeypatch.setattr(cli_main, "_STREAM_WINDOW_BYTES", 256 << 20)
    assert main(["transform", str(src), str(out_f), "--preset", "medium"]) == 1
    for rel in ("a.dds", "sub/b.dds"):
        assert (out_w / rel).read_bytes() == (out_f / rel).read_bytes(), rel


@pytest.mark.parametrize("batch", ["--batch", "--no-batch"])
def test_cli_untransform_corrupt_file_isolated(tree, batch, capsys):
    """A truncated transformed file fails alone, with a typed error; every healthy
    file in the tree restores byte-exactly."""
    src, out, back = tree / "in", tree / "outc", tree / "backc"
    assert main(["transform", str(src), str(out), "--preset", "low"]) == 1
    good = (out / "a.dds").read_bytes()
    (out / "a_trunc.dds").write_bytes(good[: len(good) // 2])
    capsys.readouterr()
    assert main(["untransform", str(out), str(back), batch]) == 1
    err = capsys.readouterr().err
    assert [line[len("error: "):].split(": ")[0] for line in err.splitlines()
            if line.startswith("error: ")] == [str(out / "a_trunc.dds")]
    assert "InputTooShortForStatedTextureSize" in err
    assert not (back / "a_trunc.dds").exists()
    assert (back / "a.dds").read_bytes() == (src / "a.dds").read_bytes()
    assert (back / "sub" / "b.dds").read_bytes() == (src / "sub" / "b.dds").read_bytes()


def test_cli_transform_shrunk_file_rerouted(tree, monkeypatch, capsys):
    """A file that shrank after the header pass, before its window is read, leaves
    the batch for the per-file path, which reports it; the batch carries on."""
    src = tree / "in"
    original = cli_main._batch_processors_for_preset

    def truncate_first(*args, **kwargs):
        make = original(*args, **kwargs)

        def make_after_truncating(fmt):
            (src / "a.dds").write_bytes((src / "a.dds").read_bytes()[:200])
            return make(fmt)
        return make_after_truncating

    monkeypatch.setattr(cli_main, "_batch_processors_for_preset", truncate_first)
    assert main(["transform", str(src), str(tree / "out"), "--preset", "medium"]) == 1
    err = capsys.readouterr().err
    assert "falling back" not in err
    assert f"error: {src / 'a.dds'}: InputTooShortForStatedTextureSize" in err
    assert not (tree / "out" / "a.dds").exists()
    assert (tree / "out" / "sub" / "b.dds").exists()


@pytest.mark.parametrize("preset", ["medium", "optimal"])
def test_cli_batched_rgb_tree(tmp_path, preset):
    src = tmp_path / "inrgb"
    src.mkdir()
    for i, layout in enumerate(["rgba8888", "bgra8888", "bgr888", "rgba8888"]):
        (src / f"{layout}{i}.dds").write_bytes(
            testgen.make_uncompressed_dds(layout, 32, 24, seed=i))
    out_b, out_f, back = tmp_path / "outrgb", tmp_path / "outrgbf", tmp_path / "backrgb"
    assert main(["transform", str(src), str(out_b), "--preset", preset,
                 "--batch"]) == 0
    assert main(["transform", str(src), str(out_f), "--preset", preset,
                 "--no-batch"]) == 0
    for f in src.iterdir():
        assert (out_b / f.name).read_bytes() == (out_f / f.name).read_bytes(), f.name
    assert main(["untransform", str(out_b), str(back)]) == 0
    for f in src.iterdir():
        assert (back / f.name).read_bytes() == f.read_bytes(), f.name


# across packages


@pytest.mark.parametrize("batch", ["--batch", "--no-batch"])
@pytest.mark.parametrize("preset", PRESETS)
def test_cli_tree_equals_jax(mixed, tmp_path, preset, batch):
    """The port's output tree equals the JAX CLI's byte for byte, and each package
    untransforms the other's tree to the input."""
    port, jax = tmp_path / "port", tmp_path / "jax"
    assert main(["transform", str(mixed), str(port), "--preset", preset, batch]) == 1
    assert jax_main(["transform", str(mixed), str(jax), "--preset", preset, batch]) == 1
    inputs, outs = tree_files(mixed), tree_files(port)
    assert set(outs) == set(inputs) - {"junk.txt"}
    assert outs == tree_files(jax)
    assert jax_main(["untransform", str(port), str(tmp_path / "jax_back")]) == 0
    assert main(["untransform", str(jax), str(tmp_path / "port_back")]) == 0
    for back in ("jax_back", "port_back"):
        assert tree_files(tmp_path / back) == {rel: data for rel, data in inputs.items()
                                               if rel != "junk.txt"}


@pytest.mark.parametrize("batch", ["--batch", "--no-batch"])
@pytest.mark.parametrize("direction", ["transform", "untransform"])
def test_cli_threads_equal_one_thread(mixed, tmp_path, direction, batch):
    src = mixed
    if direction == "untransform":
        src = tmp_path / "t"
        assert main(["transform", str(mixed), str(src), "--preset", "medium"]) == 1
    args = [direction, str(src)]
    extra = ["--preset", "medium"] if direction == "transform" else []
    main([*args, str(tmp_path / "four"), "--threads", "4", batch, *extra])
    main([*args, str(tmp_path / "one"), "--threads", "1", batch, *extra])
    four = tree_files(tmp_path / "four")
    assert four and four == tree_files(tmp_path / "one")


# faults of the machine end the command


@pytest.mark.parametrize("error", [backend.KernelLaunchError, backend.KernelBuildError,
                                   DeviceUnavailableError])
def test_device_fault_in_a_batch_ends_the_command(tree, monkeypatch, capsys, error):
    """A kernel or device fault inside a batch ends the command with exit code 2 and
    the error; the batch does not fall back to the per-file path, and the file is not
    written."""
    def fail(self, payloads):
        raise error("dlt_bc1_regions failed with CUDA error 700")

    monkeypatch.setattr(pipeline.BatchProcessor, "process", fail)
    out = tree / "out"
    assert main(["transform", str(tree / "in"), str(out), "--preset", "medium"]) == 2
    err = capsys.readouterr().err
    assert "falling back to per-file" not in err
    assert f"error: {error.__name__}: dlt_bc1_regions failed" in err
    assert not (out / "a.dds").exists()


def test_device_fault_in_the_load_batch_ends_the_command(tree, monkeypatch, capsys):
    out = tree / "out"
    assert main(["transform", str(tree / "in"), str(out), "--preset", "low"]) == 1

    def fail(self, entries):
        raise backend.KernelLaunchError("dlt_bc1_untransform failed with CUDA error 700")

    monkeypatch.setattr(pipeline.UntransformBatchProcessor, "process", fail)
    capsys.readouterr()
    assert main(["untransform", str(out), str(tree / "back")]) == 2
    err = capsys.readouterr().err
    assert "falling back" not in err and "KernelLaunchError" in err
    assert not (tree / "back" / "a.dds").exists()


@pytest.mark.parametrize("preset", ["low", "medium"])
def test_device_fault_per_file_is_not_a_file_failure(tree, monkeypatch, capsys, preset):
    """On the per-file path a kernel fault is not counted as the file's failure:
    the command ends with it."""
    from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler

    def fail(self, data, bundle):
        raise backend.KernelLaunchError("dlt_bc1_transform failed with CUDA error 700")

    monkeypatch.setattr(DdsHandler, "transform_bundle", fail)
    assert main(["transform", str(tree / "in"), str(tree / "out"), "--preset", preset,
                 "--no-batch"]) == 2
    err = capsys.readouterr().err
    assert "error: KernelLaunchError: dlt_bc1_transform failed" in err
    assert not any(line.startswith(f"error: {tree}") and "KernelLaunchError" in line
                   for line in err.splitlines())


@pytest.mark.parametrize("batch", ["--batch", "--no-batch"])
def test_kernel_fault_inside_a_search_ends_the_command(tree, monkeypatch, capsys, batch):
    """The auto-search wraps its estimator's errors in ``AutoTransformError``; a
    kernel fault behind one still ends the command, batched or per file."""
    from dxt_lossless_transform_tpu_torch.estimate import ltu

    def fail(*args, **kwargs):
        raise backend.KernelLaunchError("dlt_ltu_counts failed with CUDA error 700")

    monkeypatch.setattr(ltu, "ltu_counts", fail)
    assert main(["transform", str(tree / "in"), str(tree / "out"), "--preset", "medium",
                 batch]) == 2
    err = capsys.readouterr().err
    assert "error: KernelLaunchError: dlt_ltu_counts failed" in err
    assert "falling back" not in err and "AutoTransformError" not in err


def test_data_fault_in_a_batch_falls_back_per_file(tree, monkeypatch, capsys):
    """A data error in a batch (not a fault of the machine) keeps the JAX CLI's
    isolation: the window falls back to the per-file path, which writes the files."""
    def fail(self, payloads):
        raise ValueError("malformed payload")

    monkeypatch.setattr(pipeline.BatchProcessor, "process", fail)
    out = tree / "out"
    assert main(["transform", str(tree / "in"), str(out), "--preset", "medium"]) == 1
    assert "falling back to per-file" in capsys.readouterr().err
    assert main(["untransform", str(out), str(tree / "back")]) == 0
    assert (tree / "back" / "a.dds").read_bytes() == (tree / "in" / "a.dds").read_bytes()


def test_cli_runs_on_the_card_by_default(tree, capsys):
    """Without --device the command asks for the card: here it ends with the
    error and writes nothing."""
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = tree / "out"
    assert cli_main.main(["transform", str(tree / "in"), str(out), "--preset",
                          "low"]) == 2
    assert "DeviceUnavailableError" in capsys.readouterr().err
    assert not out.exists()


def test_cli_module_entry_point(tree):
    """``python -m dxt_lossless_transform_tpu_torch.cli`` runs the same main."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-m", "dxt_lossless_transform_tpu_torch.cli", "--device", "cpu",
         "transform", str(tree / "in" / "a.dds"), str(tree / "a.t"), "--preset", "low"],
        capture_output=True, text=True, timeout=300, cwd=repo,
        env={**os.environ, "PYTHONPATH": str(repo)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("transformed 1/1 files")
    assert (tree / "a.t").exists()


def test_profile_writes_a_trace(tree):
    prof = tree / "prof"
    assert main(["--profile", str(prof), "transform", str(tree / "in" / "a.dds"),
                 str(tree / "a.t"), "--preset", "medium"]) == 0
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1 and "traceEvents" in traces[0].read_text()


def test_parser_defaults_match_jax():
    import os

    from dxt_lossless_transform_tpu.cli import main as jax_cli

    ours = cli_main._build_parser()
    theirs = jax_cli._build_parser()
    for argv in (["transform", "i", "o"], ["untransform", "i", "o"]):
        a, b = vars(ours.parse_args(argv)), vars(theirs.parse_args(argv))
        assert a.pop("device") == "cuda"
        a.pop("fn"), b.pop("fn")
        assert a == b
    assert ours.parse_args(["transform", "i", "o"]).threads == (os.cpu_count() or 1)

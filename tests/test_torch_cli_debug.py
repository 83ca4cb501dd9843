"""The port's debug subcommands and its copies of the numpy decoders, on the CPU."""

import numpy as np
import pytest

from dxt_lossless_transform_tpu.cli.main import main as jax_main
from dxt_lossless_transform_tpu.oracle import color565 as jax_color565
from dxt_lossless_transform_tpu.oracle import decode as jax_decode
from dxt_lossless_transform_tpu.utils import testgen
from dxt_lossless_transform_tpu_torch.cli import debug
from dxt_lossless_transform_tpu_torch.cli import main as cli_main
from dxt_lossless_transform_tpu_torch.oracle import color565, decode


def main(argv):
    return cli_main.main(["--device", "cpu", *argv])


@pytest.fixture()
def tree(tmp_path):
    src = tmp_path / "in"
    (src / "sub").mkdir(parents=True)
    (src / "a.dds").write_bytes(testgen.make_dds("BC1", 32, 32, seed=1))
    (src / "a2.dds").write_bytes(testgen.make_dds("BC1", 16, 8, 2, seed=4))
    (src / "sub" / "b.dds").write_bytes(testgen.make_dds("BC3", 16, 16, seed=2))
    (src / "c.dds").write_bytes(testgen.make_dds("BC2", 16, 16, seed=3))
    (src / "d.dds").write_bytes(testgen.make_dx10_dds("BC7", 16, 16, seed=5))
    (src / "e.dds").write_bytes(testgen.make_uncompressed_dds("bgr888", 8, 8, seed=6))
    (src / "junk.txt").write_bytes(b"not a dds")
    return tmp_path


@pytest.fixture(autouse=True)
def cache_home(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    return tmp_path / "cache"


@pytest.mark.parametrize("fmt", ["bc1", "bc2", "bc3", "bc7"])
def test_debug_roundtrip(tree, fmt, capsys):
    assert main([f"debug-{fmt}", "roundtrip", str(tree / "in")]) == 0
    assert "roundtrip ok" in capsys.readouterr().out


def test_debug_roundtrip_without_files(tmp_path):
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "x.txt").write_bytes(b"x")
    assert main(["debug-bc1", "roundtrip", str(tmp_path / "empty")]) == 1


def test_debug_roundtrip_catches_a_broken_transform(tree, monkeypatch, capsys):
    from dxt_lossless_transform_tpu_torch.ops import bc1

    real = bc1.untransform
    monkeypatch.setattr(bc1, "untransform", lambda data, s, device: real(
        data, s, device=device)[:-1] + b"\x00")
    assert main(["debug-bc1", "roundtrip", str(tree / "in")]) == 1
    assert capsys.readouterr().out.startswith("FAIL (bytes)")


@pytest.mark.parametrize("fmt", ["bc1", "bc3", "bc7"])
def test_debug_compression_stats(tree, fmt, cache_home, capsys):
    assert main([f"debug-{fmt}", "calc-compression-stats", str(tree / "in"),
                 "--level", "3"]) == 0
    out = capsys.readouterr().out
    assert "(zstd level 3)" in out and "best" in out
    assert (cache_home / "dxt-lossless-transform-tpu"
            / "compression_size_cache.json").exists()
    # a second run reads the sizes back
    assert main([f"debug-{fmt}", "calc-compression-stats", str(tree / "in"),
                 "--level", "3"]) == 0
    assert capsys.readouterr().out == out


def test_debug_compression_stats_without_files(tmp_path, capsys):
    (tmp_path / "empty").mkdir()
    assert main(["debug-bc2", "calc-compression-stats", str(tmp_path / "empty")]) == 1
    assert "no matching files" in capsys.readouterr().err


@pytest.mark.parametrize("fmt", ["bc1", "bc2", "bc7"])
def test_debug_benchmark(tree, fmt, cache_home, capsys):
    assert main([f"debug-{fmt}", "benchmark", str(tree / "in"), "--iterations", "1",
                 "--level", "3"]) == 0
    assert "decompress+untransform" in capsys.readouterr().out
    assert list((cache_home / "dxt-lossless-transform-tpu" / "compressed_blobs").iterdir())


@pytest.mark.parametrize("fmt", ["bc1", "bc3"])
def test_debug_benchmark_determine_best(tree, fmt, capsys):
    assert main([f"debug-{fmt}", "benchmark-determine-best", str(tree / "in"),
                 "--level", "3"]) == 0
    out = capsys.readouterr().out
    assert "ltu" in out and "zstd-1" in out and "selection efficiency" in out


def test_debug_format_analysis_equals_jax(tree, capsys):
    assert main(["debug-format-analysis", str(tree / "in")]) == 0
    ours = capsys.readouterr().out
    assert jax_main(["debug-format-analysis", str(tree / "in")]) == 0
    assert ours == capsys.readouterr().out
    assert ours.startswith("6 DDS files")


def test_debug_format_analysis_without_dds(tmp_path, capsys):
    (tmp_path / "x").mkdir()
    (tmp_path / "x" / "y.txt").write_bytes(b"y")
    assert main(["debug-format-analysis", str(tmp_path / "x")]) == 1
    assert "no DDS files found" in capsys.readouterr().err


def test_debug_commands_run_on_the_card_by_default(tree, capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert cli_main.main(["debug-bc1", "roundtrip", str(tree / "in")]) == 2
    assert "DeviceUnavailableError" in capsys.readouterr().err


def test_debug_has_no_endian_commands():
    """The debug commands, the endian ones included since the endian layer was
    ported (the name is the test's from before that slice); they match the JAX
    CLI's."""
    parser = cli_main._build_parser()
    sub = next(a for a in parser._actions if a.dest == "command")
    assert sorted(name for name in sub.choices if name.startswith("debug-endian")) == \
        ["debug-endian", "debug-endian-transform", "debug-endian-untransform"]
    assert {"debug-bc1", "debug-bc2", "debug-bc3", "debug-bc7",
            "debug-format-analysis"} <= set(sub.choices)
    assert set(debug._FMT) == {"bc1", "bc2", "bc3", "bc7"}


# the port's copies of the numpy decoders


@pytest.mark.parametrize("n", [0, 1, 7, 300])
@pytest.mark.parametrize("fmt,size", [("bc1", 8), ("bc2", 16), ("bc3", 16)])
def test_decoders_equal_jax(fmt, size, n):
    rng = np.random.default_rng(100 * size + n)
    for data in (rng.integers(0, 256, n * size, np.uint8).tobytes(),
                 getattr(testgen, f"{fmt}_realistic")(n, seed=n) if n else b""):
        ours = getattr(decode, f"decode_{fmt}")(data)
        theirs = getattr(jax_decode, f"decode_{fmt}")(data)
        assert ours.dtype == theirs.dtype == np.uint8
        assert ours.shape == theirs.shape == (n, 4, 4, 4)
        assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("name", ["expand_red", "expand_green", "expand_blue",
                                  "to_rgba8888"])
def test_color565_equals_jax(name):
    c = np.arange(1 << 16, dtype=np.uint16)
    assert np.array_equal(getattr(color565, name)(c), getattr(jax_color565, name)(c))


def test_from_rgb_equals_jax():
    rng = np.random.default_rng(5)
    r, g, b = rng.integers(0, 256, (3, 4096))
    assert np.array_equal(color565.from_rgb(r, g, b), jax_color565.from_rgb(r, g, b))

"""The port's endian layer, its harness and the ``debug-endian*`` commands, on the CPU,
against the JAX package's ``endian`` and ``tests/test_endian.py``."""

import ast
import re
from pathlib import Path

import numpy as np
import pytest

from dxt_lossless_transform_tpu import endian as jax_endian
from dxt_lossless_transform_tpu.formats.embed import TransformHeader as JaxHeader
from dxt_lossless_transform_tpu.settings import Bc1TransformSettings as JaxBc1Settings
from dxt_lossless_transform_tpu_torch import endian
from dxt_lossless_transform_tpu_torch.cli import main as cli_main
from dxt_lossless_transform_tpu_torch.formats.dds import parse_dds
from dxt_lossless_transform_tpu_torch.formats.embed import TransformHeader
from dxt_lossless_transform_tpu_torch.parallel import pipeline
from dxt_lossless_transform_tpu_torch.settings import Bc1TransformSettings, YCoCgVariant
from dxt_lossless_transform_tpu_torch.utils import endian_harness, testgen
from dxt_lossless_transform_tpu_torch.utils.endian_harness import run_matrix

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "dxt_lossless_transform_tpu_torch"


@pytest.mark.parametrize("simulated", [False, True], ids=["native", "simulated"])
@pytest.mark.parametrize("kind", ["u2", "u4", "u8"])
def test_primitives_match_jax(kind, simulated):
    buf = bytes(range(48))
    values = np.array([(k * 0x0102030405060708) % (1 << (8 * int(kind[1])))
                       for k in range(1, 7)], dtype=np.uint64)

    def run(mod):
        with mod.simulate_big_endian() if simulated else _nothing():
            assert mod.simulating_big_endian() == simulated
            lanes = mod.from_bytes(buf, kind)
            empty = mod.empty((2, 3), kind)
            empty[:] = values.reshape(2, 3)
            return (lanes.tolist(), mod.to_bytes(lanes, kind), empty.dtype.str,
                    mod.to_bytes(empty, kind), mod.pack_u32(0x20534444),
                    mod.unpack_u32(b"DX10"))

    assert run(endian) == run(jax_endian)
    assert not endian.simulating_big_endian()
    native = run(endian)
    assert native[0] == np.frombuffer(buf, "<" + kind).tolist()
    assert native[1] == buf


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_primitives_examples():
    buf = bytes(range(16))
    with endian.simulate_big_endian():
        be_u4 = endian.from_bytes(buf, "u4")
        be_bytes = endian.to_bytes(be_u4, "u4")
        assert endian.simulating_big_endian()
        assert endian.pack_u32(0x20534444) == b"DDS "
        assert endian.unpack_u32(b"DDS ") == 0x20534444
    assert not endian.simulating_big_endian()
    np.testing.assert_array_equal(be_u4, np.frombuffer(buf, "<u4"))
    assert be_bytes == buf


@pytest.mark.parametrize("simulated", [False, True], ids=["native", "simulated"])
@pytest.mark.parametrize("dtype", ["<u4", "<i4", ">u4", "<i8"])
def test_to_bytes_of_strided_and_typed_lanes(dtype, simulated):
    """Columns of a 2-D lane buffer (not contiguous) and lanes already in the wire
    type serialize as the C-order little-endian values, as JAX's ``to_bytes`` does."""
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 1 << 31, (7, 3)).astype(dtype)
    want = arr[:, 1].astype("<u4").tobytes()
    with endian.simulate_big_endian() if simulated else _nothing():
        got = endian.to_bytes(arr[:, 1], "u4")
        jax = jax_endian.to_bytes(arr[:, 1], "u4")
        whole = endian.to_bytes(arr, "u4")
    assert got == jax == want
    assert whole == arr.astype("<u4").tobytes()


def test_simulation_detects_native_order_assumption():
    """A boundary that serializes in the host's order gives other bytes under the
    simulation; the pinned boundary gives the same."""
    arr = np.arange(4, dtype=np.uint32)

    def buggy_to_bytes(a):
        return np.ascontiguousarray(
            a, dtype=(">u4" if endian.simulating_big_endian() else "<u4")).tobytes()

    native = buggy_to_bytes(arr)
    with endian.simulate_big_endian():
        assert buggy_to_bytes(arr) != native
    native = endian.to_bytes(arr, "u4")
    with endian.simulate_big_endian():
        assert endian.to_bytes(arr, "u4") == native


@pytest.mark.parametrize("simulated", [False, True], ids=["native", "simulated"])
def test_header_bytes_match_jax(simulated):
    for variant in YCoCgVariant:
        for split in (False, True):
            with endian.simulate_big_endian() if simulated else _nothing():
                got = TransformHeader.for_bc1(Bc1TransformSettings(variant, split))
                raw = got.to_bytes()
                assert TransformHeader.from_bytes(raw) == got
            want = JaxHeader.for_bc1(JaxBc1Settings(int(variant), split)).to_bytes()
            assert raw == want


DDS_FILES = {
    "bc1": lambda: testgen.make_dds("BC1", 32, 32, 3, seed=1),
    "bc4": lambda: testgen.make_dds("BC4", 12, 4, seed=2),
    "bc7": lambda: testgen.make_dx10_dds("BC7", 16, 16, seed=3),
    "bgr888": lambda: testgen.make_uncompressed_dds("bgr888", 8, 8),
    "rgba8888": lambda: testgen.make_uncompressed_dds("rgba8888", 8, 8),
}


@pytest.mark.parametrize("name", DDS_FILES)
def test_dds_parse_is_the_same_on_both_hosts(name):
    data = DDS_FILES[name]()
    native = parse_dds(data)
    with endian.simulate_big_endian():
        assert parse_dds(data) == native
    assert native is not None


def test_matrix_synthetic():
    report = run_matrix(assets_dir=None, n_blocks=64, device="cpu")
    # 10 formats, every settings combination, 4 checks each; 3 synthetic containers;
    # one batch leg per BC1-BC5 format
    assert len(report.per_format) == 10
    assert report.per_format == {
        "bc1": 32, "bc2": 32, "bc3": 64, "bc4": 8, "bc5": 8, "bc7": 16, "bc6h": 16,
        "rgba8888": 16, "bgra8888": 16, "bgr888": 16}
    assert report.containers == 3
    assert report.batches == 5
    assert report.checks == 224 + 3 * 3 + 5 * 3
    assert report.ok()


def _assets(root: Path) -> Path:
    """A synthetic stand-in for the reference asset directory."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "r2-256-bc1.dds").write_bytes(testgen.make_dds("BC1", 32, 32, 3, seed=1))
    (root / "r2-256-bc2.dds").write_bytes(testgen.make_dds("BC2", 16, 16, seed=2))
    (root / "r2-256-bc3.dds").write_bytes(testgen.make_dds("BC3", 32, 16, 2, seed=3))
    (root / "r2-256-bc7.dds").write_bytes(testgen.make_dx10_dds("BC7", 16, 16, 2, seed=4))
    return root


def test_matrix_with_assets(tmp_path):
    report = run_matrix(assets_dir=str(_assets(tmp_path / "assets")), n_blocks=16,
                        device="cpu")
    assert report.containers == 3 + 8 + 8 + 16 + 4


def test_harness_detects_a_host_order_serializer(monkeypatch):
    """The batch leg fails when a pipeline serializer writes in the host's order."""
    def buggy_u32s(arr, n):
        order = ">" if endian.simulating_big_endian() else "<"
        return arr[:n].astype(order + "u4").tobytes()

    monkeypatch.setattr(pipeline, "_u32s", buggy_u32s)
    with pytest.raises(AssertionError, match="batch"):
        run_matrix(n_blocks=16, device="cpu")


def test_harness_detects_a_host_order_header(monkeypatch):
    """The header checks fail when the header is written in the host's order."""
    def buggy_to_bytes(self):
        word = (int(self.format) & 0xF) | ((self.data & 0x0FFFFFFF) << 4)
        return word.to_bytes(4, "big" if endian.simulating_big_endian() else "little")

    monkeypatch.setattr(TransformHeader, "to_bytes", buggy_to_bytes)
    with pytest.raises(AssertionError, match="header"):
        run_matrix(n_blocks=16, device="cpu")


def main(argv):
    return cli_main.main(["--device", "cpu", *argv])


def test_debug_endian_command(capsys):
    assert main(["debug-endian", "--blocks", "32"]) == 0
    out = capsys.readouterr().out
    assert "endian matrix ok:" in out and "10 formats" in out
    assert "3 whole-container and 5 batch round trips" in out


def test_debug_endian_command_with_assets(tmp_path, capsys):
    assert main(["debug-endian", "--blocks", "16", "--assets",
                 str(_assets(tmp_path / "assets"))]) == 0
    assert "39 whole-container" in capsys.readouterr().out


def test_two_phase_exchange_cli(tmp_path):
    assets, ex = _assets(tmp_path / "assets"), tmp_path / "exchange"
    assert main(["debug-endian-transform", "--assets", str(assets),
                 "--exchange", str(ex)]) == 0
    assert sorted(p.name for p in ex.iterdir()) == sorted(endian_harness.ASSET_FMT)
    assert main(["debug-endian-untransform", "--assets", str(assets),
                 "--exchange", str(ex)]) == 0
    # a changed exchange file is caught
    f = ex / "r2-256-bc3.dds"
    data = bytearray(f.read_bytes())
    data[-1] ^= 1
    f.write_bytes(bytes(data))
    assert main(["debug-endian-untransform", "--assets", str(assets),
                 "--exchange", str(ex)]) == 1


def test_exchange_commands_require_assets(tmp_path):
    for cmd in ("debug-endian-transform", "debug-endian-untransform"):
        with pytest.raises(SystemExit) as exc:
            main([cmd, "--exchange", str(tmp_path / "ex")])
        assert exc.value.code == 2
    assert main(["debug-endian-transform", "--assets", str(tmp_path / "none"),
                 "--exchange", str(tmp_path / "ex")]) == 1


SOURCES = sorted(p for p in PACKAGE.rglob("*.py")
                 if p.relative_to(PACKAGE).as_posix() not in ("endian.py",
                                                              "utils/testgen.py"))
PIN = re.compile(r"""["']<u[248]["']|\.view\(np\.uint32\)""")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(PACKAGE).as_posix())
def test_no_pin_point_outside_the_endian_layer(path):
    """No module but the endian layer (and the test data generator) reads or writes
    host bytes as little-endian lanes itself."""
    text = path.read_text()
    assert not PIN.search(text), PIN.search(text).group(0)
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("pack", "unpack", "pack_into", "unpack_from"):
            fmt = node.args[0] if node.args else None
            assert not (isinstance(fmt, ast.Constant) and isinstance(fmt.value, str)
                        and "I" in fmt.value), f"struct format {fmt.value!r}"

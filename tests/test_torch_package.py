"""Properties of the port as a package: what it imports, where its entry points run,
and that importing it builds nothing."""

import ast
import contextlib
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

from dxt_lossless_transform_tpu.estimate.ltu import LtuEstimation as JaxLtu
from dxt_lossless_transform_tpu.settings import (
    BC1_COMPREHENSIVE_CANDIDATES, Bc1TransformSettings as JaxSettings, YCoCgVariant,
)
from dxt_lossless_transform_tpu_torch import backend, convert, parallel, settings
from dxt_lossless_transform_tpu_torch.api import (
    Bc1AutoTransformBuilder, Bc1ManualTransformBuilder, Bc2AutoTransformBuilder,
    Bc2ManualTransformBuilder, Bc3AutoTransformBuilder, Bc3ManualTransformBuilder,
    Bc4AutoTransformBuilder, Bc4ManualTransformBuilder, Bc5AutoTransformBuilder,
    Bc5ManualTransformBuilder, Bc6hAutoTransformBuilder, Bc6hManualTransformBuilder,
    Bc7AutoTransformBuilder, Bc7ManualTransformBuilder, RgbAutoTransformBuilder,
    RgbManualTransformBuilder,
)
from dxt_lossless_transform_tpu_torch.errors import DeviceUnavailableError
from dxt_lossless_transform_tpu_torch.estimate import cuda_ltu
from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
from dxt_lossless_transform_tpu_torch.formats.bundle import TransformBundle
from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler
from dxt_lossless_transform_tpu_torch.formats import api as formats_api, file_io
from dxt_lossless_transform_tpu_torch.ops import auto, bc1, bc2, bc3, bc45, bc6h, bc7, rgb
from dxt_lossless_transform_tpu_torch.ops import decode, normalize
from dxt_lossless_transform_tpu_torch.utils import endian_harness
from dxt_lossless_transform_tpu_torch.ops.cuda import channels, planes, regions, shuffle
from dxt_lossless_transform_tpu_torch.utils import testgen

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "dxt_lossless_transform_tpu_torch"
SOURCES = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "dxt_lossless_transform_tpu", "zstandard")


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_imports_nothing_of_jax(path):
    for name in _imported(path):
        assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"


def test_scan_covers_the_package():
    names = {p.relative_to(PACKAGE).as_posix() for p in SOURCES[:-1]}
    assert {"backend.py", "ops/cuda/shuffle.py", "ops/cuda/regions.py",
            "estimate/cuda_ltu.py", "formats/handlers.py", "api.py", "ops/bc3.py",
            "ops/auto.py", "formats/bundle.py", "formats/embed.py", "convert.py",
            "settings.py", "errors.py", "utils/testgen.py", "ops/bc2.py",
            "ops/bc45.py", "ops/bc7.py", "ops/bc6h.py", "ops/cuda/planes.py",
            "estimate/zstd.py", "ops/rgb.py", "ops/cuda/channels.py",
            "formats/api.py", "formats/file_io.py", "ops/lanes.py", "ops/hostwrap.py",
            "parallel/__init__.py", "parallel/pipeline.py",
            "parallel/sharded.py", "cli/main.py", "cli/debug.py", "cli/__main__.py",
            "utils/cache.py", "utils/profiling.py", "utils/throughput.py",
            "oracle/decode.py", "oracle/color565.py", "ops/decode.py",
            "ops/normalize.py", "formats/debug.py", "endian.py",
            "utils/endian_harness.py"} <= names


def test_import_builds_nothing_and_imports_no_triton():
    code = (
        "import subprocess, sys\n"
        "def boom(*a, **k): raise AssertionError('subprocess at import')\n"
        "subprocess.run = subprocess.Popen = boom\n"
        "import dxt_lossless_transform_tpu_torch as p, importlib, pkgutil\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from dxt_lossless_transform_tpu_torch import backend\n"
        "assert backend._lib is None\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('triton', 'jax', 'zstandard', 'dxt_lossless_transform_tpu')]\n"
        "assert not bad, bad\n"
        "from dxt_lossless_transform_tpu_torch.estimate import zstd\n"
        "assert zstd._lib is None\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")


DATA = bytes(range(256)) * 4
DDS = testgen.make_dds("BC1", 16, 16, 1)
DDS3 = testgen.make_dds("BC3", 16, 16, 1)
ENTRY_POINTS = {
    "bc1.transform": lambda: bc1.transform(DATA),
    "bc1.untransform": lambda: bc1.untransform(DATA),
    "auto.transform_bc1_auto": lambda: auto.transform_bc1_auto(DATA, LtuEstimation()),
    "manual builder": lambda: Bc1ManualTransformBuilder().transform(DATA),
    "auto builder": lambda: Bc1AutoTransformBuilder(LtuEstimation()).transform(DATA),
    "DdsHandler.transform_bundle": lambda: DdsHandler().transform_bundle(
        DDS, TransformBundle(bc1=Bc1AutoTransformBuilder(LtuEstimation()))),
    "DdsHandler.untransform": lambda: DdsHandler().untransform(
        DdsHandler("cpu").transform_bundle(
            DDS, TransformBundle(bc1=Bc1ManualTransformBuilder()))),
    "LtuEstimation.estimate": lambda: LtuEstimation().estimate(DATA),
    "bc3.transform": lambda: bc3.transform(DATA),
    "bc3.untransform": lambda: bc3.untransform(DATA),
    "auto.transform_bc3_auto": lambda: auto.transform_bc3_auto(DATA, LtuEstimation()),
    "bc3 manual builder": lambda: Bc3ManualTransformBuilder().transform(DATA),
    "bc3 auto builder": lambda: Bc3AutoTransformBuilder(LtuEstimation()).transform(DATA),
    "DdsHandler.transform_bundle bc3": lambda: DdsHandler().transform_bundle(
        DDS3, TransformBundle(bc3=Bc3AutoTransformBuilder(LtuEstimation()))),
    "DdsHandler.untransform bc3": lambda: DdsHandler().untransform(
        DdsHandler("cpu").transform_bundle(
            DDS3, TransformBundle(bc3=Bc3ManualTransformBuilder()))),
    "bc2.transform": lambda: bc2.transform(DATA),
    "bc2.untransform": lambda: bc2.untransform(DATA),
    "auto.transform_bc2_auto": lambda: auto.transform_bc2_auto(DATA, LtuEstimation()),
    "bc2 manual builder": lambda: Bc2ManualTransformBuilder().transform(DATA),
    "bc2 auto builder": lambda: Bc2AutoTransformBuilder(LtuEstimation()).transform(DATA),
    "bc45.transform_bc4": lambda: bc45.transform_bc4(DATA),
    "bc45.untransform_bc4": lambda: bc45.untransform_bc4(DATA),
    "bc45.transform_bc4_auto": lambda: bc45.transform_bc4_auto(DATA, LtuEstimation()),
    "bc4 manual builder": lambda: Bc4ManualTransformBuilder().transform(DATA),
    "bc4 auto builder": lambda: Bc4AutoTransformBuilder(LtuEstimation()).transform(DATA),
    "bc45.transform_bc5": lambda: bc45.transform_bc5(DATA),
    "bc45.untransform_bc5": lambda: bc45.untransform_bc5(DATA),
    "bc45.transform_bc5_auto": lambda: bc45.transform_bc5_auto(DATA, LtuEstimation()),
    "bc5 manual builder": lambda: Bc5ManualTransformBuilder().transform(DATA),
    "bc5 auto builder": lambda: Bc5AutoTransformBuilder(LtuEstimation()).transform(DATA),
    "DdsHandler.transform_bundle bc2": lambda: DdsHandler().transform_bundle(
        testgen.make_dds("BC2", 16, 16), TransformBundle(
            bc2=Bc2AutoTransformBuilder(LtuEstimation()))),
    "DdsHandler.untransform bc5": lambda: DdsHandler().untransform(
        DdsHandler("cpu").transform_bundle(testgen.make_dds("BC5", 16, 16),
                                           TransformBundle(
                                               bc5=Bc5ManualTransformBuilder()))),
    "bc7.transform": lambda: bc7.transform(DATA),
    "bc7.untransform": lambda: bc7.untransform(DATA),
    "bc7.transform identity": lambda: bc7.transform(
        DATA, settings.Bc7TransformSettings(False, False)),
    "bc7.transform_bc7_auto": lambda: bc7.transform_bc7_auto(DATA, LtuEstimation()),
    "bc7 manual builder": lambda: Bc7ManualTransformBuilder().transform(DATA),
    "bc7 auto builder": lambda: Bc7AutoTransformBuilder(LtuEstimation()).transform(DATA),
    "bc6h.transform": lambda: bc6h.transform(DATA),
    "bc6h.untransform": lambda: bc6h.untransform(DATA),
    "bc6h.transform_bc6h_auto": lambda: bc6h.transform_bc6h_auto(DATA, LtuEstimation()),
    "bc6h manual builder": lambda: Bc6hManualTransformBuilder().transform(DATA),
    "bc6h auto builder": lambda: Bc6hAutoTransformBuilder(
        LtuEstimation()).transform(DATA),
    "DdsHandler.transform_bundle bc7": lambda: DdsHandler().transform_bundle(
        testgen.make_dx10_dds("BC7", 16, 16), TransformBundle(
            bc7=Bc7AutoTransformBuilder(LtuEstimation()))),
    "DdsHandler.untransform bc6h": lambda: DdsHandler().untransform(
        DdsHandler("cpu").transform_bundle(testgen.make_dx10_dds("BC6H", 16, 16),
                                           TransformBundle(
                                               bc6h=Bc6hManualTransformBuilder()))),
    "rgb.transform": lambda: rgb.transform(DATA, "rgba8888"),
    "rgb.untransform": lambda: rgb.untransform(DATA[:1023], "bgr888"),
    "rgb.transform identity": lambda: rgb.transform(
        DATA, "bgra8888", settings.RgbTransformSettings(False, False)),
    "rgb.transform_rgb_auto": lambda: rgb.transform_rgb_auto(DATA, "rgba8888",
                                                             LtuEstimation()),
    "rgb.transform_rgb_auto empty": lambda: rgb.transform_rgb_auto(b"", "bgr888",
                                                                   LtuEstimation()),
    "rgb manual builder": lambda: RgbManualTransformBuilder("bgr888").transform(
        DATA[:1023]),
    "rgb manual builder untransform": lambda: RgbManualTransformBuilder(
        "rgba8888").untransform(DATA),
    "rgb auto builder": lambda: RgbAutoTransformBuilder(
        "bgra8888", LtuEstimation()).transform(DATA),
    "DdsHandler.transform_bundle rgba8888": lambda: DdsHandler().transform_bundle(
        testgen.make_uncompressed_dds("rgba8888", 16, 16), TransformBundle(
            rgba8888=RgbAutoTransformBuilder("rgba8888", LtuEstimation()))),
    "DdsHandler.untransform bgr888": lambda: DdsHandler().untransform(
        DdsHandler("cpu").transform_bundle(testgen.make_uncompressed_dds(
            "bgr888", 16, 16), TransformBundle.default_all())),
    "transform_slice_with_multiple_handlers": lambda: (
        formats_api.transform_slice_with_multiple_handlers(
            [DdsHandler()], testgen.make_uncompressed_dds("bgra8888", 8, 8),
            TransformBundle.default_all())),
    "untransform_slice_with_multiple_handlers": lambda: (
        formats_api.untransform_slice_with_multiple_handlers(
            [DdsHandler()], DdsHandler("cpu").transform_bundle(
                testgen.make_uncompressed_dds("bgr888", 8, 8),
                TransformBundle.default_all()))),
    "parallel.BatchProcessor": lambda: parallel.BatchProcessor("bc1"),
    "parallel.BatchProcessor host-scored": lambda: parallel.BatchProcessor(
        "bc3", estimator=LtuEstimation()),
    "parallel.Bc5BatchProcessor": lambda: parallel.Bc5BatchProcessor(),
    "parallel.transform_corpus_bc1": lambda: parallel.transform_corpus_bc1([DATA]),
    "parallel.UntransformBatchProcessor": lambda: parallel.UntransformBatchProcessor(
        "bc2"),
    "parallel.ModeSortBatchProcessor": lambda: parallel.ModeSortBatchProcessor("bc6h"),
    "parallel.RgbBatchProcessor": lambda: parallel.RgbBatchProcessor(
        "bgr888", LtuEstimation()),
    "decode.decode_bc1_bytes": lambda: decode.decode_bc1_bytes(DATA),
    "decode.decode_bc3_bytes": lambda: decode.decode_bc3_bytes(DATA),
    "normalize.normalize_blocks_bc1": lambda: normalize.normalize_blocks_bc1(DATA, 1),
    "normalize.normalize_blocks_bc2 NONE": lambda: normalize.normalize_blocks_bc2(DATA, 0),
    "normalize.normalize_blocks_all_modes_bc3": lambda: (
        normalize.normalize_blocks_all_modes_bc3(DATA)),
    "normalize.transform_bc2_with_normalize_blocks": lambda: (
        normalize.transform_bc2_with_normalize_blocks(
            DATA, settings.Bc2TransformSettings(), 2)),
    "normalize.transform_bc1_auto_with_normalization": lambda: (
        normalize.transform_bc1_auto_with_normalization(DATA, LtuEstimation())),
    "normalize.transform_bc3_auto_with_normalization": lambda: (
        normalize.transform_bc3_auto_with_normalization(DATA, LtuEstimation())),
    "endian_harness.run_matrix": lambda: endian_harness.run_matrix(n_blocks=4),
}


@pytest.mark.parametrize("call", ENTRY_POINTS)
def test_entry_points_default_to_cuda(call):
    """Without ``device=`` an entry point asks for the card and raises here."""
    _no_cuda()
    with pytest.raises(DeviceUnavailableError):
        ENTRY_POINTS[call]()


@pytest.mark.parametrize("direction", ["transform", "untransform"])
def test_file_entry_points_default_to_cuda(direction, tmp_path):
    """File in, file out through a ``DdsHandler()`` asks for the card and raises
    here, before writing anything."""
    _no_cuda()
    data = testgen.make_uncompressed_dds("bgr888", 8, 8)
    if direction == "untransform":
        data = DdsHandler("cpu").transform_bundle(data, TransformBundle.default_all())
    src, out = tmp_path / "in.dds", tmp_path / "out.dds"
    src.write_bytes(data)
    with pytest.raises(DeviceUnavailableError):
        if direction == "transform":
            file_io.transform_file_with_multiple_handlers(
                [DdsHandler()], TransformBundle.default_all(), src, out)
        else:
            file_io.untransform_file_with_multiple_handlers([DdsHandler()], src, out)
    assert not out.exists()


def test_cpu_tensors_take_the_plain_versions():
    backend.reset_launch_counts()
    x = torch.frombuffer(bytearray(DATA), dtype=torch.uint8)
    t = shuffle.bc1_transform(x, 1, True)
    assert torch.equal(shuffle.bc1_untransform(t, 1, True), x)
    rows = regions.bc1_regions(x, ((1, True), (0, False)))
    cuda_ltu.ltu_counts(rows, rows.shape[1], [1, 2], [24, 23])
    cuda_ltu.ltu_counts(rows, rows.shape[1], [1, 8192], [24, 11])
    t3 = shuffle.bc3_transform(x, 2, True, True)
    assert torch.equal(shuffle.bc3_untransform(t3, 2, True, True), x)
    regions.bc3_regions(x, (True, False), ((1, True), (0, False)))
    t2 = shuffle.bc2_transform(x, 3, True)
    assert torch.equal(shuffle.bc2_untransform(t2, 3, True), x)
    regions.bc2_regions(x, ((2, False), (0, True)))
    for split in (True, False):
        assert torch.equal(shuffle.bc4_untransform(shuffle.bc4_transform(x, split),
                                                   split), x)
        assert torch.equal(shuffle.bc5_untransform(shuffle.bc5_transform(x, split),
                                                   split), x)
    for fmt in (planes.BC7, planes.BC6H):
        for sort in (True, False):
            for split in (True, False):
                t7 = planes.bc7_transform(x, fmt, sort, split)
                assert torch.equal(planes.bc7_untransform(t7, x.numel() // 16, sort,
                                                          split), x)
    for layout in channels.LAYOUTS:
        for s in settings.RgbTransformSettings.all_combinations():
            args = (*channels.LAYOUTS[layout], s.decorrelate, s.split_channels)
            assert torch.equal(channels.rgb_untransform(
                channels.rgb_transform(x[:960], *args), *args), x[:960])
    words = x.view(torch.int32)
    assert torch.equal(torch.stack(planes.deinterleave_words(words, 4), dim=1).view(-1),
                       words)
    cuda_ltu.ltu_counts(rows, torch.tensor([rows.shape[1], 5]), [1, 2], [24, 23])
    assert all(count == 0 for count in backend.LAUNCHES.values())


def test_other_devices_raise():
    x = torch.empty(16, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        shuffle.bc1_transform(x, 0, False)
    with pytest.raises(DeviceUnavailableError):
        backend.resolve_device("meta")


def test_upload_download_cpu():
    dev = backend.resolve_device("cpu")
    assert backend.download(backend.upload(DATA, dev)) == DATA


def test_library_path_is_keyed_by_source(tmp_path, monkeypatch):
    path = backend.library_path()
    assert path.parent == REPO / "build" / "cuda"
    assert path.name.startswith("libdlt_kernels_") and path.suffix == ".so"
    assert [p.name for p in backend.sources()] == ["bc1_kernels.cu", "bc2_kernels.cu",
                                                   "bc3_kernels.cu", "bc45_kernels.cu",
                                                   "bc7_kernels.cu", "rgb_kernels.cu",
                                                   "words_kernels.cu"]
    # every source and header is in the hash
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in backend.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(backend, "CSRC", csrc)
    assert backend.library_path() == path
    for name in ("common.cuh", "bc3_kernels.cu", "bc2_kernels.cu", "bc45_kernels.cu",
                 "bc7_kernels.cu", "rgb_kernels.cu", "words_kernels.cu"):
        (csrc / name).write_bytes((csrc / name).read_bytes() + b"\n")
        changed = backend.library_path()
        assert changed != path
        path = changed


def test_convert_bc3_from_reference():
    from dxt_lossless_transform_tpu import settings as jax_settings

    assert convert.from_reference(jax_settings.BC3_FAST_CANDIDATES) == \
        settings.BC3_FAST_CANDIDATES
    assert convert.from_reference(jax_settings.BC3_COMPREHENSIVE_CANDIDATES) == \
        settings.BC3_COMPREHENSIVE_CANDIDATES
    assert [convert.from_reference(s) for s in
            jax_settings.Bc3TransformSettings.all_combinations()] == \
        list(settings.Bc3TransformSettings.all_combinations())
    assert convert.from_reference(jax_settings.Bc3TransformSettings()) == \
        settings.Bc3TransformSettings()
    # the RGB formats came with a later slice: their settings map to the port's
    assert convert.from_reference(jax_settings.RgbTransformSettings()) == \
        settings.RgbTransformSettings()


def test_convert_bc2_bc4_bc5_from_reference():
    from dxt_lossless_transform_tpu import settings as jax_settings

    assert convert.from_reference(jax_settings.BC2_FAST_CANDIDATES) == \
        settings.BC2_FAST_CANDIDATES
    assert convert.from_reference(jax_settings.BC2_COMPREHENSIVE_CANDIDATES) == \
        settings.BC2_COMPREHENSIVE_CANDIDATES
    for fmt in ("Bc2", "Bc4", "Bc5"):
        jax_cls = getattr(jax_settings, f"{fmt}TransformSettings")
        port_cls = getattr(settings, f"{fmt}TransformSettings")
        assert [convert.from_reference(s) for s in jax_cls.all_combinations()] == \
            list(port_cls.all_combinations())
        assert convert.from_reference(jax_cls()) == port_cls()


def test_convert_from_reference():
    assert convert.from_reference(JaxSettings(YCoCgVariant.VARIANT2, False)) == \
        settings.Bc1TransformSettings(settings.YCoCgVariant.VARIANT2, False)
    assert convert.from_reference(BC1_COMPREHENSIVE_CANDIDATES) == \
        settings.BC1_COMPREHENSIVE_CANDIDATES
    assert convert.from_reference(YCoCgVariant.VARIANT3) is \
        settings.YCoCgVariant.VARIANT3
    est = convert.from_reference(JaxLtu((1, 5, 9)))
    assert isinstance(est, LtuEstimation) and est.offsets == (1, 5, 9)
    with pytest.raises(TypeError):
        convert.from_reference(object())


def test_settings_match_jax():
    from dxt_lossless_transform_tpu import settings as jax_settings

    assert convert.from_reference(jax_settings.BC1_FAST_CANDIDATES) == \
        settings.BC1_FAST_CANDIDATES
    assert [convert.from_reference(s) for s in JaxSettings.all_combinations()] == \
        list(settings.Bc1TransformSettings.all_combinations())
    assert convert.from_reference(JaxSettings()) == settings.Bc1TransformSettings()


def _fake_nvcc(tmp_path, body: str) -> Path:
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return bindir


def test_build_writes_the_hash_named_library_once(tmp_path, monkeypatch):
    # a stand-in nvcc that writes its -o argument and logs each call with its sources
    bindir = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done\n'
                                  'out="$2"; shift 2\n'
                                  'echo "call $(basename -a "$@" | tr "\\n" " ")"'
                                  ' >> "$(dirname "$0")/log"\n'
                                  'echo built > "$out"\n')
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(backend, "BUILD_DIR", tmp_path / "build" / "cuda")
    path, _ = backend.build()
    assert path == backend.library_path() and path.read_text() == "built\n"
    assert [p.name for p in path.parent.iterdir()] == [path.name]  # no temp left
    assert backend.build() == (path, "")  # already built: nvcc is not called again
    # one nvcc call for every source
    assert (bindir / "log").read_text() == \
        "call bc1_kernels.cu bc2_kernels.cu bc3_kernels.cu bc45_kernels.cu " \
        "bc7_kernels.cu rgb_kernels.cu words_kernels.cu \n"


def test_build_from_threads_compiles_once(tmp_path, monkeypatch):
    """Eight threads that reach the library at once on a cold build directory (the
    CLI's per-file workers) run one compile, all get the one whole file, and no
    temporary file is left."""
    bindir = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done\n'
                                  'echo call >> "$(dirname "$0")/log"\n'
                                  'printf part > "$2"; sleep 0.3\n'
                                  'echo " whole" >> "$2"\n')
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(backend, "BUILD_DIR", tmp_path / "build" / "cuda")
    barrier = threading.Barrier(8)

    def build():
        barrier.wait(timeout=30)
        path, _ = backend.build()
        return path, path.read_text()

    with ThreadPoolExecutor(8) as pool:
        results = [f.result(timeout=60) for f in [pool.submit(build) for _ in range(8)]]
    assert results == [(backend.library_path(), "part whole\n")] * 8
    assert (bindir / "log").read_text() == "call\n"
    assert [p.name for p in backend.BUILD_DIR.iterdir()] == \
        [backend.library_path().name]


def test_launch_counts_lose_no_increment_across_threads(monkeypatch):
    """Launches from many threads at once, with the interpreter switching threads
    as often as it can, are all counted."""
    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(backend, "_lib", Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream())
    backend.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                backend.launch("dlt_bc1_transform", None)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert backend.LAUNCHES["dlt_bc1_transform"] == 16 * 2000
    backend.reset_launch_counts()


def test_build_failure_raises_and_leaves_nothing(tmp_path, monkeypatch):
    bindir = _fake_nvcc(tmp_path, "echo 'error: no' >&2\nexit 2\n")
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(backend, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(backend.KernelBuildError, match="error: no"):
        backend.build()
    assert list((tmp_path / "build").iterdir()) == []


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(backend, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(DeviceUnavailableError, match="nvcc"):
        backend.build()


def test_imports_without_zstandard_and_loads_zstd_only_when_asked():
    """The package imports where no ``zstandard`` module can be found; the system
    zstd library is loaded by the first :class:`ZstdEstimation` only."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'zstandard':\n"
        "            raise ImportError('no zstandard here')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import dxt_lossless_transform_tpu_torch as p, importlib, pkgutil\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from dxt_lossless_transform_tpu_torch.estimate import zstd\n"
        "assert zstd._lib is None\n"
        "assert zstd.ZstdEstimation(1).estimate(bytes(1000)) > 0\n"
        "assert 'zstandard' not in sys.modules\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

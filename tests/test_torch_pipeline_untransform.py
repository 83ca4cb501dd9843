"""The port's batched load path (``UntransformBatchProcessor``) for every format and
every setting, and its BC7/BC6H and RGB batch processors (``ModeSortBatchProcessor``,
``RgbBatchProcessor`` under LTU), against the JAX package's (plain versions on the
CPU). Payloads come from the generators with numpy seeds: ragged files in two
buckets, ``max_batch`` below the file count, an empty payload. The JAX package's
transform writes the inputs of the load path; restored bytes, picks and transformed
bytes must be equal (exact)."""

import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu.estimate import LtuEstimation as JaxLtu
from dxt_lossless_transform_tpu.oracle import (
    bc1 as obc1, bc2 as obc2, bc3 as obc3, bc4 as obc45, bc6h as obc6h, bc7 as obc7,
    rgb as orgb,
)
from dxt_lossless_transform_tpu.parallel import pipeline as jax_pipeline
from dxt_lossless_transform_tpu.settings import (
    Bc1TransformSettings as J1, Bc2TransformSettings as J2, Bc3TransformSettings as J3,
    Bc4TransformSettings as J4, Bc5TransformSettings as J5,
    Bc6hTransformSettings as J6h, Bc7TransformSettings as J7,
    RgbTransformSettings as JRgb,
)
from dxt_lossless_transform_tpu.utils import testgen
from dxt_lossless_transform_tpu_torch import backend, convert
from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
from dxt_lossless_transform_tpu_torch.ops import bc7
from dxt_lossless_transform_tpu_torch.parallel import (
    ModeSortBatchProcessor, RgbBatchProcessor, UntransformBatchProcessor,
)

SIZES = (1, 100, 2048, 2049, 3001)
# format -> (block size, payload generator, JAX oracle transform, JAX settings)
FORMATS = {
    "bc1": (8, testgen.bc1_realistic, obc1.transform, J1),
    "bc2": (16, testgen.bc2_realistic, obc2.transform, J2),
    "bc3": (16, testgen.bc3_realistic, obc3.transform, J3),
    "bc4": (8, None, obc45.transform_bc4, J4),
    "bc5": (16, None, obc45.transform_bc5, J5),
    "bc7": (16, testgen.bc7_realistic, obc7.transform, J7),
    "bc6h": (16, None, obc6h.transform, J6h),
}
CASES = [(fmt, s) for fmt, (_, _, _, cls) in FORMATS.items()
         for s in cls.all_combinations()]
LAYOUTS = ("rgba8888", "bgra8888", "bgr888")


def _payloads(fmt: str) -> list:
    size, gen, _, _ = FORMATS[fmt]
    return [gen(n, seed=n) if gen else testgen.bc_blocks(n, size, seed=n) for n in SIZES]


def _restore(fmt, entries, jax_settings, **kw):
    want = jax_pipeline.UntransformBatchProcessor(fmt, max_batch=2).process(
        [(p, jax_settings) for p in entries])
    got = UntransformBatchProcessor(fmt, max_batch=2, device="cpu", **kw).process(
        [(p, convert.from_reference(jax_settings)) for p in entries])
    return want, got


@pytest.mark.parametrize("fmt,settings", CASES, ids=lambda v: str(v))
def test_untransform_batch_matches_jax(fmt, settings):
    data = _payloads(fmt)
    transform = FORMATS[fmt][2]
    entries = [transform(d, settings) for d in data] + [b""]
    want, got = _restore(fmt, entries, settings)
    assert got == want == data + [b""]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_untransform_batch_rgb_matches_jax(layout):
    data = [testgen.make_uncompressed_dds(layout, w, h, seed=w)[0x80:]
            for w, h in ((16, 16), (33, 7), (64, 32))]
    for s in JRgb.all_combinations():
        entries = [orgb.transform(d, layout, s) for d in data] + [b""]
        want, got = _restore(layout, entries, s)
        assert got == want == data + [b""]


def test_untransform_batches_by_settings_and_bucket():
    data = _payloads("bc1")
    proc = UntransformBatchProcessor("bc1", max_batch=2, device="cpu")
    split, plain = J1(), J1(split_colour_endpoints=False)
    entries = [(obc1.transform(d, split), convert.from_reference(split)) for d in data]
    entries += [(obc1.transform(d, plain), convert.from_reference(plain)) for d in data]
    assert proc.process(entries) == data + data
    # per settings: bucket 2048 holds 3 files (2 batches), 4096 two (1 batch)
    assert proc.batches == 6


def test_untransform_batch_budget_shrinks_the_batch(monkeypatch):
    monkeypatch.setenv("DLT_UNTRANSFORM_HBM_BUDGET", str(2 * 8 * 2048))
    data = _payloads("bc1")
    proc = UntransformBatchProcessor("bc1", device="cpu")
    entries = [(obc1.transform(d, J1()), convert.from_reference(J1())) for d in data]
    assert proc.process(entries) == data
    assert proc.batches == len(data)  # one file per batch


@pytest.mark.parametrize("fmt", ["bc7", "bc6h"])
def test_mode_sort_batch_matches_jax(fmt):
    data = [testgen.bc7_realistic(n, seed=n) for n in (64, 700, 2048, 2049)]
    data += [b"", testgen.bc_blocks(300, 16, seed=3)]
    want = jax_pipeline.ModeSortBatchProcessor(fmt, max_batch=2).process(data)
    proc = ModeSortBatchProcessor(fmt, max_batch=2, device="cpu")
    got = proc.process(data)
    assert [r.index for r in got] == list(range(len(data)))
    for j, r in zip(want, got):
        assert convert.from_reference(j.settings) == r.settings, r.index
        assert j.transformed == r.transformed, r.index
    assert proc.batches == 3  # bucket 2048 holds 4 files, 4096 one
    back = UntransformBatchProcessor(fmt, device="cpu").process(
        [(r.transformed, r.settings) for r in got])
    assert back == data


@pytest.mark.parametrize("fmt", ["bc7", "bc6h"])
def test_mode_sort_batch_picks_are_the_per_file_argmin(fmt):
    """The batch step's picks before the identity guard equal the argmin of the
    per-file search's exact scores (ties to the first candidate); an empty payload
    picks the last candidate."""
    data = [testgen.bc7_realistic(n, seed=n) for n in (64, 700, 2049)]
    data += [b"", testgen.bc_blocks(300, 16, seed=3)]
    proc = ModeSortBatchProcessor(fmt, max_batch=2, device="cpu")
    proc.process(data)
    want = []
    for d in data:
        if not d:
            want.append(len(proc.settings) - 1)
            continue
        scores, _ = bc7.candidate_streams(
            backend.upload(d, torch.device("cpu")), bc7.BC7 if fmt == "bc7" else bc7.BC6H,
            LtuEstimation(), proc.settings, fmt.upper())
        want.append(int(np.argmin(scores)))
    assert proc.picks == want


@pytest.mark.parametrize("layout", LAYOUTS)
def test_rgb_batch_matches_jax(layout):
    data = [testgen.make_uncompressed_dds(layout, w, h, seed=w)[0x80:]
            for w, h in ((16, 16), (64, 32), (33, 7))] + [b""]
    want = jax_pipeline.RgbBatchProcessor(layout, JaxLtu(), max_batch=2).process(data)
    proc = RgbBatchProcessor(layout, LtuEstimation(), max_batch=2, device="cpu")
    got = proc.process(data)
    for j, r in zip(want, got):
        assert convert.from_reference(j.settings) == r.settings, r.index
        assert j.transformed == r.transformed, r.index
    assert proc.batches == 2
    back = UntransformBatchProcessor(layout, device="cpu").process(
        [(r.transformed, r.settings) for r in got])
    assert back == data


@pytest.mark.parametrize("fmt", ["bc7", "rgba8888"])
def test_batch_processors_reject_unaligned_payloads(fmt):
    from dxt_lossless_transform_tpu_torch.errors import RgbValidationError

    if fmt == "bc7":
        with pytest.raises(ValueError):
            ModeSortBatchProcessor("bc7", device="cpu").process([bytes(17)])
    else:
        with pytest.raises(RgbValidationError):
            RgbBatchProcessor(fmt, LtuEstimation(), device="cpu").process([bytes(6)])


def test_mode_sort_and_rgb_stage_times_are_kept_when_asked():
    data = [testgen.bc7_realistic(100, seed=1)]
    proc = ModeSortBatchProcessor("bc7", device="cpu", timing=True)
    proc.process(data)
    assert set(proc.times.seconds) == {"assemble", "h2d", "device", "d2h", "winners",
                                        "guard"}
    rgb = RgbBatchProcessor("bgr888", LtuEstimation(), device="cpu", timing=True)
    rgb.process([testgen.make_uncompressed_dds("bgr888", 8, 8)[0x80:]])
    assert set(rgb.times.seconds) == {"assemble", "h2d", "device", "d2h", "serialize"}

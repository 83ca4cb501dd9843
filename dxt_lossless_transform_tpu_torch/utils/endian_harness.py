"""The endian-portability harness (``debug-endian``), to the contract of
``dxt_lossless_transform_tpu/utils/endian_harness.py:59-213``.

The reference proves its on-disk format endian-portable by transforming on x86_64
and untransforming on big-endian powerpc64 under QEMU. Here the same property is
executed under :func:`..endian.simulate_big_endian`, which switches every host
boundary that reads or writes multi-byte integers to its big-endian form. Unlike
the JAX harness, which runs its numpy oracles, this one runs the port's own
transforms and untransforms on ``device``, so every transform and untransform kernel
runs under the simulation. For each format, settings combination and payload:

  1. transform on the native host == transform on the simulated big-endian host;
  2. untransform on the big-endian host of the native output == the original;
  3. untransform on the native host of the big-endian output == the original;
  4. the 4-byte header's bytes agree, and each host parses the other's;
  5. whole DDS files through :class:`..formats.handlers.DdsHandler` with a manual
     builder of each setting agree across hosts, both ways (header fields, magic and
     payload slicing all go through the endian layer).

The batch leg runs a few payloads of each of BC1-BC5 through
:class:`..parallel.BatchProcessor`, scored by LTU on the device and by zstd-1 on the
host, and :class:`..parallel.UntransformBatchProcessor` on both hosts and compares
the bytes and settings.

What the simulation cannot reach is listed in :mod:`..endian`: the kernels see
``uint8`` bytes on a little-endian card, the plain versions' ``int32`` views of CPU
tensors run in the host's real order, and tensors copied back from the card arrive
in its order.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .. import api, backend, endian
from ..formats.bundle import TransformBundle
from ..formats.dds import parse_dds
from ..formats.embed import TransformFormat, TransformHeader
from ..formats.handlers import DdsHandler
from ..ops import bc1, bc2, bc3, bc45, bc6h, bc7, rgb
from ..settings import (
    Bc1TransformSettings, Bc2TransformSettings, Bc3TransformSettings,
    Bc4TransformSettings, Bc5TransformSettings, Bc6hTransformSettings,
    Bc7TransformSettings, RgbTransformSettings,
)


@dataclass
class _Fmt:
    name: str
    block_size: int
    settings: tuple
    transform: Callable  # (data, settings, device) -> bytes
    untransform: Callable
    header: Callable  # settings -> TransformHeader
    settings_of: Callable  # TransformHeader -> settings
    builder: Callable  # settings -> a TransformBundle with that manual builder


def _formats() -> List[_Fmt]:
    mk = TransformHeader

    def bundle(slot: str, builder_cls):
        return lambda s: TransformBundle(**{slot: builder_cls(s)})

    out = [
        _Fmt("bc1", 8, tuple(Bc1TransformSettings.all_combinations()),
             bc1.transform, bc1.untransform, mk.for_bc1, mk.bc1_settings,
             bundle("bc1", api.Bc1ManualTransformBuilder)),
        _Fmt("bc2", 16, tuple(Bc2TransformSettings.all_combinations()),
             bc2.transform, bc2.untransform, mk.for_bc2, mk.bc2_settings,
             bundle("bc2", api.Bc2ManualTransformBuilder)),
        _Fmt("bc3", 16, tuple(Bc3TransformSettings.all_combinations()),
             bc3.transform, bc3.untransform, mk.for_bc3, mk.bc3_settings,
             bundle("bc3", api.Bc3ManualTransformBuilder)),
        _Fmt("bc4", 8, tuple(Bc4TransformSettings.all_combinations()),
             bc45.transform_bc4, bc45.untransform_bc4, mk.for_bc4, mk.bc4_settings,
             bundle("bc4", api.Bc4ManualTransformBuilder)),
        _Fmt("bc5", 16, tuple(Bc5TransformSettings.all_combinations()),
             bc45.transform_bc5, bc45.untransform_bc5, mk.for_bc5, mk.bc5_settings,
             bundle("bc5", api.Bc5ManualTransformBuilder)),
        _Fmt("bc7", 16, tuple(Bc7TransformSettings.all_combinations()),
             bc7.transform, bc7.untransform, mk.for_bc7, mk.bc7_settings,
             bundle("bc7", api.Bc7ManualTransformBuilder)),
        _Fmt("bc6h", 16, tuple(Bc6hTransformSettings.all_combinations()),
             bc6h.transform, bc6h.untransform, mk.for_bc6h, mk.bc6h_settings,
             bundle("bc6h", api.Bc6hManualTransformBuilder)),
    ]
    for tf in (TransformFormat.RGBA8888, TransformFormat.BGRA8888,
               TransformFormat.BGR888):
        layout = tf.name.lower()
        out.append(_Fmt(
            layout, 3 if layout == "bgr888" else 4,
            tuple(RgbTransformSettings.all_combinations()),
            (lambda d, s, dev, _l=layout: rgb.transform(d, _l, s, dev)),
            (lambda d, s, dev, _l=layout: rgb.untransform(d, _l, s, dev)),
            (lambda s, _tf=tf: TransformHeader.for_rgb(_tf, s)), mk.rgb_settings,
            (lambda s, _l=layout: TransformBundle(
                **{_l: api.RgbManualTransformBuilder(_l, s)}))))
    return out


@dataclass
class EndianReport:
    checks: int = 0
    per_format: Dict[str, int] = field(default_factory=dict)
    containers: int = 0
    batches: int = 0

    def ok(self) -> bool:  # the harness raises at the first mismatch instead
        return self.checks > 0


def _check_payload(f: _Fmt, payload: bytes, report: EndianReport, dev) -> None:
    for s in f.settings:
        t_le = f.transform(payload, s, dev)
        with endian.simulate_big_endian():
            t_be = f.transform(payload, s, dev)
        if t_le != t_be:
            raise AssertionError(f"{f.name} {s}: BE-host transform bytes differ")
        with endian.simulate_big_endian():
            back = f.untransform(t_le, s, dev)
        if back != payload:
            raise AssertionError(
                f"{f.name} {s}: transform(LE) -> untransform(BE) not identity")
        if f.untransform(t_be, s, dev) != payload:
            raise AssertionError(
                f"{f.name} {s}: transform(BE) -> untransform(LE) not identity")
        h_le = f.header(s).to_bytes()
        with endian.simulate_big_endian():
            h_be = f.header(s).to_bytes()
            parsed_be = f.settings_of(TransformHeader.from_bytes(h_le))
        if h_le != h_be:
            raise AssertionError(f"{f.name} {s}: header bytes differ on BE host")
        if parsed_be != s or f.settings_of(TransformHeader.from_bytes(h_be)) != s:
            raise AssertionError(f"{f.name} {s}: header parse-back differs across hosts")
        report.checks += 4
        report.per_format[f.name] = report.per_format.get(f.name, 0) + 4


def _container_roundtrip(data: bytes, f: _Fmt, s, report: EndianReport, dev) -> None:
    """A whole DDS file through the port's handler and a manual builder of ``s``, on
    both hosts, compared byte for byte."""
    handler, bundle = DdsHandler(dev), f.builder(s)
    t_le = handler.transform_bundle(data, bundle)
    with endian.simulate_big_endian():
        info_be = parse_dds(data)
        t_be = handler.transform_bundle(data, bundle)
    if parse_dds(data) != info_be:
        raise AssertionError(f"{f.name}: BE-host DDS parse differs")
    if t_le != t_be:
        raise AssertionError(f"{f.name} {s}: BE-host container transform differs")
    with endian.simulate_big_endian():
        back_be = handler.untransform(t_le)
    if back_be != data or handler.untransform(t_be) != data:
        raise AssertionError(f"{f.name} {s}: cross-host container round trip failed")
    report.containers += 1
    report.checks += 3


BATCH_FORMATS = ("bc1", "bc2", "bc3", "bc4", "bc5")


def _batch_roundtrip(fmt: str, payloads: list, report: EndianReport, dev) -> None:
    """``payloads`` through the batch processors on both hosts, scored by LTU on the
    device and by zstd-1 on the host (the card writes the bytes under either): the
    same bytes and settings, and each host restores the other's."""
    from ..estimate.zstd import ZstdEstimation
    from ..parallel import BatchProcessor, UntransformBatchProcessor

    for estimator in (None, ZstdEstimation(1)):
        def transform():
            return [(r.transformed, r.settings) for r in BatchProcessor(
                fmt, device=dev, estimator=estimator).process(payloads)]

        le = transform()
        with endian.simulate_big_endian():
            be = transform()
        if le != be:
            raise AssertionError(f"{fmt}: BE-host batch transform differs")
        with endian.simulate_big_endian():
            back_be = UntransformBatchProcessor(fmt, device=dev).process(le)
        if back_be != payloads or UntransformBatchProcessor(fmt, device=dev).process(
                be) != payloads:
            raise AssertionError(f"{fmt}: cross-host batch round trip failed")
        report.checks += 3
    report.batches += 1


# reference asset file -> format
ASSET_FMT = {"r2-256-bc1.dds": "bc1", "r2-256-bc2.dds": "bc2",
             "r2-256-bc3.dds": "bc3", "r2-256-bc7.dds": "bc7"}


def run_matrix(assets_dir: Optional[str] = None, n_blocks: int = 256, seed: int = 0,
               log=lambda *_: None,
               device: Union[str, torch.device] = "cuda") -> EndianReport:
    """Run the whole matrix on ``device``; raises :class:`AssertionError` at the first
    divergence."""
    from . import testgen

    dev = backend.resolve_device(device)
    rng = np.random.default_rng(seed)
    report = EndianReport()
    fmts = {f.name: f for f in _formats()}

    for f in fmts.values():
        payload = rng.integers(0, 256, f.block_size * n_blocks, dtype=np.uint8).tobytes()
        _check_payload(f, payload, report, dev)
        log(f"{f.name}: {len(f.settings)} settings x 4 checks ok (synthetic)")

    for name, data in (("bc1", testgen.make_dds("BC1", 32, 32, seed=3)),
                       ("bc3", testgen.make_dds("BC3", 16, 16, seed=4)),
                       ("bc7", testgen.make_dx10_dds("BC7", 16, 16, seed=5))):
        f = fmts[name]
        _container_roundtrip(data, f, f.settings[0], report, dev)
        log(f"{name}: synthetic container cross-host round trip ok")

    for fmt in BATCH_FORMATS:
        bs = fmts[fmt].block_size
        payloads = [rng.integers(0, 256, bs * n, dtype=np.uint8).tobytes()
                    for n in (n_blocks, n_blocks // 2 + 1, 1, 0)]
        _batch_roundtrip(fmt, payloads, report, dev)
        log(f"{fmt}: batch of {len(payloads)} payloads cross-host round trip ok")

    if assets_dir is not None:
        for fname, fmt in ASSET_FMT.items():
            path = os.path.join(assets_dir, fname)
            if not os.path.isfile(path):
                continue
            with open(path, "rb") as fh:
                data = fh.read()
            f = fmts[fmt]
            for s in f.settings:
                _container_roundtrip(data, f, s, report, dev)
            log(f"{fmt}: {fname} x {len(f.settings)} settings cross-host ok")
    return report

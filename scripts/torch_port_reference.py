"""Reference constants for the PyTorch port's chip smoke run (``chip_smoke.py``).

Builds the smoke run's BC1-BC5 DDS files (4096x4096, full 13-level mip chain, seed
below) with the JAX package's ``utils.testgen.make_dds`` and prints, for each
format and candidate set (FAST and COMPREHENSIVE for BC1-BC3; BC4 and BC5 have one,
``split_endpoints`` true then false): the exact integer LTU score of each candidate
(the numpy twin ``estimate.ltu._coverage_score_np``; for BC1 and BC2 on each
candidate's colour region, for BC3 the sum over its alpha-endpoint region and its
colour region, as ``ops/auto.py`` scores them, for BC4 and BC5 on its endpoint
streams, as ``ops/bc45.py`` does), the pick (first minimum), and the sha256 of the
file that the JAX package's ``DdsHandler`` writes with that pick through its manual
builder. For BC2, BC4 and BC5 it also runs the JAX package's own auto-search on
the payload and prints whether its pick agrees (``jax_pick_agrees``): above 2**24
its device scorer sums in f32, so it may differ on a near tie.

For BC7 and BC6H it builds the DX10 files of the smoke run (BC7: the JAX package's
``bc7_realistic`` payload; BC6H: uniform random blocks, ``bc_blocks``) and prints each
FAST candidate's whole transformed stream's exact score (the native exact twin
``runtime.ltu_estimate``) and the JAX package's own f32 scores (its
``LtuEstimation.estimate_batch``), the exact pick and JAX's, the zstd-1 sizes of
every candidate's stream through the native runtime, the identity guard's decision
on the exact pick (``kept``, ``identity`` or ``not applied``), the shipped
settings, the sha256 of the file the JAX package's ``DdsHandler`` writes with them,
whether the JAX package's own auto builder writes the same file
(``jax_shipped_agrees``), and the sha256 of the manual default (sort and planes).

For RGBA8888, BGRA8888 and BGR888 it builds the 4096x4096 single-level files of the
smoke run (``utils.testgen.make_uncompressed_dds(layout, 4096, 4096, seed=7)``) and
prints each of the four candidates' (``RGB_FAST_CANDIDATES``) whole transformed
stream's exact score (``runtime.ltu_estimate``) and the JAX package's own f32
scores, the exact pick and JAX's (``jax_pick_agrees``), the sha256 of the file the
JAX package's ``DdsHandler`` writes with the exact pick, whether its own auto builder
writes the same file (``jax_shipped_agrees``), and the sha256 of the file that
``TransformBundle.default_all()`` gives (decorrelate and split).

``BATCH`` is the batch corpus of ``chip_smoke.py``'s batch phase (:func:`corpus`):
for each of BC1-BC5, 32 payloads whose block counts are the full mip chains of
:data:`CORPUS_SIZES` in turn (the last one empty); for BC7 and BC6H 12 payloads up
to the 2048x2048 chain and an empty one; for each RGB layout 4 payloads up to
1024x1024 and an empty one. For each format it prints the pick of every payload
under the JAX batch pipeline's scoring, from the exact twin (``runtime.ltu_estimate``;
BC3 the alpha row's score plus the colour row's, BC5 the red endpoint row's plus
the green one's, as ``parallel/sharded.py`` scores them), the sha256 over the
concatenated outputs of those picks, and whether the JAX package's own
``BatchProcessor(fmt, max_batch=16)`` (f32 scores) picks the same
(``jax_pick_agrees``); for BC5 also the payloads where the per-file auto-search
(which scores red and green joined) picks otherwise. For BC7 and BC6H the shipped
settings come from the identity guard (zstd-1 through the native runtime) and their
sha256 is printed with the exact picks; for BC1 and BC3 also the picks and sha256 of
the JAX host-scored ``BatchProcessor(fmt, estimator=ZstdEstimation(1))``. Both of
these depend on the zstd library's version.

``CLI`` is the texture tree of ``chip_smoke.py``'s cli phase (:func:`cli_tree`): each
non-empty payload of the batch corpus as its DDS file (BC1-BC5 with legacy headers,
BC7 and BC6H with DX10 headers, the RGB layouts as their uncompressed files), one
subdirectory per format, with the 4096x4096 BC1 and BC7 files of the smoke run and
one ``junk.txt``. It prints the sha256 of the tree (:func:`tree_digest`: the sorted
relative paths and the bytes of every file), that of the JAX CLI's ``low`` output
tree, that of the ``medium`` tree with every pick scored by the exact twin (each
file through the route the CLI's ``_batchable`` gives it: the batch step's scores for
BC1-BC5, each candidate's whole stream and the zstd-1 identity guard for BC7 and
BC6H, the whole streams for the RGB layouts), whether the JAX CLI's own ``medium``
tree is the same (and the files where it is not), and the digests of the JAX CLI's
``optimal`` and ``max`` trees, which depend on the zstd library's version. Runs on the
CPU:

    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py [--formats BC2 BC4 BATCH CLI]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dxt_lossless_transform_tpu import runtime  # noqa: E402
from dxt_lossless_transform_tpu.api import (  # noqa: E402
    Bc1ManualTransformBuilder, Bc2ManualTransformBuilder, Bc3ManualTransformBuilder,
    Bc4ManualTransformBuilder, Bc5ManualTransformBuilder, Bc6hAutoTransformBuilder,
    Bc6hManualTransformBuilder, Bc7AutoTransformBuilder, Bc7ManualTransformBuilder,
    RgbAutoTransformBuilder, RgbManualTransformBuilder,
)
from dxt_lossless_transform_tpu.estimate.ltu import LtuEstimation  # noqa: E402
from dxt_lossless_transform_tpu.estimate.ltu import (  # noqa: E402
    DEFAULT_OFFSETS, _coverage_score_np,
)
from dxt_lossless_transform_tpu.formats.bundle import TransformBundle  # noqa: E402
from dxt_lossless_transform_tpu.formats.handlers import DdsHandler  # noqa: E402
from dxt_lossless_transform_tpu.ops import auto as jax_auto, bc45 as jax_bc45  # noqa: E402
from dxt_lossless_transform_tpu.ops.auto import _host_colour_regions  # noqa: E402
from dxt_lossless_transform_tpu.oracle import bc6h as oracle_bc6h  # noqa: E402
from dxt_lossless_transform_tpu.oracle import bc7 as oracle_bc7  # noqa: E402
from dxt_lossless_transform_tpu.oracle import rgb as oracle_rgb  # noqa: E402
from dxt_lossless_transform_tpu.oracle.bc4 import _ep_streams  # noqa: E402
from dxt_lossless_transform_tpu.settings import (  # noqa: E402
    BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES, BC2_COMPREHENSIVE_CANDIDATES,
    BC2_FAST_CANDIDATES, BC3_COMPREHENSIVE_CANDIDATES, BC3_FAST_CANDIDATES,
    BC6H_FAST_CANDIDATES, BC7_FAST_CANDIDATES, RGB_FAST_CANDIDATES,
    Bc4TransformSettings, Bc5TransformSettings,
)
from dxt_lossless_transform_tpu.utils.testgen import (  # noqa: E402
    bc_blocks, make_dds, make_dx10_dds, make_uncompressed_dds,
)

SIZE, MIPS, SEED = 4096, 13, 7
BLOCKS = 1398103  # blocks of a 4096x4096 chain of 13 levels


def _score(row: bytes) -> int:
    return int(_coverage_score_np(np.frombuffer(row, np.uint8), DEFAULT_OFFSETS))


def _key(settings) -> list:
    if hasattr(settings, "split_channels"):
        return [settings.decorrelate, settings.split_channels]
    if hasattr(settings, "sort_by_mode"):
        return [settings.sort_by_mode, settings.split_byte_planes]
    if hasattr(settings, "split_endpoints"):
        return [settings.split_endpoints]
    return ([int(settings.decorrelation_mode)]
            + ([settings.split_alpha_endpoints]
               if hasattr(settings, "split_alpha_endpoints") else [])
            + [settings.split_colour_endpoints])


def _pick(dds: bytes, cand, scores, bundle) -> dict:
    best = cand[int(np.argmin(scores))]
    out = DdsHandler().transform_bundle(dds, bundle(best))
    return {"scores": scores, "pick": _key(best),
            "sha256": hashlib.sha256(out).hexdigest()}


def _jax_agrees(result: dict, search) -> None:
    """Run the JAX package's own search; record its pick and whether it agrees."""
    start = time.perf_counter()
    _, settings = search()
    result["jax_pick"] = _key(settings)
    result["jax_pick_agrees"] = result["jax_pick"] == result["pick"]
    result["jax_search_s"] = round(time.perf_counter() - start, 1)


def bc1() -> dict:
    dds = make_dds("BC1", SIZE, SIZE, MIPS, seed=SEED)
    payload = dds[0x80:]
    colours = np.frombuffer(payload, "<u4").reshape(-1, 2)[:, 0].copy()
    result = {"blocks": len(payload) // 8, "payload_bytes": len(payload),
              "file_sha256": hashlib.sha256(dds).hexdigest()}
    for name, cand in (("fast", BC1_FAST_CANDIDATES),
                       ("comprehensive", BC1_COMPREHENSIVE_CANDIDATES)):
        key = tuple((int(c.decorrelation_mode), c.split_colour_endpoints) for c in cand)
        scores = [_score(r) for r in _host_colour_regions(colours, key)]
        result[name] = _pick(dds, cand, scores, lambda best: TransformBundle(
            bc1=Bc1ManualTransformBuilder(best)))
    return result


def bc3() -> dict:
    dds = make_dds("BC3", SIZE, SIZE, MIPS, seed=SEED)
    payload = dds[0x80:]
    words = np.frombuffer(payload, "<u4").reshape(-1, 4)
    colours = words[:, 2].copy()
    ep = (words[:, 0] & 0xFFFF).astype(np.int64)
    # the alpha rows of ops/auto.py:transform_bc3_auto's host path
    alpha = {False: ep.astype("<u2").tobytes(),
             True: (ep & 0xFF).astype(np.uint8).tobytes()
             + (ep >> 8).astype(np.uint8).tobytes()}
    alpha_scores = {sa: _score(row) for sa, row in alpha.items()}
    colour_scores = {}
    result = {"blocks": len(payload) // 16, "payload_bytes": len(payload),
              "file_sha256": hashlib.sha256(dds).hexdigest()}
    for name, cand in (("fast", BC3_FAST_CANDIDATES),
                       ("comprehensive", BC3_COMPREHENSIVE_CANDIDATES)):
        key = [(int(c.decorrelation_mode), c.split_colour_endpoints) for c in cand]
        todo = [k for k in dict.fromkeys(key) if k not in colour_scores]
        for k, row in zip(todo, _host_colour_regions(colours, todo)):
            colour_scores[k] = _score(row)
        scores = [alpha_scores[c.split_alpha_endpoints] + colour_scores[k]
                  for c, k in zip(cand, key)]
        result[name] = _pick(dds, cand, scores, lambda best: TransformBundle(
            bc3=Bc3ManualTransformBuilder(best)))
    return result


def bc2() -> dict:
    dds = make_dds("BC2", SIZE, SIZE, MIPS, seed=SEED)
    payload = dds[0x80:]
    colours = np.frombuffer(payload, "<u4").reshape(-1, 4)[:, 2].copy()
    result = {"blocks": len(payload) // 16, "payload_bytes": len(payload),
              "file_sha256": hashlib.sha256(dds).hexdigest()}
    for name, cand in (("fast", BC2_FAST_CANDIDATES),
                       ("comprehensive", BC2_COMPREHENSIVE_CANDIDATES)):
        key = tuple((int(c.decorrelation_mode), c.split_colour_endpoints) for c in cand)
        scores = [_score(r) for r in _host_colour_regions(colours, key)]
        result[name] = _pick(dds, cand, scores, lambda best: TransformBundle(
            bc2=Bc2ManualTransformBuilder(best)))
        _jax_agrees(result[name], lambda: jax_auto.transform_bc2_auto(
            payload, LtuEstimation(), name == "comprehensive"))
    return result


def bc45(fmt: str) -> dict:
    dds = make_dds(fmt, SIZE, SIZE, MIPS, seed=SEED)
    payload = dds[0x80:]
    halves = np.frombuffer(payload, "<u2").reshape(-1, 4)
    # BC4: one endpoint stream; BC5: red's then green's
    eps = ([halves[:, 0].copy()] if fmt == "BC4"
           else [halves[0::2, 0].copy(), halves[1::2, 0].copy()])
    cls, manual, search = {
        "BC4": (Bc4TransformSettings, Bc4ManualTransformBuilder,
                jax_bc45.transform_bc4_auto),
        "BC5": (Bc5TransformSettings, Bc5ManualTransformBuilder,
                jax_bc45.transform_bc5_auto)}[fmt]
    cand = tuple(cls.all_combinations())
    scores = [_score(b"".join(_ep_streams(ep, c.split_endpoints) for ep in eps))
              for c in cand]
    block = 8 if fmt == "BC4" else 16
    result = {"blocks": len(payload) // block, "payload_bytes": len(payload),
              "file_sha256": hashlib.sha256(dds).hexdigest()}
    result["auto"] = _pick(dds, cand, scores, lambda best: TransformBundle(
        **{fmt.lower(): manual(best)}))
    _jax_agrees(result["auto"], lambda: search(payload, LtuEstimation()))
    return result


def mode_sort(fmt: str) -> dict:
    if fmt == "BC7":
        dds = make_dx10_dds("BC7", SIZE, SIZE, MIPS, seed=SEED)
        oracle, cand = oracle_bc7, BC7_FAST_CANDIDATES
        manual, auto = Bc7ManualTransformBuilder, Bc7AutoTransformBuilder
    else:
        dds = make_dx10_dds("BC6H", SIZE, SIZE, MIPS,
                            payload=bc_blocks(BLOCKS, 16, SEED))
        oracle, cand = oracle_bc6h, BC6H_FAST_CANDIDATES
        manual, auto = Bc6hManualTransformBuilder, Bc6hAutoTransformBuilder
    payload = dds[0x94:]
    streams = [oracle.transform(payload, c) for c in cand]
    scores = [runtime.ltu_estimate(row) for row in streams]
    jax_scores = [float(v) for v in LtuEstimation().estimate_batch(streams)]
    best = int(np.argmin(scores))
    sizes = runtime.zstd_estimate_batch(streams, 1)
    ident = cand.index(next(c for c in cand
                            if not c.sort_by_mode and not c.split_byte_planes))
    if best == ident:
        guard, shipped = "not applied", ident
    else:
        guard, shipped = (("kept", best) if sizes[best] < sizes[ident]
                          else ("identity", ident))
    handler = DdsHandler()
    slot = fmt.lower()
    out = handler.transform_bundle(dds, TransformBundle(**{slot: manual(cand[shipped])}))
    start = time.perf_counter()
    jax_out = handler.transform_bundle(
        dds, TransformBundle(**{slot: auto(LtuEstimation())}))
    return {
        "blocks": len(payload) // 16, "payload_bytes": len(payload),
        "file_sha256": hashlib.sha256(dds).hexdigest(),
        "auto": {
            "scores": scores, "pick": _key(cand[best]), "jax_scores": jax_scores,
            "jax_pick": _key(cand[int(np.argmin(jax_scores))]),
            "jax_pick_agrees": int(np.argmin(jax_scores)) == best,
            "zstd1_sizes": sizes, "guard": guard, "shipped": _key(cand[shipped]),
            "sha256": hashlib.sha256(out).hexdigest(),
            "jax_shipped_agrees": jax_out == out,
            "jax_search_s": round(time.perf_counter() - start, 1),
            "transformed_bytes": len(out)},
        "manual_default_sha256": hashlib.sha256(handler.transform_bundle(
            dds, TransformBundle(**{slot: manual()}))).hexdigest(),
    }


def rgb(layout: str) -> dict:
    dds = make_uncompressed_dds(layout, SIZE, SIZE, seed=SEED)
    payload = dds[0x80:]
    cand = RGB_FAST_CANDIDATES
    streams = [oracle_rgb.transform(payload, layout, c) for c in cand]
    scores = [runtime.ltu_estimate(row) for row in streams]
    jax_scores = [float(v) for v in LtuEstimation().estimate_batch(streams)]
    del streams
    best, jax_best = int(np.argmin(scores)), int(np.argmin(jax_scores))
    handler = DdsHandler()
    out = handler.transform_bundle(dds, TransformBundle(
        **{layout: RgbManualTransformBuilder(layout, cand[best])}))
    start = time.perf_counter()
    jax_out = handler.transform_bundle(dds, TransformBundle(
        **{layout: RgbAutoTransformBuilder(layout, LtuEstimation())}))
    return {
        "pixels": SIZE * SIZE, "payload_bytes": len(payload),
        "file_sha256": hashlib.sha256(dds).hexdigest(),
        "auto": {
            "scores": scores, "pick": _key(cand[best]), "jax_scores": jax_scores,
            "jax_pick": _key(cand[jax_best]), "jax_pick_agrees": jax_best == best,
            "sha256": hashlib.sha256(out).hexdigest(),
            "jax_shipped_agrees": jax_out == out,
            "jax_search_s": round(time.perf_counter() - start, 1)},
        "default_all_sha256": hashlib.sha256(handler.transform_bundle(
            dds, TransformBundle.default_all())).hexdigest(),
    }


# the batch corpus: full mip chains of these sizes, in turn
CORPUS_SIZES = ((256, 256), (512, 512), (1024, 1024), (2048, 2048), (1000, 600),
                (300, 200), (2048, 1024), (4, 4))
MODE_SORT_SIZES = CORPUS_SIZES[:6] * 2
RGB_SIZES = ((128, 128), (256, 256), (640, 480), (1024, 1024))
BATCH_BLOCK = {"bc1": 8, "bc2": 16, "bc3": 16, "bc4": 8, "bc5": 16}


def chain_blocks(width: int, height: int) -> int:
    """Blocks of a full mip chain of a width x height texture."""
    total, w, h = 0, width, height
    for _ in range(max(width, height).bit_length()):
        total += ((w + 3) // 4) * ((h + 3) // 4)
        w, h = max(w // 2, 1), max(h // 2, 1)
    return total


def corpus(fmt: str) -> list:
    """The batch phase's payloads of ``fmt`` (``bc1``-``bc5``, ``bc7``, ``bc6h`` or an
    RGB layout), made from seed 7 by ``utils.testgen``."""
    from dxt_lossless_transform_tpu.utils.testgen import (
        bc1_realistic, bc2_realistic, bc3_realistic, bc7_realistic,
    )

    if fmt in BATCH_BLOCK:
        gen = {"bc1": bc1_realistic, "bc2": bc2_realistic, "bc3": bc3_realistic}.get(fmt)
        out = []
        for i in range(31):
            n = chain_blocks(*CORPUS_SIZES[i % len(CORPUS_SIZES)])
            out.append(gen(n, SEED + i) if gen else bc_blocks(n, BATCH_BLOCK[fmt], SEED + i))
        return out + [b""]
    if fmt in ("bc7", "bc6h"):
        return [bc7_realistic(chain_blocks(*size), SEED + i + (100 if fmt == "bc6h" else 0))
                for i, size in enumerate(MODE_SORT_SIZES)] + [b""]
    return [make_uncompressed_dds(fmt, w, h, seed=SEED + i)[0x80:]
            for i, (w, h) in enumerate(RGB_SIZES)] + [b""]


def _digest(outs) -> str:
    h = hashlib.sha256()
    for out in outs:
        h.update(out)
    return h.hexdigest()


def _batch_scores(fmt: str, data: bytes, cand) -> list:
    """Each candidate's exact score as the JAX batch step ranks it."""
    if fmt in ("bc1", "bc2", "bc3"):
        words = np.frombuffer(data, "<u4").reshape(-1, 2 if fmt == "bc1" else 4)
        colours = words[:, 0 if fmt == "bc1" else 2].copy()
        key = [(int(c.decorrelation_mode), c.split_colour_endpoints) for c in cand]
        rows = dict(zip(dict.fromkeys(key), _host_colour_regions(colours,
                                                                 list(dict.fromkeys(key)))))
        scores = [runtime.ltu_estimate(rows[k]) for k in key]
        if fmt == "bc3":
            ep = (words[:, 0] & 0xFFFF).astype(np.int64)
            alpha = {False: runtime.ltu_estimate(ep.astype("<u2").tobytes()),
                     True: runtime.ltu_estimate((ep & 0xFF).astype(np.uint8).tobytes()
                                                + (ep >> 8).astype(np.uint8).tobytes())}
            scores = [alpha[c.split_alpha_endpoints] + v for c, v in zip(cand, scores)]
        return scores
    halves = np.frombuffer(data, "<u2").reshape(-1, 4)
    eps = ([halves[:, 0].copy()] if fmt == "bc4"
           else [halves[0::2, 0].copy(), halves[1::2, 0].copy()])
    return [sum(runtime.ltu_estimate(_ep_streams(ep, c.split_endpoints)) for ep in eps)
            for c in cand]


def _joined_pick(data: bytes, cand) -> int:
    """The BC5 per-file auto-search's pick: red's and green's endpoint streams
    scored joined (``ops/bc45.py:transform_bc5_auto``)."""
    halves = np.frombuffer(data, "<u2").reshape(-1, 8)
    red, green = halves[:, 0].copy(), halves[:, 4].copy()
    return int(np.argmin([runtime.ltu_estimate(_ep_streams(red, c.split_endpoints)
                                               + _ep_streams(green, c.split_endpoints))
                          for c in cand]))


def _mode_sort_exact(oracle, cand, d: bytes) -> tuple:
    """(exact pick, shipped candidate, shipped stream) of a BC7/BC6H payload: the
    argmin of each candidate's whole stream under the exact twin, then the zstd-1
    identity guard."""
    ident = next(i for i, c in enumerate(cand)
                 if not c.sort_by_mode and not c.split_byte_planes)
    streams = [oracle.transform(d, c) for c in cand]
    best = int(np.argmin([runtime.ltu_estimate(s) for s in streams]))
    keep = best == ident or (lambda z: z[0] < z[1])(
        runtime.zstd_estimate_batch([streams[best], d], 1))
    ship = best if keep else ident
    return best, ship, streams[ship]


def batch() -> dict:
    from dxt_lossless_transform_tpu.estimate import ZstdEstimation
    from dxt_lossless_transform_tpu.oracle import bc1 as o1, bc2 as o2, bc3 as o3
    from dxt_lossless_transform_tpu.oracle import bc4 as o45
    from dxt_lossless_transform_tpu.parallel.pipeline import (
        BatchProcessor, ModeSortBatchProcessor, RgbBatchProcessor, _FORMATS,
    )

    transform = {"bc1": o1.transform, "bc2": o2.transform, "bc3": o3.transform,
                 "bc4": o45.transform_bc4, "bc5": o45.transform_bc5}
    out = {}
    for fmt in BATCH_BLOCK:
        start = time.perf_counter()
        data = corpus(fmt)
        cand = tuple(_FORMATS[fmt]["candidates"])
        picks = [int(np.argmin(_batch_scores(fmt, d, cand))) if d else len(cand) - 1
                 for d in data]
        result = {"payloads": len(data), "bytes": sum(map(len, data)), "picks": picks,
                  "sha256": _digest(transform[fmt](d, cand[p]) for d, p in zip(data, picks))}
        jax = BatchProcessor(fmt, max_batch=16).process(data)
        result["jax_picks"] = [cand.index(r.settings) for r in jax]
        result["jax_pick_agrees"] = result["jax_picks"] == picks
        if fmt == "bc5":
            per_file = [_joined_pick(d, cand) if d else len(cand) - 1 for d in data]
            result["per_file_differs"] = [i for i, (a, b) in enumerate(zip(per_file, picks))
                                          if a != b]
        if fmt in ("bc1", "bc3"):
            host = BatchProcessor(fmt, estimator=ZstdEstimation(1), max_batch=16).process(data)
            result["host_picks"] = [cand.index(r.settings) for r in host]
            result["host_sha256"] = _digest(r.transformed for r in host)
        result["seconds"] = round(time.perf_counter() - start, 1)
        out[fmt] = result
    for fmt, oracle, cand in (("bc7", oracle_bc7, BC7_FAST_CANDIDATES),
                              ("bc6h", oracle_bc6h, BC6H_FAST_CANDIDATES)):
        start = time.perf_counter()
        data = corpus(fmt)
        picks, shipped, outs = [], [], []
        for d in data:
            if not d:
                picks.append(len(cand) - 1)
                shipped.append(len(cand) - 1)
                outs.append(b"")
                continue
            best, ship, stream = _mode_sort_exact(oracle, cand, d)
            picks.append(best)
            shipped.append(ship)
            outs.append(stream)
        jax = ModeSortBatchProcessor(fmt, max_batch=16).process(data)
        out[fmt] = {"payloads": len(data), "bytes": sum(map(len, data)), "picks": picks,
                    "shipped": shipped, "sha256": _digest(outs),
                    "jax_shipped": [cand.index(r.settings) for r in jax],
                    "jax_shipped_agrees": [r.transformed for r in jax] == outs,
                    "seconds": round(time.perf_counter() - start, 1)}
    for layout in ("rgba8888", "bgra8888", "bgr888"):
        start = time.perf_counter()
        data = corpus(layout)
        cand = RGB_FAST_CANDIDATES
        picks = [int(np.argmin([runtime.ltu_estimate(oracle_rgb.transform(d, layout, c))
                                for c in cand])) if d else len(cand) - 1 for d in data]
        jax = RgbBatchProcessor(layout, LtuEstimation(), max_batch=16).process(data)
        out[layout] = {
            "payloads": len(data), "bytes": sum(map(len, data)), "picks": picks,
            "sha256": _digest(oracle_rgb.transform(d, layout, cand[p]) if d else b""
                              for d, p in zip(data, picks)),
            "jax_picks": [cand.index(r.settings) for r in jax],
            "seconds": round(time.perf_counter() - start, 1)}
        out[layout]["jax_pick_agrees"] = out[layout]["jax_picks"] == picks
    return out


def cli_tree(root) -> None:
    """Write the cli phase's texture tree under ``root`` (see the module docstring)."""
    from pathlib import Path

    root = Path(root)
    for fmt in list(BATCH_BLOCK) + ["bc7", "bc6h", "rgba8888", "bgra8888", "bgr888"]:
        (root / fmt).mkdir(parents=True)
    for fmt in BATCH_BLOCK:
        for i, payload in enumerate(corpus(fmt)):
            if payload:
                w, h = CORPUS_SIZES[i % len(CORPUS_SIZES)]
                header = make_dds(fmt.upper(), w, h, max(w, h).bit_length(),
                                  realistic=False)[:0x80]
                (root / fmt / f"{i:02d}_{w}x{h}.dds").write_bytes(header + payload)
    for fmt in ("bc7", "bc6h"):
        for i, payload in enumerate(corpus(fmt)):
            if payload:
                w, h = MODE_SORT_SIZES[i]
                (root / fmt / f"{i:02d}_{w}x{h}.dds").write_bytes(make_dx10_dds(
                    fmt.upper(), w, h, max(w, h).bit_length(), payload=payload))
    for layout in ("rgba8888", "bgra8888", "bgr888"):
        for i, (w, h) in enumerate(RGB_SIZES):
            (root / layout / f"{i:02d}_{w}x{h}.dds").write_bytes(
                make_uncompressed_dds(layout, w, h, seed=SEED + i))
    (root / "bc1" / f"{SIZE}x{SIZE}.dds").write_bytes(
        make_dds("BC1", SIZE, SIZE, MIPS, seed=SEED))
    (root / "bc7" / f"{SIZE}x{SIZE}.dds").write_bytes(
        make_dx10_dds("BC7", SIZE, SIZE, MIPS, seed=SEED))
    (root / "junk.txt").write_bytes(b"not a texture\n")


def tree_digest(root) -> str:
    """sha256 over every file under ``root``: its relative path, a zero byte and its
    bytes, in the order of the sorted relative paths."""
    from pathlib import Path

    root = Path(root)
    h = hashlib.sha256()
    for rel in sorted(p.relative_to(root).as_posix() for p in root.rglob("*")
                      if p.is_file()):
        h.update(rel.encode() + b"\0")
        h.update((root / rel).read_bytes())
    return h.hexdigest()


def _medium_exact(src) -> dict:
    """relative path -> the ``medium`` output file, each pick from the exact twin
    on the route the CLI gives the file."""
    from pathlib import Path

    from dxt_lossless_transform_tpu.cli.main import _batchable
    from dxt_lossless_transform_tpu.formats.dds import parse_dds
    from dxt_lossless_transform_tpu.formats.handlers import _DDS_TO_TRANSFORM
    from dxt_lossless_transform_tpu.parallel.pipeline import _FORMATS

    manual = {"bc1": Bc1ManualTransformBuilder, "bc2": Bc2ManualTransformBuilder,
              "bc3": Bc3ManualTransformBuilder, "bc4": Bc4ManualTransformBuilder,
              "bc5": Bc5ManualTransformBuilder, "bc7": Bc7ManualTransformBuilder,
              "bc6h": Bc6hManualTransformBuilder}
    handler, out = DdsHandler(), {}
    for f in sorted(p for p in Path(src).rglob("*") if p.is_file()):
        data = f.read_bytes()
        info = parse_dds(data)
        if info is None:
            continue
        fmt = _DDS_TO_TRANSFORM[info.format].name.lower()
        payload = data[info.data_offset:info.data_offset + info.data_length]
        if fmt in BATCH_BLOCK:
            if not _batchable(fmt, len(payload), "medium"):
                raise AssertionError(f"{f}: medium batches every BC1-BC5 payload")
            cand = tuple(_FORMATS[fmt]["candidates"])
            settings = cand[int(np.argmin(_batch_scores(fmt, payload, cand)))]
        elif fmt in ("bc7", "bc6h"):
            # batched or not, the LTU search ranks whole streams and guards alike
            oracle, cand = ((oracle_bc7, BC7_FAST_CANDIDATES) if fmt == "bc7"
                            else (oracle_bc6h, BC6H_FAST_CANDIDATES))
            settings = cand[_mode_sort_exact(oracle, cand, payload)[1]]
        else:
            cand = RGB_FAST_CANDIDATES
            settings = cand[int(np.argmin([runtime.ltu_estimate(
                oracle_rgb.transform(payload, fmt, c)) for c in cand]))]
        builder = (RgbManualTransformBuilder(fmt, settings) if fmt not in manual
                   else manual[fmt](settings))
        out[f.relative_to(src).as_posix()] = handler.transform_bundle(
            data, TransformBundle(**{fmt: builder}))
    return out


def cli() -> dict:
    import tempfile
    from pathlib import Path

    from dxt_lossless_transform_tpu.cli.main import main as jax_cli

    with tempfile.TemporaryDirectory(prefix="cli_reference_") as tmp:
        tmp = Path(tmp)
        src = tmp / "in"
        cli_tree(src)
        out = {"files": sum(1 for p in src.rglob("*") if p.is_file()),
               "bytes": sum(p.stat().st_size for p in src.rglob("*") if p.is_file()),
               "input_sha256": tree_digest(src)}
        for preset in ("low", "medium", "optimal", "max"):
            start = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):  # stdout holds the JSON only
                rc = jax_cli(["transform", str(src), str(tmp / preset), "--preset",
                              preset, "--threads", "4"])
            out[preset] = {"rc": rc, "jax_sha256": tree_digest(tmp / preset),
                           "seconds": round(time.perf_counter() - start, 1)}
        exact = tmp / "medium_exact"
        for rel, data in _medium_exact(src).items():
            (exact / rel).parent.mkdir(parents=True, exist_ok=True)
            (exact / rel).write_bytes(data)
        out["medium"]["sha256"] = tree_digest(exact)
        out["medium"]["jax_differs"] = sorted(
            rel.relative_to(exact).as_posix() for rel in exact.rglob("*")
            if rel.is_file() and rel.read_bytes() !=
            (tmp / "medium" / rel.relative_to(exact)).read_bytes())
    return out


FORMATS = {"BC1": bc1, "BC2": bc2, "BC3": bc3, "BC4": lambda: bc45("BC4"),
           "BC5": lambda: bc45("BC5"), "BC7": lambda: mode_sort("BC7"),
           "BC6H": lambda: mode_sort("BC6H"), "RGBA8888": lambda: rgb("rgba8888"),
           "BGRA8888": lambda: rgb("bgra8888"), "BGR888": lambda: rgb("bgr888"),
           "BATCH": batch, "CLI": cli}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--formats", nargs="+", default=list(FORMATS),
                        choices=list(FORMATS))
    args = parser.parse_args()
    out = {}
    for fmt in args.formats:
        start = time.perf_counter()
        out[fmt.lower()] = FORMATS[fmt]()
        out[fmt.lower()]["seconds"] = round(time.perf_counter() - start, 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

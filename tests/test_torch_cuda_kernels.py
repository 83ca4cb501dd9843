"""The twenty-six CUDA kernel entry points against their plain versions, on the
card, and the batch pipeline, on one device and under a mesh of the card repeated,
the decoders, normalization and its search, and the endian harness, on the card
against the same code on the CPU.

Marked ``cuda``: without a CUDA device they skip. On a machine with one (and
without JAX, which ``tests/conftest.py`` imports):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu_torch import backend
from dxt_lossless_transform_tpu_torch.estimate import cuda_ltu
from dxt_lossless_transform_tpu_torch.estimate.ltu import DEFAULT_OFFSETS, offset_weight
from dxt_lossless_transform_tpu_torch.ops.cuda import channels, planes, regions, shuffle
from dxt_lossless_transform_tpu_torch.ops import auto, bc45, bc6h, bc7, rgb
from dxt_lossless_transform_tpu_torch.utils import testgen
from dxt_lossless_transform_tpu_torch.settings import (
    BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES, BC2_COMPREHENSIVE_CANDIDATES,
    BC2_FAST_CANDIDATES, BC3_COMPREHENSIVE_CANDIDATES, BC3_FAST_CANDIDATES,
    Bc1TransformSettings, Bc2TransformSettings, Bc3TransformSettings,
    BC6H_FAST_CANDIDATES, BC7_FAST_CANDIDATES, Bc4TransformSettings,
    Bc5TransformSettings, YCoCgVariant,
)

pytestmark = pytest.mark.cuda

SETTINGS = list(Bc1TransformSettings.all_combinations())
BC3_SETTINGS = list(Bc3TransformSettings.all_combinations())
SIZES = [1, 3, 255, 257, 2048, 100003]
BC3_SIZES = [1, 2, 3, 5, 2047, 2049, 100003]
BC2_SETTINGS = list(Bc2TransformSettings.all_combinations())
# the sizes of the CPU tests against the JAX package, odd n included
SLICE3_SIZES = [1, 2, 3, 5, 2047, 2049, 70000]
# ladders of the generic count kernel: offsets beyond the 4096-byte halo, a
# 40-offset ladder, and one within the halo that is no prefix of the default ladder
# (the default without offset 3)
FAR_OFFSETS = (1, 2, 4096, 4097, 8192, 65536)
LADDER_40 = tuple(sorted(set(DEFAULT_OFFSETS) | {
    7, 9, 10, 11, 13, 14, 15, 20, 28, 40, 80, 160, 384, 768, 1536, 3072, 6144, 12288,
    24576, 49152}))
NEAR_LADDER = tuple(k for k in sorted(DEFAULT_OFFSETS) if k != 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _blocks(n, dev, size=8):
    data = np.random.default_rng(n).integers(0, 256, size * n, np.uint8)
    return torch.from_numpy(data).to(dev)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("s", SETTINGS, ids=str)
def test_shuffle_kernels(cuda, s, n):
    x = _blocks(n, cuda)
    v, sp = int(s.decorrelation_mode), s.split_colour_endpoints
    t = shuffle.bc1_transform(x, v, sp)
    assert torch.equal(t, shuffle.bc1_transform_plain(x, v, sp))
    u = shuffle.bc1_untransform(t, v, sp)
    assert torch.equal(u, shuffle.bc1_untransform_plain(t, v, sp))
    assert torch.equal(u, x)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("cand", [BC1_FAST_CANDIDATES, BC1_COMPREHENSIVE_CANDIDATES],
                         ids=["fast", "comprehensive"])
def test_regions_and_scorer_kernels(cuda, cand, n):
    x = _blocks(n, cuda)
    key = tuple((int(c.decorrelation_mode), c.split_colour_endpoints) for c in cand)
    rows = regions.bc1_regions(x, key)
    assert torch.equal(rows, regions.bc1_regions_plain(x, key))
    ks = sorted(DEFAULT_OFFSETS)
    ws = [offset_weight(k) for k in ks]
    for valid in sorted({4 * n, max(0, 4 * n - 7)}):
        assert torch.equal(cuda_ltu.ltu_counts(rows, valid, ks, ws),
                           cuda_ltu.ltu_counts_plain(rows, valid, ks, ws))


@pytest.mark.parametrize("length", [5, 4097, 20000])
def test_scorer_kernel_on_unaligned_rows(cuda, length):
    rng = np.random.default_rng(length)
    rows = torch.from_numpy(rng.integers(0, 3, (3, length), np.uint8)).to(cuda)
    ks = sorted(DEFAULT_OFFSETS)
    ws = [offset_weight(k) for k in ks]
    assert torch.equal(cuda_ltu.ltu_counts(rows, length, ks, ws),
                       cuda_ltu.ltu_counts_plain(rows, length, ks, ws))


@pytest.mark.parametrize("n", BC3_SIZES)
@pytest.mark.parametrize("s", BC3_SETTINGS, ids=str)
def test_bc3_shuffle_kernels(cuda, s, n):
    x = _blocks(n, cuda, 16)
    args = (int(s.decorrelation_mode), s.split_alpha_endpoints, s.split_colour_endpoints)
    t = shuffle.bc3_transform(x, *args)
    assert torch.equal(t, shuffle.bc3_transform_plain(x, *args))
    u = shuffle.bc3_untransform(t, *args)
    assert torch.equal(u, shuffle.bc3_untransform_plain(t, *args))
    assert torch.equal(u, x)


@pytest.mark.parametrize("n", BC3_SIZES)
@pytest.mark.parametrize("cand", [BC3_FAST_CANDIDATES, BC3_COMPREHENSIVE_CANDIDATES],
                         ids=["fast", "comprehensive"])
def test_bc3_regions_and_scorer_kernels(cuda, cand, n):
    x = _blocks(n, cuda, 16)
    alpha_keys, colour_keys, _, _ = auto.bc3_keys(cand)
    alpha, colour = regions.bc3_regions(x, alpha_keys, colour_keys)
    want_alpha, want_colour = regions.bc3_regions_plain(x, alpha_keys, colour_keys)
    assert torch.equal(alpha, want_alpha) and torch.equal(colour, want_colour)
    ks = sorted(DEFAULT_OFFSETS)
    ws = [offset_weight(k) for k in ks]
    for rows in (alpha, colour):
        length = rows.shape[1]
        for valid in sorted({length, max(0, length - 5)}):
            assert torch.equal(cuda_ltu.ltu_counts(rows, valid, ks, ws),
                               cuda_ltu.ltu_counts_plain(rows, valid, ks, ws))


def _periodic_rows(length, dev):
    """Rows that repeat with periods 4097, 8192 and 65536 under 20% noise, so that
    the far offsets find matches."""
    out = []
    for period in (4097, 8192, 65536):
        rng = np.random.default_rng(length + period)
        row = np.tile(rng.integers(0, 256, period, np.uint8), length // period + 1)
        row = row[:length].copy()
        noise = rng.random(length) < 0.2
        row[noise] = rng.integers(0, 3, int(noise.sum()))
        out.append(row)
    return torch.from_numpy(np.stack(out)).to(dev)


@pytest.mark.parametrize("length", [5, 4101, 70001, 140002])
@pytest.mark.parametrize("ks", [FAR_OFFSETS, LADDER_40, NEAR_LADDER],
                         ids=["far", "ladder40", "near"])
def test_scorer_kernel_far_and_many_offsets(cuda, ks, length):
    rows = _periodic_rows(length, cuda)
    ws = [offset_weight(k) for k in ks]
    for r in (rows, rows.reshape(-1)[1:1 + 2 * length].view(2, length)):  # unaligned
        for valid in (length, length - 3):
            assert torch.equal(cuda_ltu.ltu_counts(r, valid, ks, ws),
                               cuda_ltu.ltu_counts_plain(r, valid, ks, ws))
    neg = [-w for w in ws]
    assert torch.equal(cuda_ltu.ltu_counts(rows, length, ks, neg),
                       cuda_ltu.ltu_counts_plain(rows, length, ks, neg))


@pytest.mark.parametrize("n", SLICE3_SIZES)
@pytest.mark.parametrize("s", BC2_SETTINGS, ids=str)
def test_bc2_shuffle_kernels(cuda, s, n):
    x = _blocks(n, cuda, 16)
    v, sp = int(s.decorrelation_mode), s.split_colour_endpoints
    t = shuffle.bc2_transform(x, v, sp)
    assert torch.equal(t, shuffle.bc2_transform_plain(x, v, sp))
    u = shuffle.bc2_untransform(t, v, sp)
    assert torch.equal(u, shuffle.bc2_untransform_plain(t, v, sp))
    assert torch.equal(u, x)


@pytest.mark.parametrize("n", SLICE3_SIZES)
@pytest.mark.parametrize("cand", [BC2_FAST_CANDIDATES, BC2_COMPREHENSIVE_CANDIDATES],
                         ids=["fast", "comprehensive"])
def test_bc2_regions_kernel(cuda, cand, n):
    x = _blocks(n, cuda, 16)
    keys, _ = auto.colour_keys(cand)
    rows = regions.bc2_regions(x, keys)
    assert torch.equal(rows, regions.bc2_regions_plain(x, keys))
    ks = sorted(DEFAULT_OFFSETS)
    ws = [offset_weight(k) for k in ks]
    assert torch.equal(cuda_ltu.ltu_counts(rows, 4 * n, ks, ws),
                       cuda_ltu.ltu_counts_plain(rows, 4 * n, ks, ws))


@pytest.mark.parametrize("n", SLICE3_SIZES)
@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("fmt", ["BC4", "BC5"])
def test_bc45_shuffle_kernels(cuda, fmt, split, n):
    size = 8 if fmt == "BC4" else 16
    kernels = {"BC4": (shuffle.bc4_transform, shuffle.bc4_transform_plain,
                       shuffle.bc4_untransform, shuffle.bc4_untransform_plain),
               "BC5": (shuffle.bc5_transform, shuffle.bc5_transform_plain,
                       shuffle.bc5_untransform, shuffle.bc5_untransform_plain)}[fmt]
    t_kernel, t_plain, u_kernel, u_plain = kernels
    x = _blocks(n, cuda, size)
    t = t_kernel(x, split)
    assert torch.equal(t, t_plain(x, split))
    u = u_kernel(t, split)
    assert torch.equal(u, u_plain(t, split))
    assert torch.equal(u, x)


@pytest.mark.parametrize("fmt", ["BC4", "BC5"])
def test_bc45_auto_on_the_card(cuda, fmt):
    """The search's scores on the card equal those of its plain versions on the
    CPU, and so do the pick and the bytes."""
    from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation

    size, ep, search, kernel = {
        "BC4": (8, 2, bc45.transform_bc4_auto, shuffle.bc4_transform),
        "BC5": (16, 4, bc45.transform_bc5_auto, shuffle.bc5_transform)}[fmt]
    n = 30001
    data = _blocks(n, "cpu", size).numpy().tobytes()
    assert search(data, LtuEstimation()) == search(data, LtuEstimation(), device="cpu")
    cand = (Bc4TransformSettings if fmt == "BC4" else Bc5TransformSettings
            ).all_combinations()
    cand = tuple(cand)
    on_card, _ = bc45.endpoint_scores(fmt, _blocks(n, cuda, size), LtuEstimation(), cand,
                                      ep * n, kernel)
    on_cpu, _ = bc45.endpoint_scores(fmt, _blocks(n, "cpu", size), LtuEstimation(),
                                     cand, ep * n, kernel)
    assert on_card.tolist() == on_cpu.tolist()


def test_counts_of_more_rows_than_grid_y(cuda):
    """70,000 rows: the entry point launches once per 65,535 of them."""
    rng = np.random.default_rng(70000)
    rows = torch.from_numpy(rng.integers(0, 3, (70000, 12), np.uint8)).to(cuda)
    ks = sorted(DEFAULT_OFFSETS)
    ws = [offset_weight(k) for k in ks]
    backend.reset_launch_counts()
    counts = cuda_ltu.ltu_counts(rows, 12, ks, ws)
    assert backend.LAUNCHES["dlt_ltu_counts"] == 1
    assert torch.equal(counts, cuda_ltu.ltu_counts_plain(rows, 12, ks, ws))


def test_each_wrapper_counts_its_launches(cuda):
    x = _blocks(64, cuda)
    backend.reset_launch_counts()
    t = shuffle.bc1_transform(x, 1, True)
    shuffle.bc1_untransform(t, 1, True)
    rows = regions.bc1_regions(x, ((1, True),))
    cuda_ltu.ltu_counts(rows, rows.shape[1], [1], [24])
    t3 = shuffle.bc3_transform(x, 1, True, False)
    shuffle.bc3_untransform(t3, 1, True, False)
    regions.bc3_regions(x, (True,), ((1, True),))
    t2 = shuffle.bc2_transform(x, 1, True)
    shuffle.bc2_untransform(t2, 1, True)
    regions.bc2_regions(x, ((1, True),))
    shuffle.bc4_untransform(shuffle.bc4_transform(x, True), True)
    shuffle.bc5_untransform(shuffle.bc5_transform(x, False), False)
    planes.bc7_untransform(planes.bc7_transform(x, planes.BC6H, True, True), 32, True,
                           True)
    rgb_args = (*channels.LAYOUTS["bgr888"], True, False)
    channels.rgb_untransform(channels.rgb_transform(x[:510], *rgb_args), *rgb_args)
    planes.deinterleave_words(x.view(torch.int32), 4)
    cuda_ltu.ltu_counts(rows, torch.tensor([rows.shape[1]]), [1], [24])
    window = torch.nn.functional.pad(rows, (cuda_ltu.SPAN, cuda_ltu.SPAN))
    cuda_ltu.ltu_counts_windowed(window, torch.tensor([rows.shape[1]]), -cuda_ltu.SPAN,
                                 [1], [24])
    best = torch.zeros(2, dtype=torch.int64, device=cuda)
    for fmt, key in ROW_KEYS.items():
        shuffle.transform_rows(fmt, x.view(2, -1), [1, 2], best, [key])
    torch.cuda.synchronize()
    assert backend.LAUNCHES == {"dlt_bc1_transform": 1, "dlt_bc1_untransform": 1,
                                "dlt_bc1_regions": 1, "dlt_ltu_counts": 1,
                                "dlt_ltu_counts_rows": 1, "dlt_ltu_counts_windowed": 1,
                                "dlt_deinterleave_words": 1,
                                "dlt_bc3_transform": 1, "dlt_bc3_untransform": 1,
                                "dlt_bc3_regions": 1, "dlt_bc2_transform": 1,
                                "dlt_bc2_untransform": 1, "dlt_bc2_regions": 1,
                                "dlt_bc4_transform": 1, "dlt_bc4_untransform": 1,
                                "dlt_bc5_transform": 1, "dlt_bc5_untransform": 1,
                                "dlt_bc7_transform": 1, "dlt_bc7_untransform": 1,
                                "dlt_rgb_transform": 1, "dlt_rgb_untransform": 1,
                                **{f"dlt_{fmt}_transform_rows": 1 for fmt in ROW_KEYS}}


# a candidate key of each format's rows kernel
ROW_KEYS = {"bc1": (1, True), "bc2": (1, True), "bc3": (1, True, False), "bc4": (True,),
            "bc5": (False,)}
ROW_BLOCK_SIZE = {"bc1": 8, "bc2": 16, "bc3": 16, "bc4": 8, "bc5": 16}
# each format's every FAST candidate (BC4/BC5: both split_endpoints), as keys
ROW_CANDIDATES = {
    "bc1": [(int(c.decorrelation_mode), c.split_colour_endpoints) for c in BC1_FAST_CANDIDATES],
    "bc2": [(int(c.decorrelation_mode), c.split_colour_endpoints) for c in BC2_FAST_CANDIDATES],
    "bc3": [(int(c.decorrelation_mode), c.split_alpha_endpoints, c.split_colour_endpoints)
            for c in BC3_FAST_CANDIDATES],
    "bc4": [(False,), (True,)],
    "bc5": [(False,), (True,)],
}
# per-row block counts of one batch: odd, 1, even, the whole bucket, 0 (a row left
# out), in a bucket of 4099 blocks
ROW_COUNTS = [4099, 1, 2, 3, 2049, 4098, 0, 255, 1024]


@pytest.mark.parametrize("fmt", list(ROW_KEYS))
def test_transform_rows_kernels(cuda, fmt):
    """Every FAST candidate, each on several rows of one batch (mixed winners, block
    counts odd, 1, several lengths, 0): each row's first block_size·n_r bytes equal
    the plain version's and the per-file kernel's on the row's blocks; the bytes past
    them are not written."""
    bs, cands = ROW_BLOCK_SIZE[fmt], ROW_CANDIDATES[fmt]
    bucket = max(ROW_COUNTS)
    rng = np.random.default_rng(len(cands))
    ns = ROW_COUNTS * len(cands)
    B = len(ns)
    x = torch.from_numpy(rng.integers(0, 256, (B, bs * bucket), np.uint8)).to(cuda)
    best = torch.tensor([c for c in range(len(cands)) for _ in ROW_COUNTS],
                        dtype=torch.int64)[torch.from_numpy(rng.permutation(B))]
    best_dev = best.to(cuda)
    got = shuffle.transform_rows(fmt, x, ns, best_dev, cands)
    plain = shuffle.transform_rows_plain(fmt, x.cpu(), ns, best, cands)
    transform = getattr(shuffle, f"{fmt}_transform")
    for r, (n, k) in enumerate(zip(ns, best.tolist())):
        assert torch.equal(got[r, :bs * n].cpu(), plain[r, :bs * n]), (r, n, cands[k])
        if n:
            assert torch.equal(got[r, :bs * n], transform(x[r, :bs * n], *cands[k]))
    # the rows' tails are left as they were: the entry point writing into a buffer
    # filled with a marker leaves the marker past each row's bytes
    marker = torch.full_like(x, 0xA5)
    counts = torch.tensor(ns, device=cuda)
    backend.launch(f"dlt_{fmt}_transform_rows", cuda, x.data_ptr(), marker.data_ptr(),
                   counts.data_ptr(), best_dev.data_ptr(), B, bucket,
                   shuffle.rows_code(fmt, cands), len(cands))
    for r, n in enumerate(ns):
        assert bool((marker[r, bs * n:] == 0xA5).all()), (r, n)
        assert torch.equal(marker[r, :bs * n], got[r, :bs * n])


def test_transform_rows_of_more_rows_than_grid_y(cuda):
    """70,000 one-block rows: the entry point launches once per 65,535 of them."""
    rng = np.random.default_rng(70002)
    x = torch.from_numpy(rng.integers(0, 256, (70_000, 16), np.uint8)).to(cuda)
    cands = ROW_CANDIDATES["bc3"]
    best = torch.from_numpy(rng.integers(0, len(cands), 70_000)).to(cuda)
    ns = [int(n) for n in rng.integers(0, 2, 70_000)]
    backend.reset_launch_counts()
    got = shuffle.transform_rows("bc3", x, ns, best, cands)
    assert backend.LAUNCHES["dlt_bc3_transform_rows"] == 1
    want = shuffle.transform_rows_plain("bc3", x.cpu(), ns, best.cpu(), cands)
    keep = torch.tensor(ns, dtype=torch.bool)
    assert torch.equal(got.cpu()[keep], want[keep])


def test_wrappers_check_their_inputs(cuda):
    with pytest.raises(ValueError):
        shuffle.bc1_transform(torch.zeros(8, dtype=torch.int32, device=cuda), 0, False)
    with pytest.raises(ValueError):
        shuffle.bc1_transform(torch.zeros(17, dtype=torch.uint8, device=cuda)[1:], 0,
                              False)
    with pytest.raises(ValueError):
        cuda_ltu.ltu_counts(torch.zeros((1, 16), dtype=torch.uint8, device=cuda), 16,
                            [1], [256])
    with pytest.raises(ValueError):
        shuffle.bc3_transform(torch.zeros(40, dtype=torch.uint8, device=cuda)[8:], 0,
                              False, False)
    with pytest.raises(ValueError):
        shuffle.bc2_transform(torch.zeros(40, dtype=torch.uint8, device=cuda)[8:], 0,
                              False)
    with pytest.raises(ValueError):
        shuffle.bc5_transform(torch.zeros(40, dtype=torch.uint8, device=cuda)[8:], True)
    with pytest.raises(ValueError):
        shuffle.bc4_transform(torch.zeros(20, dtype=torch.uint8, device=cuda)[4:], True)
    with pytest.raises(ValueError):  # the transform reads 16-byte blocks
        planes.bc7_transform(torch.zeros(40, dtype=torch.uint8, device=cuda)[8:], 0,
                             True, True)
    with pytest.raises(ValueError):  # the untransform reads aligned words
        planes.bc7_untransform(torch.zeros(36, dtype=torch.uint8, device=cuda)[2:], 2,
                               True, True)
    with pytest.raises(ValueError):  # no layout has this channel map
        channels.rgb_transform(torch.zeros(12, dtype=torch.uint8, device=cuda), 4, 1, 0,
                               2, True, True)
    with pytest.raises(ValueError):  # out on another device
        channels.rgb_untransform(torch.zeros(12, dtype=torch.uint8, device=cuda), 3, 2, 1,
                                 0, True, True, out=torch.zeros(12, dtype=torch.uint8))
    best = torch.zeros(2, dtype=torch.int64, device=cuda)
    rows = torch.zeros((2, 32), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):  # a block count past the bucket
        shuffle.transform_rows("bc3", rows, [1, 3], best, [(0, False, False)])
    with pytest.raises(ValueError):  # best on the host
        shuffle.transform_rows("bc3", rows, [1, 2], best.cpu(), [(0, False, False)])
    with pytest.raises(ValueError):  # more candidates than the kernel's 16
        shuffle.transform_rows("bc4", rows, [1, 2], best, [(False,)] * 17)
    with pytest.raises(ValueError):  # rows of no whole number of blocks
        shuffle.transform_rows("bc1", torch.zeros((2, 12), dtype=torch.uint8,
                                                  device=cuda), [1, 1], best, [(0, False)])


def test_short_inputs_on_the_card(cuda):
    """Inputs shorter than one block give empty output and the last candidate."""
    from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation

    for size in range(1, 16):
        assert auto.transform_bc3_auto(bytes(size), LtuEstimation()) == \
            (b"", BC3_FAST_CANDIDATES[-1])
    for size in range(1, 8):
        assert auto.transform_bc1_auto(bytes(size), LtuEstimation()) == \
            (b"", BC1_FAST_CANDIDATES[-1])
        assert bc45.transform_bc4_auto(bytes(size), LtuEstimation()) == \
            (b"", Bc4TransformSettings(False))
    for size in range(1, 16):
        assert auto.transform_bc2_auto(bytes(size), LtuEstimation()) == \
            (b"", BC2_FAST_CANDIDATES[-1])
        assert bc45.transform_bc5_auto(bytes(size), LtuEstimation()) == \
            (b"", Bc5TransformSettings(False))


# the sizes of the CPU tests, and two more chunks' worth with a ragged tail
BC7_SIZES = [1, 2, 3, 4095, 4096, 4097, 8197, 70001]


def _bc7_blocks(n, dev, kind):
    rng = np.random.default_rng(n)
    if kind == "random":
        blocks = rng.integers(0, 256, (n, 16), np.uint8)
        blocks[rng.random(n) < 0.125, 0] = 0  # BC7's invalid id 8
    else:
        modes = rng.choice([4, 5, 6], size=n, p=[0.2, 0.3, 0.5])
        blocks = rng.integers(0, 24, (n, 16), np.uint8)
        blocks[:, 0] = (1 << modes).astype(np.uint8)
    return torch.from_numpy(blocks.reshape(-1)).to(dev)


@pytest.mark.parametrize("kind", ["random", "realistic"])
@pytest.mark.parametrize("n", BC7_SIZES)
@pytest.mark.parametrize("planes_", [True, False], ids=["planes", "blocks"])
@pytest.mark.parametrize("sort", [True, False], ids=["sort", "nosort"])
@pytest.mark.parametrize("fmt", [planes.BC7, planes.BC6H], ids=["bc7", "bc6h"])
def test_bc7_kernels(cuda, fmt, sort, planes_, n, kind):
    x = _bc7_blocks(n, cuda, kind)
    t = planes.bc7_transform(x, fmt, sort, planes_)
    assert torch.equal(t, planes.bc7_transform_plain(x, fmt, sort, planes_))
    u = planes.bc7_untransform(t, n, sort, planes_)
    assert torch.equal(u, planes.bc7_untransform_plain(t, n, sort, planes_))
    assert torch.equal(u, x)


# the transform's three launching forms: (sort, planes)
BC7_FORMS = [(True, True), (True, False), (False, True)]
BC7_FORM_IDS = ["sort_planes", "sort_blocks", "planes"]


@pytest.mark.parametrize("form", BC7_FORMS, ids=BC7_FORM_IDS)
@pytest.mark.parametrize("fmt", [planes.BC7, planes.BC6H], ids=["bc7", "bc6h"])
@pytest.mark.parametrize("offset", range(16))
def test_bc7_transform_into_unaligned_rows(cuda, offset, fmt, form):
    """The search writes each candidate into a row of one tensor: any alignment, so
    every misalignment of the mode stream, the sorted blocks and each plane row, and
    nothing written outside the row."""
    sort, split = form
    n = 4099
    x = _bc7_blocks(n, cuda, "random")
    length = planes.transformed_len(n, sort)
    buf = torch.full((length + 32,), 0xAB, dtype=torch.uint8, device=cuda)
    planes.bc7_transform(x, fmt, sort, split, out=buf[offset:offset + length])
    assert torch.equal(buf[offset:offset + length],
                       planes.bc7_transform_plain(x, fmt, sort, split))
    assert bool((buf[:offset] == 0xAB).all()) and bool((buf[offset + length:] == 0xAB).all())


# the sizes about one and two chunks, one chunk per id (the ragged last chunk a
# single block) and the 4096x4096 files' 342 chunks
EDGE_SIZES = [4095, 4096, 4097, 8191, 8193, "chunk_per_id", 1_398_103]


@pytest.mark.parametrize("form", BC7_FORMS, ids=BC7_FORM_IDS)
@pytest.mark.parametrize("n", EDGE_SIZES, ids=str)
@pytest.mark.parametrize("pattern", testgen.MODE_SORT_EDGES)
@pytest.mark.parametrize("fmt", ["BC7", "BC6H"])
def test_bc7_kernels_on_edge_chunks(cuda, fmt, pattern, n, form):
    """Chunks that stress the counting sort: one id throughout, every id in turn
    (BC7's invalid 8 included), ids descending, one chunk per id."""
    sort, split = form
    fmt_id = {"BC7": planes.BC7, "BC6H": planes.BC6H}[fmt]
    if n == "chunk_per_id":
        n = len(testgen.MODE_BYTE0[fmt]) * planes.SORT_CHUNK_BLOCKS + 1
    x = backend.upload(testgen.mode_sort_edges(fmt, n, pattern, seed=n), cuda)
    t = planes.bc7_transform(x, fmt_id, sort, split)
    assert torch.equal(t, planes.bc7_transform_plain(x, fmt_id, sort, split))
    assert torch.equal(planes.bc7_untransform(t, n, sort, split), x)


@pytest.mark.parametrize("form", BC7_FORMS, ids=BC7_FORM_IDS)
@pytest.mark.parametrize("fmt", [planes.BC7, planes.BC6H], ids=["bc7", "bc6h"])
def test_bc7_transform_runs_in_one_wave(cuda, fmt, form):
    """The 4096x4096 files' 342 chunks fit on the card at once: one 256-thread block
    a chunk."""
    shape = planes.transform_launch_shape(1_398_103, fmt, *form, cuda)
    assert shape["grid"] == 342 and shape["threads"] == 256 and shape["span"] == 4096
    assert shape["grid"] <= shape["resident"]


@pytest.mark.parametrize("fmt", ["BC7", "BC6H"])
def test_bc7_auto_on_the_card(cuda, fmt):
    """The search on the card: the same scores, pick and bytes as its plain versions
    on the CPU."""
    from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation

    search, fmt_id, cand = {"BC7": (bc7.transform_bc7_auto, planes.BC7,
                                    BC7_FAST_CANDIDATES),
                            "BC6H": (bc6h.transform_bc6h_auto, planes.BC6H,
                                     BC6H_FAST_CANDIDATES)}[fmt]
    for kind in ("random", "realistic"):
        data = _bc7_blocks(30001, "cpu", kind).numpy().tobytes()
        assert search(data, LtuEstimation()) == search(data, LtuEstimation(),
                                                       device="cpu")
        x = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        on_card, _ = bc7.candidate_streams(x.to(cuda), fmt_id, LtuEstimation(), cand, fmt)
        on_cpu, _ = bc7.candidate_streams(x, fmt_id, LtuEstimation(), cand, fmt)
        assert on_card.tolist() == on_cpu.tolist()


def test_bc7_short_inputs_on_the_card(cuda):
    from dxt_lossless_transform_tpu_torch.errors import (
        Bc6hValidationError, Bc7ValidationError,
    )
    from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation

    assert bc7.transform_bc7_auto(b"", LtuEstimation()) == (b"", BC7_FAST_CANDIDATES[-1])
    assert bc6h.transform_bc6h_auto(b"", LtuEstimation()) == \
        (b"", BC6H_FAST_CANDIDATES[-1])
    for size in (1, 15, 17):
        with pytest.raises(Bc7ValidationError):
            bc7.transform_bc7_auto(bytes(size), LtuEstimation())
        with pytest.raises(Bc6hValidationError):
            bc6h.transform_bc6h_auto(bytes(size), LtuEstimation())


# the pixel counts of the CPU tests, and tiles of 4096 pixels with ragged tails
RGB_SIZES = [1, 2, 3, 4, 5, 4095, 4096, 4097, 12291, 70001]
RGB_SETTINGS = [(True, True), (True, False), (False, True), (False, False)]


def _pixels(n, stride, dev, offset=0):
    data = np.random.default_rng(n + offset).integers(0, 256, stride * n + 8, np.uint8)
    return torch.from_numpy(data).to(dev)[offset:offset + stride * n]


@pytest.mark.parametrize("n", RGB_SIZES)
@pytest.mark.parametrize("dec,split", RGB_SETTINGS)
@pytest.mark.parametrize("layout", list(channels.LAYOUTS))
def test_rgb_kernels(cuda, layout, dec, split, n):
    args = (*channels.LAYOUTS[layout], dec, split)
    x = _pixels(n, args[0], cuda)
    t = channels.rgb_transform(x, *args)
    assert torch.equal(t, channels.rgb_transform_plain(x, *args))
    u = channels.rgb_untransform(t, *args)
    assert torch.equal(u, channels.rgb_untransform_plain(t, *args))
    assert torch.equal(u, x)


@pytest.mark.parametrize("out_offset", [0, 1, 2, 3])
@pytest.mark.parametrize("in_offset", [1, 2, 3])
@pytest.mark.parametrize("layout", list(channels.LAYOUTS))
def test_rgb_kernels_at_unaligned_offsets(cuda, layout, in_offset, out_offset):
    """Input and output rows at byte offsets 1-3 into larger tensors, odd n: the
    bytes around them stay as they were."""
    n = 8193
    stride = channels.LAYOUTS[layout][0]
    for dec, split in RGB_SETTINGS[:3]:
        args = (*channels.LAYOUTS[layout], dec, split)
        x = _pixels(n, stride, cuda, in_offset)
        for fn, plain in ((channels.rgb_transform, channels.rgb_transform_plain),
                          (channels.rgb_untransform, channels.rgb_untransform_plain)):
            buf = torch.full((stride * n + 8,), 0xAB, dtype=torch.uint8, device=cuda)
            out = buf[out_offset:out_offset + stride * n]
            fn(x, *args, out=out)
            assert torch.equal(out, plain(x, *args))
            assert bool((buf[:out_offset] == 0xAB).all())
            assert bool((buf[out_offset + stride * n:] == 0xAB).all())


@pytest.mark.parametrize("layout", list(channels.LAYOUTS))
def test_rgb_auto_on_the_card(cuda, layout):
    """The search on the card: the same scores, pick and bytes as its plain versions
    on the CPU, on a gradient image and on random pixels, at an odd pixel count."""
    from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
    from dxt_lossless_transform_tpu_torch.settings import RGB_FAST_CANDIDATES
    from dxt_lossless_transform_tpu_torch.utils.testgen import make_uncompressed_dds

    stride = channels.LAYOUTS[layout][0]
    for data in (make_uncompressed_dds(layout, 211, 97, seed=5)[0x80:],
                 _pixels(211 * 97, stride, "cpu").numpy().tobytes()):
        assert rgb.transform_rgb_auto(data, layout, LtuEstimation()) == \
            rgb.transform_rgb_auto(data, layout, LtuEstimation(), device="cpu")
        x = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        on_card, _ = rgb.candidate_rows(x.to(cuda), layout, LtuEstimation(),
                                        RGB_FAST_CANDIDATES)
        on_cpu, _ = rgb.candidate_rows(x, layout, LtuEstimation(), RGB_FAST_CANDIDATES)
        assert on_card.tolist() == on_cpu.tolist()


def test_rgb_edge_cases_on_the_card(cuda):
    from dxt_lossless_transform_tpu_torch.errors import RgbValidationError
    from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
    from dxt_lossless_transform_tpu_torch.settings import RGB_FAST_CANDIDATES

    for layout, (stride, *_) in channels.LAYOUTS.items():
        assert rgb.transform_rgb_auto(b"", layout, LtuEstimation()) == \
            (b"", RGB_FAST_CANDIDATES[-1])
        for size in list(range(1, stride)) + [stride + 1]:
            with pytest.raises(RgbValidationError):
                rgb.transform_rgb_auto(bytes(size), layout, LtuEstimation())



WORD_SIZES = [1, 2, 3, 1023, 1024, 1025, 4095, 4096, 4097, 100_003]


@pytest.mark.parametrize("n", WORD_SIZES)
@pytest.mark.parametrize("k", [2, 4])
def test_deinterleave_words_kernel(cuda, k, n):
    rng = np.random.default_rng(k * n)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, k * n, np.int32)).to(cuda)
    got = planes.deinterleave_words(x, k)
    want = planes.deinterleave_words_plain(x, k)
    assert len(got) == k
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# per-row lengths from 0 to the row: 0-3 (no whole gram), odd, within and beyond the
# 4096-byte halo, the whole row
ROW_LENGTHS = [0, 1, 2, 3, 4, 5, 7, 4099, 8191, 8195, 20_001, 65_535, 65_536]


@pytest.mark.parametrize("offsets", [tuple(sorted(DEFAULT_OFFSETS)), FAR_OFFSETS,
                                     LADDER_40, NEAR_LADDER],
                         ids=["default", "far", "ladder40", "near"])
def test_counts_rows_kernel(cuda, offsets):
    rng = np.random.default_rng(len(offsets))
    rows = torch.from_numpy(rng.integers(0, 3, (len(ROW_LENGTHS), 65_536),
                                         np.uint8)).to(cuda)
    ws = [offset_weight(k) for k in offsets]
    valid = torch.tensor(ROW_LENGTHS)
    got = cuda_ltu.ltu_counts(rows, valid, offsets, ws)
    assert torch.equal(got, cuda_ltu.ltu_counts_plain(rows, valid, offsets, ws))
    # one length for every row: the per-row kernel equals the scalar one
    for v in (0, 3, 4097, 65_536):
        same = torch.full((rows.shape[0],), v)
        assert torch.equal(cuda_ltu.ltu_counts(rows, same, offsets, ws),
                           cuda_ltu.ltu_counts(rows, v, offsets, ws))


def test_counts_rows_of_more_rows_than_grid_y(cuda):
    rng = np.random.default_rng(70001)
    rows = torch.from_numpy(rng.integers(0, 3, (70_000, 12), np.uint8)).to(cuda)
    valid = torch.from_numpy(rng.integers(0, 13, 70_000))
    ks = sorted(DEFAULT_OFFSETS)
    ws = [offset_weight(k) for k in ks]
    backend.reset_launch_counts()
    counts = cuda_ltu.ltu_counts(rows, valid, ks, ws)
    assert backend.LAUNCHES["dlt_ltu_counts_rows"] == 1
    assert torch.equal(counts, cuda_ltu.ltu_counts_plain(rows, valid, ks, ws))


@pytest.mark.parametrize("fmt", ["bc1", "bc2", "bc3", "bc4", "bc5"])
def test_batch_pipeline_on_the_card(cuda, fmt):
    """The batch processor and the batched load path on the card equal their plain
    versions on the CPU, with one launch of each kernel per batch."""
    from dxt_lossless_transform_tpu_torch.estimate.zstd import ZstdEstimation
    from dxt_lossless_transform_tpu_torch.parallel import (
        BatchProcessor, UntransformBatchProcessor,
    )
    from dxt_lossless_transform_tpu_torch.utils import testgen

    size = 8 if fmt in ("bc1", "bc4") else 16
    gen = {"bc1": testgen.bc1_realistic, "bc2": testgen.bc2_realistic,
           "bc3": testgen.bc3_realistic}.get(fmt)
    data = [gen(n, n) if gen else testgen.bc_blocks(n, size, n)
            for n in (64, 100, 2048, 2049, 5000, 70_001)] + [b""]
    proc = BatchProcessor(fmt, max_batch=2)
    backend.reset_launch_counts()
    got = proc.process(data)
    torch.cuda.synchronize()
    # buckets of 2048 blocks (3 files: 2 batches), 4096, 8192 and 131,072
    assert proc.batches == 5
    # BC1-BC3 score their region kernel's rows, BC4/BC5 rows cut from the words
    assert backend.LAUNCHES["dlt_deinterleave_words"] == \
        (proc.batches if fmt in ("bc4", "bc5") else 0)
    assert backend.LAUNCHES["dlt_ltu_counts_rows"] == proc.batches
    assert backend.LAUNCHES[f"dlt_{fmt}_transform_rows"] == proc.batches
    if fmt in ("bc1", "bc2", "bc3"):
        assert backend.LAUNCHES[f"dlt_{fmt}_regions"] == proc.batches
    want = BatchProcessor(fmt, max_batch=2, device="cpu").process(data)
    assert [(r.transformed, r.settings) for r in got] == \
        [(r.transformed, r.settings) for r in want]
    unproc = UntransformBatchProcessor(fmt, max_batch=2)
    backend.reset_launch_counts()
    assert unproc.process([(r.transformed, r.settings) for r in got]) == data
    torch.cuda.synchronize()
    assert backend.LAUNCHES[f"dlt_{fmt}_untransform"] == unproc.batches
    host = BatchProcessor(fmt, max_batch=2, estimator=ZstdEstimation(1))
    assert [(r.transformed, r.settings) for r in host.process(data)] == \
        [(r.transformed, r.settings) for r in BatchProcessor(
            fmt, max_batch=2, estimator=ZstdEstimation(1), device="cpu").process(data)]


@pytest.mark.parametrize("fmt", ["bc7", "bc6h", "rgba8888", "bgr888"])
def test_mode_sort_and_rgb_batches_on_the_card(cuda, fmt):
    from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
    from dxt_lossless_transform_tpu_torch.parallel import (
        ModeSortBatchProcessor, RgbBatchProcessor, UntransformBatchProcessor,
    )
    from dxt_lossless_transform_tpu_torch.utils import testgen

    if fmt in ("bc7", "bc6h"):
        data = [testgen.bc7_realistic(n, n) for n in (64, 2049, 5000)]
        data += [b"", testgen.bc_blocks(3001, 16, 3)]
        make = lambda device: ModeSortBatchProcessor(fmt, max_batch=2, device=device)  # noqa: E731
    else:
        data = [testgen.make_uncompressed_dds(fmt, w, h, seed=w)[0x80:]
                for w, h in ((33, 7), (256, 128), (640, 480))] + [b""]
        make = lambda device: RgbBatchProcessor(fmt, LtuEstimation(), max_batch=2,  # noqa: E731
                                                device=device)
    proc = make("cuda")
    backend.reset_launch_counts()
    got = proc.process(data)
    torch.cuda.synchronize()
    assert backend.LAUNCHES["dlt_ltu_counts_rows"] == proc.batches
    assert [(r.transformed, r.settings) for r in got] == \
        [(r.transformed, r.settings) for r in make("cpu").process(data)]
    assert UntransformBatchProcessor(fmt).process(
        [(r.transformed, r.settings) for r in got]) == data


# the windowed count's ladders: the default, offsets up to its SPAN-byte halo
# (beyond the 4096 bytes staged in shared memory), 40 offsets, and the generic
# kernel's ladder within 4096
WINDOW_LADDERS = {"default": tuple(sorted(DEFAULT_OFFSETS)),
                  "far": (1, 2, 4096, 4097, 8192, cuda_ltu.SPAN),
                  "ladder40": LADDER_40[:-1] + (cuda_ltu.SPAN,),
                  "near": NEAR_LADDER}


@pytest.mark.parametrize("ladder", list(WINDOW_LADDERS))
@pytest.mark.parametrize("nb,chunk", [(1, 70_001), (2, 40_000), (8, 1024), (8, 9_999)])
def test_windowed_counts_kernel(cuda, nb, chunk, ladder):
    """Each shard's window on the card against the plain version, and the shards'
    sum against the per-row kernel on the uncut rows; chunks shorter and longer than
    the halo, ragged valid lengths (0-3 among them)."""
    span = cuda_ltu.SPAN
    offsets = WINDOW_LADDERS[ladder]
    ws = [offset_weight(k) for k in offsets]
    length = nb * chunk
    rng = np.random.default_rng(nb * chunk)
    rows = torch.from_numpy(rng.integers(0, 3, (6, length), np.uint8)).to(cuda)
    valid = torch.tensor([length, length - 77, 0, 3, 5, length // 2])
    padded = torch.nn.functional.pad(rows, (span, span))
    backend.reset_launch_counts()
    total = torch.zeros(rows.shape[0], dtype=torch.int64, device=cuda)
    for s in range(nb):
        window = padded[:, s * chunk:(s + 1) * chunk + 2 * span].contiguous()
        got = cuda_ltu.ltu_counts_windowed(window, valid, s * chunk - span, offsets, ws)
        want = cuda_ltu.ltu_counts_windowed_plain(window, valid, s * chunk - span,
                                                  offsets, ws)
        assert torch.equal(got, want), s
        total += got
    assert backend.LAUNCHES["dlt_ltu_counts_windowed"] == nb
    assert torch.equal(total, cuda_ltu.ltu_counts(rows, valid, offsets, ws))


@pytest.mark.parametrize("fmt", ["bc1", "bc2", "bc3", "bc4", "bc5"])
def test_batch_pipeline_under_a_mesh_on_the_card(cuda, fmt):
    """``BatchProcessor`` under a (1, 8) and a (3, 2) mesh of the card repeated, in
    both modes, equals the processor on one device; the LTU path launches the
    windowed count kernel and not the per-row one."""
    from dxt_lossless_transform_tpu_torch.estimate.zstd import ZstdEstimation
    from dxt_lossless_transform_tpu_torch.parallel import BatchProcessor, make_mesh
    from dxt_lossless_transform_tpu_torch.utils import testgen

    size = 8 if fmt in ("bc1", "bc4") else 16
    gen = {"bc1": testgen.bc1_realistic, "bc2": testgen.bc2_realistic,
           "bc3": testgen.bc3_realistic}.get(fmt)
    data = [gen(n, n) if gen else testgen.bc_blocks(n, size, n)
            for n in (64, 100, 2048, 2049, 5000, 70_001)] + [b""]
    want = [(r.transformed, r.settings) for r in BatchProcessor(fmt, max_batch=2).process(data)]
    for n_devices in (8, 6):
        mesh = make_mesh(devices=[cuda] * n_devices)
        backend.reset_launch_counts()
        got = BatchProcessor(fmt, mesh=mesh, max_batch=2).process(data)
        torch.cuda.synchronize()
        assert backend.LAUNCHES["dlt_ltu_counts_windowed"] > 0
        assert backend.LAUNCHES["dlt_ltu_counts_rows"] == 0
        assert [(r.transformed, r.settings) for r in got] == want
        host = BatchProcessor(fmt, mesh=mesh, max_batch=2, estimator=ZstdEstimation(1))
        assert [(r.transformed, r.settings) for r in host.process(data)] == \
            [(r.transformed, r.settings) for r in BatchProcessor(
                fmt, max_batch=2, estimator=ZstdEstimation(1)).process(data)]


def test_mode_sort_and_untransform_steps_under_a_mesh_on_the_card(cuda):
    from dxt_lossless_transform_tpu_torch.parallel import (
        make_mesh, modesort_transform_step, untransform_step,
    )
    from dxt_lossless_transform_tpu_torch.utils import testgen

    n = 4096 * 8
    words = torch.stack([torch.frombuffer(bytearray(testgen.bc7_realistic(n, b)),
                                          dtype=torch.int32) for b in range(3)])
    valid = [n, n - 5001, 3]
    cpu_mesh = make_mesh(devices=[torch.device("cpu")] * 8)
    mesh = make_mesh(devices=[cuda] * 8)
    for fmt in ("bc7", "bc6h"):
        got = modesort_transform_step(mesh, fmt)(words.to(cuda), valid)
        want = modesort_transform_step(cpu_mesh, fmt)(words, valid)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    s = Bc3TransformSettings(YCoCgVariant.VARIANT1, True, True)
    payloads = [_blocks(2049 + b, "cpu", 16) for b in range(6)]
    streams = []
    transformed = [shuffle.bc3_transform(p[:16 * 2049], 1, True, True) for p in payloads]
    pos = 0
    for bpb in (1, 1, 6, 2, 2, 4):
        streams.append(torch.stack([t[pos * 2049:(pos + bpb) * 2049] for t in transformed]))
        pos += bpb
    mesh = make_mesh(devices=[cuda] * 6)
    out = untransform_step(mesh, "bc3", s)(*[st.to(cuda) for st in streams])
    assert torch.equal(out.cpu().view(torch.uint8),
                       torch.stack([p[:16 * 2049] for p in payloads]))


# ---- the default-ladder count kernel and the tiled untransform -----------------------

DEFAULT_KS = tuple(sorted(DEFAULT_OFFSETS))
DEFAULT_WS = tuple(offset_weight(k) for k in DEFAULT_KS)


def _count_rows(kind, c, length, seed):
    """Rows whose grams match at every distance (zeros), often (two byte values, or
    a short period with a few flips) or seldom (random bytes)."""
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros((c, length), np.uint8)
    if kind == "binary":
        return rng.integers(0, 2, (c, length), np.uint8)
    if kind == "random":
        return rng.integers(0, 256, (c, length), np.uint8)
    rows = np.empty((c, length), np.uint8)
    for r in range(c):
        rows[r] = np.resize(rng.integers(0, 4, int(rng.integers(1, 300)), np.uint8), length)
        rows[r, rng.integers(0, length, length // 50)] ^= 1
    return rows


@pytest.mark.parametrize("kind", ["zeros", "binary", "periodic", "random"])
@pytest.mark.parametrize("length", [5, 6, 7, 8, 33, 4098, 4099, 4100, 4101, 8195, 20001,
                                    20002, 20003, 20004, 70003])
def test_default_counts_kernel(cuda, length, kind):
    """The default ladder at row lengths of every residue mod 4, from 5 bytes (one
    position) to several tiles, rows shorter than the largest offset among them (the
    wrapper passes the whole ladder, the kernel's stream-head guard zeroes the offsets
    a row does not reach): one length for all rows, and ragged per-row lengths (0-3
    among them)."""
    rows = torch.from_numpy(_count_rows(kind, 5, length, length)).to(cuda)
    for valid in sorted({length, max(length - 1, 0), max(length - 6, 0)}):
        assert torch.equal(cuda_ltu.ltu_counts(rows, valid, DEFAULT_KS, DEFAULT_WS),
                           cuda_ltu.ltu_counts_plain(rows, valid, DEFAULT_KS, DEFAULT_WS))
    ragged = torch.tensor([length, length // 2, 3, 0, max(length - 5, 0)])
    assert torch.equal(cuda_ltu.ltu_counts(rows, ragged, DEFAULT_KS, DEFAULT_WS),
                       cuda_ltu.ltu_counts_plain(rows, ragged, DEFAULT_KS, DEFAULT_WS))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("length", [4097, 10003, 65538])
def test_default_counts_of_unaligned_rows(cuda, offset, length):
    """Rows that start at every byte alignment: a tensor at an odd offset into its
    storage, and rows whose length is no multiple of 4."""
    flat = torch.from_numpy(_count_rows("periodic", 1, 3 * length + offset, length)
                            .reshape(-1)).to(cuda)
    rows = flat[offset:].view(3, length)
    assert torch.equal(cuda_ltu.ltu_counts(rows, length, DEFAULT_KS, DEFAULT_WS),
                       cuda_ltu.ltu_counts_plain(rows, length, DEFAULT_KS, DEFAULT_WS))


@pytest.mark.parametrize("kind", ["zeros", "periodic"])
@pytest.mark.parametrize("nb,length", [(1, 40_000), (8, 8 * 1024), (6, 9_000),
                                       (3, 70_001), (8, 262_147)])
def test_default_windowed_counts_kernel(cuda, nb, length, kind):
    """The default ladder's windows, shard 0 with a negative pos0, chunks shorter and
    longer than the 32 KiB halo: each against its plain version, and the shards' sum
    against the uncut rows."""
    span = cuda_ltu.SPAN
    rows = torch.from_numpy(_count_rows(kind, 4, length, nb * length)).to(cuda)
    valid = torch.tensor([length, length - 777, 3, length // 3])
    chunk = -(-length // nb)
    padded = torch.nn.functional.pad(rows, (span, span + nb * chunk - length))
    total = torch.zeros(rows.shape[0], dtype=torch.int64, device=cuda)
    for s in range(nb):
        window = padded[:, s * chunk:(s + 1) * chunk + 2 * span].contiguous()
        got = cuda_ltu.ltu_counts_windowed(window, valid, s * chunk - span, DEFAULT_KS,
                                           DEFAULT_WS)
        assert torch.equal(got, cuda_ltu.ltu_counts_windowed_plain(
            window, valid, s * chunk - span, DEFAULT_KS, DEFAULT_WS)), s
        total += got
    assert torch.equal(total, cuda_ltu.ltu_counts(rows, valid, DEFAULT_KS, DEFAULT_WS))


@pytest.mark.parametrize("n", [1, 5, 19])
def test_default_prefix_counts_its_own_rungs(cuda, n):
    """A prefix of the default ladder on 70,000-byte rows, beyond the whole ladder's
    reach, counts with its own rungs only (it takes the generic kernel's table), in
    all three forms: one length, per-row lengths and the windows of 2 shards."""
    span, ks, ws = cuda_ltu.SPAN, DEFAULT_KS[:n], DEFAULT_WS[:n]
    rows = torch.from_numpy(_count_rows("periodic", 4, 70_000, n)).to(cuda)
    want = cuda_ltu.ltu_counts_plain(rows, 70_000, ks, ws)
    # the rows tell the prefix from the whole ladder
    assert not torch.equal(want, cuda_ltu.ltu_counts_plain(rows, 70_000, DEFAULT_KS,
                                                           DEFAULT_WS))
    assert torch.equal(cuda_ltu.ltu_counts(rows, 70_000, ks, ws), want)
    valid = torch.tensor([70_000, 69_999, 5_000, 4_101])
    want = cuda_ltu.ltu_counts_plain(rows, valid, ks, ws)
    assert torch.equal(cuda_ltu.ltu_counts(rows, valid, ks, ws), want)
    padded = torch.nn.functional.pad(rows, (span, span))
    total = torch.zeros(rows.shape[0], dtype=torch.int64, device=cuda)
    for s in range(2):
        window = padded[:, s * 35_000:(s + 1) * 35_000 + 2 * span].contiguous()
        got = cuda_ltu.ltu_counts_windowed(window, valid, s * 35_000 - span, ks, ws)
        assert torch.equal(got, cuda_ltu.ltu_counts_windowed_plain(
            window, valid, s * 35_000 - span, ks, ws)), s
        total += got
    assert torch.equal(total, want)


@pytest.mark.parametrize("shards", [1, 8, 6])
def test_default_counts_launch_shape(cuda, shards):
    """The windowed launches of the BC1 batch's 16 rows of 2,097,152 bytes cut into
    1, 8 and 6 shards cover the blocks the card holds at once: the full 8192-position
    tile where it does, else a tile of whole passes of 1024 positions (a word of four
    a thread) no shorter than it must be; the uncut rows keep the full tile."""
    chunk = -(-2_097_152 // shards)
    shape = cuda_ltu.launch_shape(16, chunk, "windowed", cuda)
    tile, resident = shape["tile"], shape["resident"]
    assert resident > 0
    assert tile % 1024 == 0 and 1024 <= tile <= 8192
    if -(-chunk // 8192) * 16 >= resident:
        assert tile == 8192
    else:
        assert chunk * 16 / resident < tile + 1024
    assert shape["grid"] == [-(-chunk // tile), 16]
    assert shape["blocks"] >= resident
    rows = cuda_ltu.launch_shape(16, 2_097_149, "rows", cuda)
    assert rows["tile"] == 8192 and rows["blocks"] >= rows["resident"]
    assert cuda_ltu.launch_shape(70_000, 9, "scalar", cuda)["grid"] == [1, 65_535]


@pytest.mark.parametrize("ks", [DEFAULT_OFFSETS, NEAR_LADDER, FAR_OFFSETS],
                         ids=["default", "near", "far"])
def test_counts_of_lengths_on_the_card(cuda, ks):
    """Lengths copied to the card once, with the longest from the host, as a mesh
    step passes them: the per-row and the windowed kernels count as with lengths on
    the host."""
    ks = tuple(sorted(ks))
    ws = [offset_weight(k) for k in ks]
    rows = torch.from_numpy(_count_rows("periodic", 6, 90_001, 6)).to(cuda)
    host = torch.tensor([90_001, 77_777, 4_100, 5, 0, 65_537])
    on_card = cuda_ltu.device_lengths(host, cuda)
    assert on_card.longest == 90_001 and on_card.lengths.device == rows.device
    assert torch.equal(cuda_ltu.ltu_counts(rows, on_card, ks, ws),
                       cuda_ltu.ltu_counts_plain(rows, host, ks, ws))
    assert torch.equal(cuda_ltu.ltu_counts(rows[2:5], on_card.slice(2, 5), ks, ws),
                       cuda_ltu.ltu_counts_plain(rows[2:5], host[2:5], ks, ws))
    if ks[-1] <= cuda_ltu.SPAN:
        window = torch.nn.functional.pad(rows, (cuda_ltu.SPAN, cuda_ltu.SPAN))
        assert torch.equal(
            cuda_ltu.ltu_counts_windowed(window, on_card, -cuda_ltu.SPAN, ks, ws),
            cuda_ltu.ltu_counts_windowed_plain(window, host, -cuda_ltu.SPAN, ks, ws))
    with pytest.raises(ValueError):
        cuda_ltu.ltu_counts(rows, on_card.lengths, ks, ws)


UNTRANSFORM_SIZES = [1, 2, 3, 5, 1023, 1024, 1025, 4095, 4096, 4097, 8191, 8193, 12_289,
                     65_537]


@pytest.mark.parametrize("offset", [0, 4, 8, 12])
@pytest.mark.parametrize("n", UNTRANSFORM_SIZES)
@pytest.mark.parametrize("planes_", [True, False], ids=["planes", "blocks"])
@pytest.mark.parametrize("sort", [True, False], ids=["sort", "nosort"])
@pytest.mark.parametrize("fmt", [planes.BC7, planes.BC6H], ids=["bc7", "bc6h"])
def test_bc7_untransform_kernel(cuda, fmt, sort, planes_, n, offset):
    """Every setting of both formats, n from 1 to past multiples of 4096 (odd ones:
    the planes at m + p*n take every alignment mod 16), the transformed bytes at 4-byte
    offsets into a larger tensor, against the plain version."""
    x = _bc7_blocks(n, cuda, "random" if fmt == planes.BC7 else "realistic")
    t = planes.bc7_transform_plain(x, fmt, sort, planes_)
    buf = torch.zeros(t.numel() + 16, dtype=torch.uint8, device=cuda)
    buf[offset:offset + t.numel()] = t
    u = planes.bc7_untransform(buf[offset:offset + t.numel()], n, sort, planes_)
    assert torch.equal(u, planes.bc7_untransform_plain(t, n, sort, planes_))
    assert torch.equal(u, x)


@pytest.mark.parametrize("planes_", [True, False], ids=["planes", "blocks"])
@pytest.mark.parametrize("sort", [True, False], ids=["sort", "nosort"])
def test_bc7_untransform_launch_shape(cuda, sort, planes_):
    """A thread block per 1024-block tile, or with sorting per 4096-block chunk; the
    sorted forms' chunks of the 4096x4096 file fit in one wave."""
    n = 1_398_103
    shape = planes.untransform_launch_shape(n, sort, planes_, cuda)
    assert shape["span"] == (4096 if sort else 1024)
    assert shape["grid"] == -(-n // shape["span"])
    assert shape["threads"] == 256
    if sort:
        assert shape["resident"] >= shape["grid"]


# the decoders, normalization and its search, and the endian harness on the card,
# against the same code on the CPU

@pytest.mark.parametrize("fmt", ["bc1", "bc2", "bc3"])
def test_decode_and_normalize_on_the_card_match_the_cpu(cuda, fmt):
    from dxt_lossless_transform_tpu_torch.ops import decode, normalize

    bs = 8 if fmt == "bc1" else 16
    rng = np.random.default_rng(11)
    words = rng.integers(0, 2**32, (4099, bs // 4), dtype=np.uint64).astype(np.uint32)
    words[::3, bs // 4 - 1] = 0  # solid blocks where both endpoints decode alike
    words[::3, bs // 4 - 2] = (words[::3, bs // 4 - 2] & 0xFFFF) * 0x10001
    data = words.tobytes()
    dec = getattr(decode, f"decode_{fmt}_bytes")
    assert torch.equal(dec(data, device=cuda).cpu(), dec(data, device="cpu"))
    grid = ([(a, c) for a in normalize.AM for c in normalize.CM] if fmt == "bc3"
            else [(c,) for c in normalize.CM])
    blocks = getattr(normalize, f"normalize_blocks_{fmt}")
    for modes in grid:
        assert blocks(data, *modes, device=cuda) == blocks(data, *modes, device="cpu")
    search = getattr(normalize, f"transform_{fmt}_auto_with_normalization")
    from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation

    got = search(data, LtuEstimation(), True, device=cuda)
    want = search(data, LtuEstimation(), True, device="cpu")
    assert got[0] == want[0] and got[1:] == want[1:]


def test_endian_matrix_on_the_card(cuda):
    from dxt_lossless_transform_tpu_torch.utils.endian_harness import run_matrix

    backend.reset_launch_counts()
    report = run_matrix(n_blocks=300, device=cuda)
    assert len(report.per_format) == 10 and report.containers == 3
    assert report.batches == 5
    for name in ("dlt_bc1_transform", "dlt_bc3_untransform", "dlt_bc7_transform",
                 "dlt_rgb_untransform", "dlt_deinterleave_words", "dlt_ltu_counts_rows"):
        assert backend.LAUNCHES[name] > 0, name


@pytest.mark.parametrize("level", [1, 6])
def test_host_scores_of_card_rows_are_the_cpu_rows_scores(cuda, level):
    """The default host scoring copies every part's card rows into one pinned buffer
    and reads each row's real bytes there: the scores of the same rows on the CPU."""
    from dxt_lossless_transform_tpu_torch.estimate.zstd import ZstdEstimation

    est = ZstdEstimation(level)
    x = _blocks(5000, "cpu", 16)
    alpha, colour = regions.bc3_regions(x, (False, True), ((0, False), (1, True)))
    valid = torch.tensor([4000, 10000])
    want = est.estimate_parts_device([(alpha, valid), (colour, 20000)])
    got = est.estimate_parts_device([(alpha.to(cuda), valid.to(cuda)),
                                     (colour.to(cuda), 20000)])
    assert all(g.device == cuda for g in got)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert est.estimate_batch_device(colour.to(cuda), 20000).tolist() == want[1].tolist()

"""The port's BC7 and BC6H mode-sort transforms (plain versions, ``device="cpu"``)
against the JAX package: its numpy oracles, its XLA device path and its Pallas
kernels in interpret mode. Bytes must be equal."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu.ops import bc6h as jax_bc6h, bc7 as jax_bc7
from dxt_lossless_transform_tpu.oracle import bc6h as oracle_bc6h, bc7 as oracle_bc7
from dxt_lossless_transform_tpu.settings import (
    Bc6hTransformSettings as Jax6h, Bc7TransformSettings as Jax7,
)
from dxt_lossless_transform_tpu.utils import testgen as jax_testgen
from dxt_lossless_transform_tpu_torch import convert, errors
from dxt_lossless_transform_tpu_torch.ops import bc6h, bc7
from dxt_lossless_transform_tpu_torch.ops.cuda import planes
from dxt_lossless_transform_tpu_torch.settings import (
    BC6H_FAST_CANDIDATES, BC7_COMPREHENSIVE_CANDIDATES, BC7_FAST_CANDIDATES,
    Bc6hTransformSettings, Bc7TransformSettings,
)
from dxt_lossless_transform_tpu_torch.utils import testgen

SIZES = [1, 2, 3, 4095, 4096, 4097, 8197]
SETTINGS = list(Bc7TransformSettings.all_combinations())
# format -> (port module, JAX oracle, JAX ops module, port settings, JAX settings)
FORMATS = {"BC7": (bc7, oracle_bc7, jax_bc7, Bc7TransformSettings, Jax7),
           "BC6H": (bc6h, oracle_bc6h, jax_bc6h, Bc6hTransformSettings, Jax6h)}


def _data(n: int, kind: str) -> bytes:
    """Realistic BC7 blocks, or uniform random ones with byte 0 forced to 0 (BC7's
    invalid id 8) in about one block in eight."""
    if kind == "realistic":
        return jax_testgen.bc7_realistic(n, n)
    blocks = np.random.default_rng(n).integers(0, 256, (n, 16), np.uint8)
    blocks[np.random.default_rng(n + 1).random(n) < 0.125, 0] = 0
    return blocks.tobytes()


def _settings(fmt: str, s: Bc7TransformSettings):
    return FORMATS[fmt][3](s.sort_by_mode, s.split_byte_planes)


@pytest.mark.parametrize("kind", ["realistic", "random"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("s", SETTINGS, ids=str)
@pytest.mark.parametrize("fmt", FORMATS)
def test_transform_matches_the_oracle(fmt, s, n, kind):
    port, oracle, _, _, jax_cls = FORMATS[fmt]
    data = _data(n, kind)
    settings = _settings(fmt, s)
    out = port.transform(data, settings, device="cpu")
    assert out == oracle.transform(data, jax_cls(s.sort_by_mode, s.split_byte_planes))
    assert len(out) == bc7.transformed_len(len(data), settings)
    assert port.untransform(out, settings, device="cpu") == data


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("s", SETTINGS, ids=str)
@pytest.mark.parametrize("fmt", FORMATS)
def test_transform_matches_the_jax_device_path(fmt, s, n, monkeypatch):
    """The JAX package's XLA path, with its padded buckets (every payload goes to the
    device with ``DLT_DEVICE_MIN_BYTES=0``)."""
    monkeypatch.setenv("DLT_DEVICE_MIN_BYTES", "0")
    port, _, jax_ops, _, jax_cls = FORMATS[fmt]
    data = _data(n, "random")
    jax_settings = jax_cls(s.sort_by_mode, s.split_byte_planes)
    out = jax_ops.transform(data, jax_settings)
    assert port.transform(data, _settings(fmt, s), device="cpu") == out
    assert port.untransform(out, _settings(fmt, s), device="cpu") == \
        jax_ops.untransform(out, jax_settings) == data


# the chunks that stress the counting sort (testgen.mode_sort_edges) at sizes about
# one and two chunks, and at one chunk per id with a one-block ragged last chunk
EDGE_SIZES = [4095, 4096, 4097, 8191, 8193, "chunk_per_id"]


@pytest.mark.parametrize("n", EDGE_SIZES, ids=str)
@pytest.mark.parametrize("pattern", testgen.MODE_SORT_EDGES)
@pytest.mark.parametrize("s", SETTINGS, ids=str)
@pytest.mark.parametrize("fmt", FORMATS)
def test_edge_chunks_match_the_oracle(fmt, s, pattern, n):
    port, oracle, _, _, jax_cls = FORMATS[fmt]
    if n == "chunk_per_id":
        n = len(testgen.MODE_BYTE0[fmt]) * planes.SORT_CHUNK_BLOCKS + 1
    data = testgen.mode_sort_edges(fmt, n, pattern, seed=n)
    settings = _settings(fmt, s)
    out = port.transform(data, settings, device="cpu")
    assert out == oracle.transform(data, jax_cls(s.sort_by_mode, s.split_byte_planes))
    assert port.untransform(out, settings, device="cpu") == data


@pytest.mark.parametrize("fmt", FORMATS)
def test_edge_chunks_hold_the_ids_they_name(fmt):
    """Byte 0 of testgen.MODE_BYTE0[fmt][k] is id k by the oracle's table, so the
    patterns hold every id, BC7's invalid 8 included."""
    table = {"BC7": oracle_bc7._CTZ8, "BC6H": oracle_bc6h.MODE_LUT}[fmt]
    byte0 = testgen.MODE_BYTE0[fmt]
    assert [int(table[b]) for b in byte0] == list(range(len(byte0)))
    data = np.frombuffer(testgen.mode_sort_edges(fmt, 3 * 4096 + 5, "every_id"), np.uint8)
    assert set(table[data[0::16]].tolist()) == set(range(len(byte0)))


def test_host_helpers_match_the_oracle():
    assert np.array_equal(bc7.MODE_TABLES[bc7.BC7], oracle_bc7._CTZ8)
    assert np.array_equal(bc7.MODE_TABLES[bc7.BC6H], oracle_bc6h.MODE_LUT)
    assert bc7.SORT_CHUNK_BLOCKS == oracle_bc7.SORT_CHUNK_BLOCKS
    for n in (0, 1, 2, 7, 4097):
        modes = np.random.default_rng(n).integers(0, 16, n, np.uint8)
        stream = bc7.pack_mode_stream(torch.from_numpy(modes))
        assert stream.numpy().tobytes() == oracle_bc7.pack_mode_stream(modes)
        assert bc7.mode_stream_len(n) == oracle_bc7.mode_stream_len(n) == stream.numel()
        assert np.array_equal(bc7.unpack_mode_stream(stream, n).numpy(),
                              oracle_bc7.unpack_mode_stream(stream.numpy().tobytes(), n))
        assert np.array_equal(planes.sort_order(torch.from_numpy(modes)).numpy(),
                              oracle_bc7.sort_order(modes))
    for length in range(0, 200):
        for s in SETTINGS:
            jax_s = Jax7(s.sort_by_mode, s.split_byte_planes)
            if length % 16 == 0:
                assert bc7.transformed_len(length, s) == \
                    oracle_bc7.transformed_len(length, jax_s)
            try:
                want = oracle_bc7.original_len(length, jax_s)
            except ValueError:
                with pytest.raises(ValueError):
                    bc7.original_len(length, s)
            else:
                assert bc7.original_len(length, s) == want


@pytest.mark.parametrize("fmt", FORMATS)
def test_lengths_that_fit_no_block_count_raise(fmt):
    port, _, _, cls, _ = FORMATS[fmt]
    error = errors.Bc7ValidationError if fmt == "BC7" else errors.Bc6hValidationError
    with pytest.raises(error):
        port.transform(bytes(17), cls(), device="cpu")
    with pytest.raises(error):
        port.untransform(bytes(18), cls(True, True), device="cpu")  # 16n + ceil(n/2)
    with pytest.raises(error):
        port.untransform(bytes(20), cls(False, True), device="cpu")
    assert port.transform(b"", cls(), device="cpu") == b""
    assert port.untransform(b"", cls(), device="cpu") == b""


def test_identity_returns_the_payload_without_a_launch():
    data = _data(100, "random")
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    identity = Bc7TransformSettings(False, False)
    assert bc7.transform_tensor(x, identity) is x
    assert bc7.untransform_tensor(x, identity) is x
    assert bc7.transform(data, identity, device="cpu") == data


@pytest.mark.parametrize("fmt", [planes.BC7, planes.BC6H])
def test_out_argument_takes_any_row(fmt):
    """The transform writes into a row of a larger tensor, as the auto-search does."""
    n = 37
    x = torch.from_numpy(np.frombuffer(_data(n, "random"), np.uint8).copy())
    rows = torch.zeros((3, planes.transformed_len(n, True)), dtype=torch.uint8)
    got = planes.bc7_transform(x, fmt, True, True, out=rows[1])
    assert got.data_ptr() == rows[1].data_ptr()
    assert torch.equal(rows[1], planes.bc7_transform_plain(x, fmt, True, True))
    assert not rows[0].any() and not rows[2].any()
    with pytest.raises(ValueError):
        planes.bc7_transform(x, fmt, True, True, out=rows[1][1:])
    with pytest.raises(ValueError):
        planes.bc7_transform(x, 2, True, True)


# ---- the Pallas kernels of rows 12-15, in interpret mode -------------------------------

PALLAS_N = 65536  # one (MAX_ROWS, W_IN) tile of the plane kernels


def _pallas_data():
    return _data(PALLAS_N, "random")


@pytest.mark.parametrize("fmt", ["bc7", "bc6h"])
def test_split_cols_modes_kernel_matches_the_port(fmt):
    """Row 12: the fused forward kernel's sort keys and packed mode stream against
    the port's mode ids, chunk order and stream."""
    from dxt_lossless_transform_tpu.ops.pallas.planes import split_cols_modes_tpu

    data = _pallas_data()
    flat = jnp.asarray(np.frombuffer(data, "<u4"))
    cols, keys, packed = split_cols_modes_tpu(flat, fmt, bc7.SORT_CHUNK_BLOCKS,
                                              interpret=True)
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    modes = planes.mode_ids(x, planes.BC7 if fmt == "bc7" else planes.BC6H)
    c = bc7.SORT_CHUNK_BLOCKS
    idx = np.arange(PALLAS_N)
    assert np.array_equal(np.asarray(keys), modes.numpy().astype(np.int64) * c + idx % c)
    assert np.asarray(packed).astype("<u4").tobytes() == \
        bc7.pack_mode_stream(modes).numpy().tobytes()
    # the keys' chunk-local order is the port's sort order
    order = np.argsort(np.asarray(keys).reshape(-1, c), axis=1) + (idx[::c])[:, None]
    assert np.array_equal(order.reshape(-1), planes.sort_order(modes).numpy())
    for w in range(4):
        assert np.array_equal(np.asarray(cols[w]), np.frombuffer(data, "<u4")[w::4])


def test_sorted_plane_and_weave_kernels_match_the_port():
    """Rows 13 and 15: the sorted columns through ``split_planes_tpu`` and
    ``weave_cols_tpu`` give the port's sort+planes and sort-only payloads; rows 14
    and 15 back: ``merge_planes_tpu`` and ``split_cols_tpu`` give the sorted
    columns again."""
    from dxt_lossless_transform_tpu.ops.pallas.planes import (
        merge_planes_tpu, split_cols_tpu, split_planes_tpu, weave_cols_tpu,
    )

    data = _pallas_data()
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    order = planes.sort_order(planes.mode_ids(x, planes.BC7)).numpy()
    words = np.frombuffer(data, "<u4").reshape(-1, 4)[order]
    cols = tuple(jnp.asarray(np.ascontiguousarray(words[:, w])) for w in range(4))
    msl = bc7.mode_stream_len(PALLAS_N)
    sort_planes = planes.bc7_transform(x, planes.BC7, True, True)[msl:].numpy()
    got = split_planes_tpu(cols, interpret=True)
    assert b"".join(np.asarray(p).astype("<u4").tobytes() for p in got) == \
        sort_planes.tobytes()
    sort_only = planes.bc7_transform(x, planes.BC7, True, False)[msl:].numpy()
    woven = weave_cols_tpu(cols, interpret=True)
    assert np.asarray(woven).astype("<u4").tobytes() == sort_only.tobytes()
    back = merge_planes_tpu(tuple(got), interpret=True)
    for w in range(4):
        assert np.array_equal(np.asarray(back[w]), words[:, w])
    split = split_cols_tpu(woven, interpret=True)
    for w in range(4):
        assert np.array_equal(np.asarray(split[w]), words[:, w])


def test_flat_plane_kernels_match_the_port():
    """Rows 13 and 14 without sorting: ``split_planes_flat_tpu`` gives the port's
    planes-only payload and ``merge_planes_flat_tpu`` the port's untransform."""
    from dxt_lossless_transform_tpu.ops.pallas.planes import (
        merge_planes_flat_tpu, split_planes_flat_tpu,
    )

    data = _pallas_data()
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    got = split_planes_flat_tpu(jnp.asarray(np.frombuffer(data, "<u4")), interpret=True)
    port = planes.bc7_transform(x, planes.BC7, False, True)
    assert b"".join(np.asarray(p).astype("<u4").tobytes() for p in got) == \
        port.numpy().tobytes()
    back = merge_planes_flat_tpu(tuple(got), interpret=True)
    assert np.asarray(back).astype("<u4").tobytes() == \
        planes.bc7_untransform(port, PALLAS_N, False, True).numpy().tobytes() == data


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_testgen_bytes_match_jax(seed):
    assert testgen.bc7_realistic(999, seed) == jax_testgen.bc7_realistic(999, seed)
    for fmt in ("BC7", "BC6H"):
        assert testgen.make_dx10_dds(fmt, 36, 20, 3, seed=seed) == \
            jax_testgen.make_dx10_dds(fmt, 36, 20, 3, seed=seed)
    payload = jax_testgen.bc_blocks(45 + 15 + 6 + 1, 16, seed)  # 9x5, 5x3, 3x2, 1x1
    assert testgen.make_dx10_dds("BC6H", 36, 20, 4, payload=payload) == \
        jax_testgen.make_dx10_dds("BC6H", 36, 20, 4, payload=payload)


def test_convert_bc7_bc6h_settings_both_ways():
    from dxt_lossless_transform_tpu import settings as jax_settings

    for jax_cls, port_cls in ((Jax7, Bc7TransformSettings),
                              (Jax6h, Bc6hTransformSettings)):
        assert [convert.from_reference(s) for s in jax_cls.all_combinations()] == \
            list(port_cls.all_combinations())
        for s in port_cls.all_combinations():
            back = convert.to_reference(s, jax_settings)
            assert type(back) is jax_cls and convert.from_reference(back) == s
    assert convert.from_reference(jax_settings.BC7_FAST_CANDIDATES) == \
        BC7_FAST_CANDIDATES
    assert convert.from_reference(jax_settings.BC7_COMPREHENSIVE_CANDIDATES) == \
        BC7_COMPREHENSIVE_CANDIDATES
    assert convert.from_reference(jax_settings.BC6H_FAST_CANDIDATES) == \
        BC6H_FAST_CANDIDATES


@pytest.mark.parametrize("s", list(itertools.product([True, False], repeat=2)))
def test_convert_other_settings_back(s):
    """:func:`convert.to_reference` on the earlier formats' settings, enums included."""
    from dxt_lossless_transform_tpu import settings as jax_settings
    from dxt_lossless_transform_tpu_torch import settings as port_settings

    for port in (port_settings.Bc3TransformSettings(
                     port_settings.YCoCgVariant.VARIANT2, *s),
                 port_settings.Bc1TransformSettings(port_settings.YCoCgVariant.NONE, s[0]),
                 port_settings.Bc4TransformSettings(s[1])):
        back = convert.to_reference(port, jax_settings)
        assert type(back).__module__ == jax_settings.__name__
        assert convert.from_reference(back) == port

"""The port's multi-device layer on CPU meshes (``parallel/mesh.py``,
``parallel/sharded.py`` under a mesh; the kernels' plain versions) against the JAX
package: ``make_mesh`` shapes; the sharded BC1-BC5 steps under ``(1, 8)``, ``(1, 4)``
and ``(3, 2)`` meshes of CPU devices against JAX's single-file steps, file by file,
with ragged valid lengths and chunks shorter and longer than the scorer's SPAN-byte
halo; BC1 against JAX's own mesh step under its ``make_mesh(8)``; the zstd-scored
step against its single-device self; the mode-sort and untransform steps against
JAX's under ``make_mesh(8)``. ``BatchProcessor`` under a mesh is in
``test_torch_mesh_pipeline.py``. Inputs come from numpy seeds; every comparison is
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu.estimate.pallas_ltu import SPAN
from dxt_lossless_transform_tpu.ops import bc45 as jax_bc45, hostwrap
from dxt_lossless_transform_tpu.oracle import bc1 as obc1, bc2 as obc2, bc3 as obc3
from dxt_lossless_transform_tpu.oracle import bc4 as obc45
from dxt_lossless_transform_tpu.parallel import make_mesh as jax_make_mesh
from dxt_lossless_transform_tpu.parallel import sharded as jax_sharded
from dxt_lossless_transform_tpu.settings import (
    Bc1TransformSettings, Bc2TransformSettings, Bc3TransformSettings,
    Bc4TransformSettings, Bc5TransformSettings, YCoCgVariant,
)
from dxt_lossless_transform_tpu.utils import testgen
from dxt_lossless_transform_tpu_torch import backend, convert
from dxt_lossless_transform_tpu_torch.errors import DeviceUnavailableError
from dxt_lossless_transform_tpu_torch.estimate.zstd import ZstdEstimation
from dxt_lossless_transform_tpu_torch.parallel import (
    Mesh, make_mesh, modesort_transform_step, sharded, untransform_step,
)

from jax_batch_bytes import jax_bytes

CPU = torch.device("cpu")
WORDS = {"bc1": 2, "bc2": 4, "bc3": 4, "bc4": 2, "bc5": 4}
BLOCK_SIZE = {"bc1": 8, "bc2": 16, "bc3": 16, "bc4": 8, "bc5": 16}
MESHES = {"1x8": 8, "1x4": 4, "3x2": 6}


def _mesh(name: str) -> Mesh:
    return make_mesh(devices=[CPU] * MESHES[name])


def _payload(fmt: str, n: int, seed: int) -> bytes:
    gen = {"bc1": testgen.bc1_realistic, "bc2": testgen.bc2_realistic,
           "bc3": testgen.bc3_realistic}.get(fmt)
    return gen(n, seed=seed) if gen else testgen.bc_blocks(n, BLOCK_SIZE[fmt], seed=seed)


def _u32(a) -> np.ndarray:
    """32-bit lanes as unsigned (the port's are int32, JAX's uint32)."""
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("n", [8, 4, 6])
def test_make_mesh_shapes_match_jax(n):
    want = jax_make_mesh(n)
    got = make_mesh(devices=[CPU] * n)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape
    assert make_mesh(n, devices=[CPU] * 8).shape == dict(want.shape)
    assert got.home == CPU and got.positions == [
        (f, s) for f in range(got.devices.shape[0]) for s in range(got.devices.shape[1])]


def test_make_mesh_takes_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        make_mesh()


@pytest.mark.parametrize("make", [
    lambda: sharded.bc1_auto_step("mesh"),
    lambda: modesort_transform_step(object()),
    lambda: untransform_step(None, "bc1", Bc1TransformSettings()),
], ids=["auto-step", "modesort-step", "untransform-step"])
def test_a_mesh_step_takes_only_a_mesh(make):
    with pytest.raises(TypeError, match="expected a Mesh"):
        make()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("fmt", list(WORDS))
def test_auto_step_matches_jax_single_file_steps(fmt, mesh_name):
    """Two bucket sizes: 2,048 blocks (a 1 KiB colour chunk at 8 shards, shorter than
    SPAN) and 70,001 (not a multiple of the blocks axis: padded; chunks longer than
    SPAN at 2 shards). The first file fills the bucket, the others are ragged, down
    to 1 and 2 blocks."""
    mesh = _mesh(mesh_name)
    wpb = WORDS[fmt]
    jax_step = getattr(jax_sharded, f"{fmt}_auto_step_single")
    for bucket in (2048, 70_001):
        B = 2 * mesh.shape["files"]
        ns = [bucket, bucket - 1234, 1, 2, 777, bucket // 2][:B]
        flats = np.zeros((B, wpb * bucket), np.uint32)
        for b, n in enumerate(ns):
            flats[b, :wpb * n] = np.frombuffer(_payload(fmt, n, seed=b + bucket), "<u4")
        valid = [4 * n for n in ns]
        backend.reset_launch_counts()
        rows, best = sharded.auto_step(
            fmt, mesh, getattr(sharded, f"_{fmt.upper()}_CANDIDATES"))(
            torch.from_numpy(flats.view(np.int32)), valid)
        assert all(v == 0 for v in backend.LAUNCHES.values())
        assert rows.device == CPU and best.device == CPU
        for b, n in enumerate(ns):
            want = jax.device_get(jax_step(jnp.asarray(flats[b]), valid[b]))
            assert int(best[b]) == int(want[-1])
            assert rows[b, :4 * wpb * n].numpy().tobytes() == \
                jax_bytes(fmt, want[:-1], want[-1], n)


def test_bc1_matches_jax_mesh_step():
    """At the shape of JAX's own shard_map scorer test: chunks of SPAN bytes, files
    full and 500 bytes short."""
    jax_mesh = jax_make_mesh(8)
    nb = jax_mesh.shape["blocks"]
    nblocks = nb * SPAN // 4
    batch = 2 * jax_mesh.shape["files"]
    rng = np.random.default_rng(9)
    flats = rng.integers(0, 2**32, (batch, 2 * nblocks), dtype=np.uint32)
    valid = [4 * nblocks, 4 * nblocks - 500] * (batch // 2)
    want = jax.device_get(jax_sharded.bc1_auto_step(jax_mesh)(
        jnp.asarray(flats), jnp.asarray(valid, jnp.int32)))
    rows, best = sharded.bc1_auto_step(make_mesh(devices=[CPU] * 8))(
        torch.from_numpy(flats.view(np.int32)), valid)
    np.testing.assert_array_equal(best.numpy(), np.asarray(want[-1]))
    for b, v in enumerate(valid):
        assert rows[b, :8 * (v // 4)].numpy().tobytes() == jax_bytes(
            "bc1", [w[b] for w in want[:-1]], want[-1][b], v // 4)


@pytest.mark.parametrize("mesh_name", ["1x8", "3x2"])
@pytest.mark.parametrize("fmt", list(WORDS))
def test_regions_step_under_a_mesh_matches_one_device(fmt, mesh_name):
    """zstd-scored: the picks and each file's transformed bytes equal the
    single-device step's, itself held to JAX in ``test_torch_pipeline_host.py``.
    Ragged files in a bucket that the blocks axis does not divide."""
    mesh = _mesh(mesh_name)
    wpb, B, bucket = WORDS[fmt], 2 * mesh.shape["files"], 2049
    rng = np.random.default_rng(3)
    ns = [int(n) for n in rng.integers(1, bucket + 1, B)]
    flats = np.zeros((B, wpb * bucket), np.uint32)
    for b, n in enumerate(ns):
        flats[b, :wpb * n] = np.frombuffer(_payload(fmt, n, seed=b + 40), "<u4")
    flats = torch.from_numpy(flats.view(np.int32))
    valid = [4 * n for n in ns]
    keys = getattr(sharded, f"_{fmt.upper()}_CANDIDATES")
    got_rows, got_best = sharded.BatchStep(fmt, keys, ZstdEstimation(1), mesh)(flats, valid)
    want_rows, want_best = sharded.BatchStep(fmt, keys, ZstdEstimation(1))(flats, valid)
    assert got_rows.shape == want_rows.shape and got_rows.dtype == torch.uint8
    assert torch.equal(got_best, want_best)
    for b, n in enumerate(ns):
        assert torch.equal(got_rows[b, :BLOCK_SIZE[fmt] * n], want_rows[b, :BLOCK_SIZE[fmt] * n])


@pytest.mark.parametrize("fmt", ["bc7", "bc6h"])
def test_modesort_step_matches_jax(fmt):
    jax_mesh = jax_make_mesh(8)
    n = 4096 * jax_mesh.shape["blocks"]
    B = 2 * jax_mesh.shape["files"]
    words = np.stack([np.frombuffer(testgen.bc7_realistic(n, seed=3 + b), "<u4")
                      for b in range(B)])
    mesh = make_mesh(devices=[CPU] * 8)
    for valid in ([n] * B, [n - 5001, 3]):
        want = jax.device_get(jax_sharded.modesort_transform_step(jax_mesh, fmt)(
            jnp.asarray(words), jnp.asarray(valid, jnp.uint32)))
        got = modesort_transform_step(mesh, fmt)(torch.from_numpy(words.view(np.int32)),
                                                 valid)
        for g, w in zip(got, want):
            assert g.dtype == torch.uint8
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("fmt,settings", [
    ("bc1", Bc1TransformSettings(YCoCgVariant.VARIANT2, True)),
    ("bc2", Bc2TransformSettings(YCoCgVariant.VARIANT3, True)),
    ("bc3", Bc3TransformSettings(YCoCgVariant.VARIANT1, True, True)),
    ("bc4", Bc4TransformSettings(True)),
    ("bc5", Bc5TransformSettings(False)),
])
def test_untransform_step_matches_jax(fmt, settings):
    jax_mesh = jax_make_mesh(8)
    B, n = 2 * jax_mesh.shape["files"], 2048
    rng = np.random.default_rng(4)
    oracle = {"bc1": obc1.transform, "bc2": obc2.transform, "bc3": obc3.transform,
              "bc4": obc45.transform_bc4, "bc5": obc45.transform_bc5}[fmt]
    spec = {"bc1": hostwrap.bc1_stream_spec, "bc2": hostwrap.bc2_stream_spec,
            "bc3": hostwrap.bc3_stream_spec,
            "bc4": lambda s: jax_bc45._bc4_spec(s.split_endpoints),
            "bc5": lambda s: jax_bc45._bc5_spec(s.split_endpoints)}[fmt](settings)
    payloads = [rng.integers(0, 256, BLOCK_SIZE[fmt] * n, np.uint8).tobytes()
                for _ in range(B)]
    transformed = [oracle(p, settings) for p in payloads]
    streams, pos = [], 0
    for bpb in spec:
        streams.append(np.stack([np.frombuffer(t, np.uint8)[pos * n:(pos + bpb) * n]
                                 .copy().view("<u4") for t in transformed]))
        pos += bpb
    want = np.asarray(jax_sharded.untransform_step(jax_mesh, fmt, settings)(
        *[jnp.asarray(s) for s in streams]))
    for mesh_name in ("1x8", "3x2"):
        mesh = _mesh(mesh_name)
        if B % mesh.shape["files"]:
            continue
        got = untransform_step(mesh, fmt, convert.from_reference(settings))(
            *[torch.from_numpy(s.view(np.int32)) for s in streams])
        np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))
        for b in range(B):
            assert got[b].numpy().tobytes() == payloads[b]
    # byte streams of a block count that no blocks axis divides
    n = 2049
    payloads = [rng.integers(0, 256, BLOCK_SIZE[fmt] * n, np.uint8).tobytes()
                for _ in range(2)]
    transformed = [oracle(p, settings) for p in payloads]
    streams, pos = [], 0
    for bpb in spec:
        streams.append(torch.from_numpy(np.stack([
            np.frombuffer(t, np.uint8)[pos * n:(pos + bpb) * n] for t in transformed])))
        pos += bpb
    got = untransform_step(_mesh("1x8"), fmt, convert.from_reference(settings))(*streams)
    assert [got[b].numpy().tobytes() for b in range(2)] == payloads

"""The port's batched steps (``parallel/sharded.py``; plain versions on the CPU)
against the JAX package's (``dxt_lossless_transform_tpu/parallel/sharded.py``): the
single-file steps, the BC1 batch step against the JAX words path (its Pallas
deinterleave and region kernels in interpret mode), and the batch step's region
rows against the JAX host-scored step's, with ragged files. Inputs are payloads from
the generators with numpy seeds, or random words; picks and row bytes must be equal
(exact). The steps return each file's transformed bytes, which must equal what the
JAX pipeline serializes from its step's lanes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu.parallel import sharded as jax_sharded
from dxt_lossless_transform_tpu.utils import testgen
from dxt_lossless_transform_tpu_torch.estimate.zstd import ZstdEstimation
from dxt_lossless_transform_tpu_torch.parallel import sharded

from jax_batch_bytes import jax_bytes


def payloads(fmt: str, sizes) -> list:
    gen = {"bc1": testgen.bc1_realistic, "bc2": testgen.bc2_realistic,
           "bc3": testgen.bc3_realistic}.get(fmt)
    size = 8 if fmt in ("bc1", "bc4") else 16
    return [gen(n, seed=n) if gen else testgen.bc_blocks(n, size, seed=n) for n in sizes]


@pytest.mark.parametrize("fmt,wpb", [("bc1", 2), ("bc2", 4), ("bc3", 4), ("bc4", 2),
                                     ("bc5", 4)])
def test_single_steps_match_jax(fmt, wpb):
    data = payloads(fmt, (2048,))[0]
    flat = np.frombuffer(data, "<u4")
    for valid in (None, 4 * (len(flat) // wpb) - 4 * 501):
        want = jax.device_get(getattr(jax_sharded, f"{fmt}_auto_step_single")(
            jnp.asarray(flat), None if valid is None else jnp.int32(valid)))
        got, best = getattr(sharded, f"{fmt}_auto_step_single")(
            torch.from_numpy(flat.view(np.int32).copy()), valid)
        n = len(flat) // wpb if valid is None else valid // 4
        assert int(best) == int(want[-1])
        assert got.numpy().tobytes() == jax_bytes(fmt, want[:-1], want[-1], n)


def test_bc1_batched_impl_matches_jax_words_path(monkeypatch):
    """The JAX batch step on its Mosaic words path (deinterleave and region kernels in
    interpret mode, as ``tests/test_parallel.py:262`` runs it), one file full and one
    ragged, against the port's step: every pick and each file's bytes equal."""
    monkeypatch.setattr(jax_sharded, "_WORDS_INTERPRET", True)
    rng = np.random.default_rng(12)
    nblocks = 16384
    flats = rng.integers(0, 2**32, (2, 2 * nblocks), dtype=np.uint32)
    valid = [4 * nblocks, 4 * nblocks - 502]
    want = jax.device_get(jax_sharded._bc1_batched_impl(
        jnp.asarray(flats), jnp.asarray(valid, jnp.int32), jax_sharded._BC1_CANDIDATES,
        jax_sharded.DEFAULT_OFFSETS, allow_pallas=True))
    rows, best = sharded.auto_step_batched("bc1", sharded._BC1_CANDIDATES)(
        torch.from_numpy(flats.view(np.int32)), valid)
    np.testing.assert_array_equal(best.numpy(), np.asarray(want[-1]))
    for b, v in enumerate(valid):
        assert rows[b, :8 * (v // 4)].numpy().tobytes() == jax_bytes(
            "bc1", [w[b] for w in want[:-1]], want[-1][b], v // 4)


@pytest.mark.parametrize("fmt", ["bc1", "bc3", "bc4"])
def test_region_rows_match_jax(fmt):
    """The zstd-scored step's rows: each candidate's region, cut at each file's own
    length, equals the JAX host-scored step's row prefix byte for byte (JAX's rows
    are one a candidate for BC1 and BC4, the port's one a distinct key)."""
    wpb = {"bc1": 2, "bc3": 4, "bc4": 2}[fmt]
    data = payloads(fmt, (2048, 100, 1999))
    flats = np.zeros((len(data), wpb * 2048), np.uint32)
    for row, d in enumerate(data):
        w = np.frombuffer(d, "<u4")
        flats[row, :len(w)] = w
    valid = [4 * (len(d) // (4 * wpb)) for d in data]
    cand = getattr(jax_sharded, f"_{fmt.upper()}_CANDIDATES")
    want = jax.device_get(jax_sharded._BATCHED_REGIONS_IMPLS[fmt](
        jnp.asarray(flats), jnp.asarray(valid, jnp.int32), cand, allow_pallas=False))
    step = sharded.BatchStep(fmt, cand, ZstdEstimation(1))
    (got, per_block), = sharded._rows(fmt, torch.from_numpy(flats.view(np.int32)),
                                      [v // 4 for v in valid], step.keys, step.joined)
    if fmt == "bc3":  # JAX's distinct alpha rows, then its distinct colour rows
        alpha, colour = (np.asarray(w) for w in want[-2:])
        pairs = [(a, alpha[:, a]) for a in range(alpha.shape[1])] + [
            (alpha.shape[1] + k, colour[:, k]) for k in range(colour.shape[1])]
        assert got.shape[1] == alpha.shape[1] + colour.shape[1]
    else:  # JAX's row of each candidate is the port's row of its key
        rows = np.asarray(want[-1])
        pairs = [(r, rows[:, c]) for c, r in enumerate(step.terms[0])]
        assert rows.shape[1] == len(cand) and got.shape[1] == len(set(step.terms[0]))
    for r, w in pairs:
        for b, v in enumerate(valid):
            n = per_block[r] * v // 4
            np.testing.assert_array_equal(got[b, r, :n].numpy(), w[b, :n])


@pytest.mark.parametrize("fmt", ["bc7", "bc6h"])
def test_modesort_step_single_matches_jax(fmt):
    """The sort+planes step of one file: byte planes and mode stream equal the JAX
    step's at whole 4096-block chunks (the only block counts the JAX step takes)."""
    flat = np.frombuffer(testgen.bc7_realistic(8192, seed=3), "<u4")
    want_planes, want_stream = jax.device_get(
        jax_sharded.modesort_step_single(jnp.asarray(flat), fmt=fmt))
    got_planes, got_stream = sharded.modesort_step_single(
        torch.from_numpy(flat.view(np.int32).copy()), fmt=fmt)
    np.testing.assert_array_equal(got_planes.numpy(), np.asarray(want_planes))
    np.testing.assert_array_equal(got_stream.numpy(), np.asarray(want_stream))

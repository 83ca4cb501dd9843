"""The count kernel's compiled-in default ladder and which ladders take it, on the
CPU:

1. the ``Rung<k, weight>`` table of ``csrc/bc1_kernels.cu`` is the estimator's
   ``DEFAULT_OFFSETS`` with ``offset_weight``, nearest first, and equals the JAX
   package's ladder; its weights do not grow with k (the kernel merges its groups by
   max);
2. ``cuda_ltu.default_ladder`` sends the whole default ladder, and no other ladder
   (its prefixes neither), to that kernel, which counts every rung it compiles in
   (the source's ``default_ladder`` refuses a call without a table whose ladder is
   not the whole compiled one);
3. the wrapper's tables: the default ladder goes uncut, with no table, at any row
   length (the kernel's stream-head guard drops what a short row does not reach);
   every other ladder keeps its offsets below the longest length - 3 in a table of
   at least one entry.
"""

import re
from pathlib import Path

import pytest
import torch

from dxt_lossless_transform_tpu.estimate.ltu import DEFAULT_OFFSETS as JAX_OFFSETS
from dxt_lossless_transform_tpu.estimate.ltu import offset_weight as jax_offset_weight
from dxt_lossless_transform_tpu_torch.estimate import cuda_ltu
from dxt_lossless_transform_tpu_torch.estimate.ltu import DEFAULT_OFFSETS, offset_weight

SOURCE = Path(cuda_ltu.__file__).resolve().parent.parent / "csrc" / "bc1_kernels.cu"


def _compiled_ladder():
    text = SOURCE.read_text()
    groups = re.findall(r"using DefaultGroup(\d) = Rungs<(.*?)>;", text, flags=re.S)
    assert [int(g) for g, _ in groups] == [0, 1, 2, 3]
    return [(int(k), int(w)) for _, body in groups
            for k, w in re.findall(r"Rung<(\d+), (\d+)>", body)]


def test_compiled_ladder_is_the_default_ladder():
    ladder = _compiled_ladder()
    assert ladder == [(k, offset_weight(k)) for k in DEFAULT_OFFSETS]
    assert ladder == [(k, jax_offset_weight(k)) for k in sorted(JAX_OFFSETS)]
    assert [k for k, _ in ladder] == sorted({k for k, _ in ladder})
    assert all(w1 >= w2 for (_, w1), (_, w2) in zip(ladder, ladder[1:]))
    # the largest offset is the halo the kernel stages in shared memory
    assert ladder[-1][0] == int(re.search(r"constexpr int kHalo = (\d+);",
                                          SOURCE.read_text()).group(1))


_DEFAULT = [(k, offset_weight(k)) for k in DEFAULT_OFFSETS]


def _ladder(pairs):
    return [k for k, _ in pairs], [w for _, w in pairs]


def test_default_ladder_takes_the_default_kernel():
    """The whole default ladder takes the compiled-in ladder, with no table on the
    card."""
    assert cuda_ltu.default_ladder(*_ladder(_DEFAULT))


@pytest.mark.parametrize("n", range(len(_DEFAULT)))
def test_prefix_takes_the_table(n):
    """A prefix of the default ladder is counted with its own rungs only, so it takes
    the generic kernel's table: the default kernel would count all 20."""
    assert not cuda_ltu.default_ladder(*_ladder(_DEFAULT[:n]))


@pytest.mark.parametrize("drop", range(len(_DEFAULT) - 1))
def test_ladder_without_a_rung_takes_the_table(drop):
    """A ladder of offsets within the halo that is not the default one (the default
    without one rung but the last) takes the generic kernel's table."""
    assert not cuda_ltu.default_ladder(*_ladder(_DEFAULT[:drop] + _DEFAULT[drop + 1:]))


@pytest.mark.parametrize("rung", range(len(_DEFAULT)))
def test_ladder_with_another_weight_takes_the_table(rung):
    pairs = list(_DEFAULT)
    pairs[rung] = (pairs[rung][0], pairs[rung][1] - 1)
    assert not cuda_ltu.default_ladder(*_ladder(pairs))
    assert not cuda_ltu.default_ladder(*_ladder(pairs[:rung + 1]))


def test_longer_ladder_takes_the_table():
    assert not cuda_ltu.default_ladder(*_ladder(_DEFAULT + [(8192, 11)]))
    assert not cuda_ltu.default_ladder([2], [offset_weight(2)])


def _table(pairs, longest):
    """(offsets passed, table on the card or None) of the wrapper's tables for a
    launch whose longest row is ``longest`` bytes; the card is the CPU here."""
    tables = cuda_ltu._Tables(*_ladder(pairs), longest, torch.device("cpu"))
    _, _, n, table = tables.args
    return n, None if table is None else tables._table.tolist()


@pytest.mark.parametrize("longest", [0, 5, 100, 4099, 4100, 70_000])
def test_default_ladder_goes_uncut(longest):
    """The default ladder reaches the default kernel whole at every length: no cut
    to a prefix, which the kernel could not tell from the whole ladder."""
    assert _table(_DEFAULT, longest) == (len(_DEFAULT), None)


@pytest.mark.parametrize("longest", [100, 4100, 70_000])
def test_prefix_is_cut_into_the_table(longest):
    """A prefix of five rungs on rows of any length takes the table, holding its own
    rungs only: the five on long rows, those below ``longest`` - 3 on short ones."""
    kept = [(k, w) for k, w in _DEFAULT[:5] if k < longest - 3]
    assert _table(_DEFAULT[:5], longest) == (
        len(kept), [k for k, _ in kept] + [w for _, w in kept])


def test_ladder_out_of_reach_keeps_a_table():
    """A ladder whose every offset lies past the rows takes the generic kernel with
    no offsets (it counts nothing) and a table of one entry, never a null pointer,
    which would mean the default ladder."""
    assert _table([(8192, 11)], 100) == (0, [0])
    assert _table(_DEFAULT[:5], 4) == (0, [0])

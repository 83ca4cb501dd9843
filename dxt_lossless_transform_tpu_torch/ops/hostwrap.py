"""Stream specs of the BC1-BC3 transformed layouts.

The port's own copy of ``dxt_lossless_transform_tpu/ops/hostwrap.py:115-127``
(``bc1_stream_spec``, ``bc2_stream_spec``, ``bc3_stream_spec``): the bytes per block
of each stream of the transformed payload, in on-disk order, so that a stream of n
blocks lies at ``sum(earlier specs) * n``. The batched load path
(:class:`..parallel.pipeline.UntransformBatchProcessor`) lays many files' streams
side by side with them. The BC4/BC5 specs are :func:`.bc45.bc4_spec` and
:func:`.bc45.bc5_spec`.
"""

from __future__ import annotations

from typing import Tuple


def bc1_stream_spec(settings) -> Tuple[int, ...]:
    return (2, 2, 4) if settings.split_colour_endpoints else (4, 4)


def bc2_stream_spec(settings) -> Tuple[int, ...]:
    return (8, 2, 2, 4) if settings.split_colour_endpoints else (8, 4, 4)


def bc3_stream_spec(settings) -> Tuple[int, ...]:
    spec = (1, 1) if settings.split_alpha_endpoints else (2,)
    spec = spec + (6,)
    spec = spec + ((2, 2) if settings.split_colour_endpoints else (4,))
    return spec + (4,)

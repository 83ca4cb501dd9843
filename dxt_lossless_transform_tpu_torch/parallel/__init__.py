"""The corpus batch pipeline on one device: many textures per kernel launch.

Counterpart of ``dxt_lossless_transform_tpu/parallel``: the batched steps
(:mod:`.sharded`) and the processors (:mod:`.pipeline`). The multi-device layer
(a mesh, the sharded steps, ``make_mesh``, ``initialize``/``is_primary``) is not
ported yet; a mesh other than None raises
:class:`..errors.MultiDeviceNotPortedError`.
"""

from .sharded import (  # noqa: F401
    bc1_auto_step_single, bc2_auto_step_single, bc3_auto_step_single,
    bc4_auto_step_single, bc5_auto_step_single, modesort_step_single,
)
from .pipeline import (  # noqa: F401
    BatchProcessor, BatchResult, Bc1BatchProcessor, Bc2BatchProcessor,
    Bc3BatchProcessor, Bc4BatchProcessor, Bc5BatchProcessor, ModeSortBatchProcessor,
    RgbBatchProcessor, UntransformBatchProcessor, transform_corpus_bc1,
)

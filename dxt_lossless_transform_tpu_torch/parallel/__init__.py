"""The corpus batch pipeline and the multi-device layer: many textures per kernel
launch, on one device or sharded over a mesh.

Counterpart of ``dxt_lossless_transform_tpu/parallel``: the batched and sharded steps
(:mod:`.sharded`), the processors (:mod:`.pipeline`), the device mesh (:mod:`.mesh`)
and the process group (:mod:`.distributed`). A mesh is a ``(files, blocks)`` grid of
devices driven by one process, as in JAX: files data-parallel over the files axis,
each texture's blocks sharded over the blocks axis, the scorer's halos and partial
counts exchanged between the positions (and, under a process group, between the
ranks).
"""

from .mesh import Mesh, make_mesh  # noqa: F401
from .sharded import (  # noqa: F401
    bc1_auto_step, bc1_auto_step_single, bc2_auto_step, bc2_auto_step_single,
    bc3_auto_step, bc3_auto_step_single, bc4_auto_step, bc4_auto_step_single,
    bc5_auto_step, bc5_auto_step_single, modesort_step_single,
    modesort_transform_step, untransform_step,
)
from .pipeline import (  # noqa: F401
    BatchProcessor, BatchResult, Bc1BatchProcessor, Bc2BatchProcessor,
    Bc3BatchProcessor, Bc4BatchProcessor, Bc5BatchProcessor, ModeSortBatchProcessor,
    RgbBatchProcessor, UntransformBatchProcessor, transform_corpus_bc1,
)
from .distributed import initialize, is_primary  # noqa: F401

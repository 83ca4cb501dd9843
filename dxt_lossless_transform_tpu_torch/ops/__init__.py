"""The device compute path: transforms, untransforms and auto-searches, bytes to
bytes, through the kernels of :mod:`.cuda`.

Counterpart of ``dxt_lossless_transform_tpu/ops``, with the same modules at the
package level.
"""

from . import ycocg, bc1, bc2, bc3  # noqa: F401

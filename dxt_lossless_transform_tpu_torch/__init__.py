"""PyTorch/CUDA port of ``dxt_lossless_transform_tpu`` for NVIDIA Hopper (H100).

It carries the BC1-BC7, BC6H, RGBA8888, BGRA8888 and BGR888 DDS production paths:
the auto-search under the LTU estimator (for BC7 and BC6H confirmed by zstd-1
through the system ``libzstd.so.1``), the transform with the winning settings and
the 4-byte header, and the load path that reads the header back and untransforms,
over bytes in memory or file in, file out (:mod:`.formats.api`,
:mod:`.formats.file_io`). Entry points run on the
CUDA device by default (``device="cuda"``) and raise
:class:`~.errors.DeviceUnavailableError` when there is none; ``device="cpu"`` runs
the plain PyTorch versions of the kernels.

Importing the package builds nothing and imports no ``triton``: the CUDA library is
compiled by ``nvcc`` at first use (see :mod:`.backend`).
"""

__version__ = "0.1.0"

from .settings import (  # noqa: F401
    BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES, BC2_COMPREHENSIVE_CANDIDATES,
    BC2_FAST_CANDIDATES, BC3_COMPREHENSIVE_CANDIDATES, BC3_FAST_CANDIDATES,
    BC6H_FAST_CANDIDATES, BC7_COMPREHENSIVE_CANDIDATES, BC7_FAST_CANDIDATES,
    RGB_FAST_CANDIDATES, Bc1TransformSettings, Bc2TransformSettings,
    Bc3TransformSettings, Bc4TransformSettings, Bc5TransformSettings,
    Bc6hTransformSettings, Bc7TransformSettings, RgbTransformSettings, YCoCgVariant,
)

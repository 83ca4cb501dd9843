"""The port's mode-sort payload lengths and package-level names, held to the JAX
package:

1. ``DdsHandler.untransform`` of a file that was never transformed raises what the
   JAX handler raises (the DDS magic reads as a mode-sort header, and the payload
   length must keep the bytes past the last whole block, as ``oracle/bc7.py`` does);
2. ``ops.bc7.transformed_len`` and ``original_len`` agree with ``oracle/bc7.py``
   for every length 0-64 and both sort settings;
3. the names the reference CLI imports from ``formats`` and ``estimate``, and
   ``__version__``, import from the port without ``jax``, ``zstandard`` or the zstd
   library.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dxt_lossless_transform_tpu.formats.handlers import DdsHandler as JaxDdsHandler
from dxt_lossless_transform_tpu.oracle import bc7 as oracle_bc7
from dxt_lossless_transform_tpu.settings import Bc7TransformSettings as JaxBc7Settings
from dxt_lossless_transform_tpu.utils import testgen as jax_testgen
from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler
from dxt_lossless_transform_tpu_torch.ops import bc7
from dxt_lossless_transform_tpu_torch.settings import Bc7TransformSettings
from dxt_lossless_transform_tpu_torch.utils import testgen

REPO = Path(__file__).resolve().parents[1]


def _outcome(fn, data):
    """The bytes ``fn`` returns, or the name of the error it raises."""
    try:
        return fn(data)
    except Exception as exc:  # the type is what is compared
        return type(exc).__name__


@pytest.mark.parametrize("fmt,w,h,error", [
    ("BC1", 4, 4, "InvalidDataAlignment"),
    ("BC4", 12, 4, "InputTooShortForStatedTextureSize"),
])
def test_untransform_of_an_untransformed_file_raises_as_jax(fmt, w, h, error):
    data = testgen.make_dds(fmt, w, h)
    assert data == jax_testgen.make_dds(fmt, w, h)
    assert _outcome(DdsHandler("cpu").untransform, data) == error
    assert _outcome(JaxDdsHandler().untransform, data) == error


def _odd_block_files():
    rng = np.random.default_rng(11)
    files = []
    for fmt in ("BC1", "BC2", "BC3", "BC4", "BC5"):
        while sum(f[0] == fmt for f in files) < 4:
            w, h = 4 * int(rng.integers(1, 16)), 4 * int(rng.integers(1, 16))
            if (w // 4) * (h // 4) % 2:
                files.append((fmt, w, h))
    return files


@pytest.mark.parametrize("fmt,w,h", _odd_block_files())
def test_untransform_of_odd_block_counts_matches_jax(fmt, w, h):
    data = testgen.make_dds(fmt, w, h)
    assert _outcome(DdsHandler("cpu").untransform, data) == \
        _outcome(JaxDdsHandler().untransform, data)


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("length", range(65))
def test_payload_lengths_match_the_oracle(length, sort):
    ours = Bc7TransformSettings(sort_by_mode=sort)
    theirs = JaxBc7Settings(sort_by_mode=sort)
    assert bc7.transformed_len(length, ours) == oracle_bc7.transformed_len(length, theirs)
    assert _outcome(lambda t: bc7.original_len(t, ours), length) == \
        _outcome(lambda t: oracle_bc7.original_len(t, theirs), length)


def test_cli_names_import_without_jax_or_zstd():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('zstandard', 'jax'):\n"
        "            raise ImportError('not here')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import dxt_lossless_transform_tpu_torch as p\n"
        "from dxt_lossless_transform_tpu_torch.formats import TransformBundle, file_io\n"
        "from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler\n"
        "from dxt_lossless_transform_tpu_torch.estimate import (\n"
        "    LtuEstimation, NoEstimation, SizeEstimation, ZstdEstimation)\n"
        "from dxt_lossless_transform_tpu_torch.ops import bc1, bc2, bc3, ycocg\n"
        "from dxt_lossless_transform_tpu_torch.estimate import zstd\n"
        "from dxt_lossless_transform_tpu_torch.cli import debug, main\n"
        "from dxt_lossless_transform_tpu_torch.cli.main import make_preset_bundle\n"
        "assert zstd._lib is None\n"
        "assert callable(file_io.transform_file_with_multiple_handlers)\n"
        "assert callable(main.main) and callable(debug.register)\n"
        "assert main._build_parser().parse_args(['transform', 'a', 'b']).device == 'cuda'\n"
        "make_preset_bundle('low'), make_preset_bundle('medium')\n"
        "assert zstd._lib is None\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'zstandard', 'dxt_lossless_transform_tpu')]\n"
        "assert not bad, bad\n"
        "print(p.__version__)\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    import dxt_lossless_transform_tpu as jax_package
    assert out.stdout.strip() == jax_package.__version__

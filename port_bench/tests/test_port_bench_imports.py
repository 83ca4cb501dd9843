import sys
import types

import pytest

from port_bench import imports


def test_top_level_names_are_compared_whole():
    assert imports.forbidden(["dxt_lossless_transform_tpu_torch",
                              "dxt_lossless_transform_tpu_torch.ops.bc1"]) == []
    assert imports.forbidden(["dxt_lossless_transform_tpu",
                              "dxt_lossless_transform_tpu.ops"]) == [
        "dxt_lossless_transform_tpu", "dxt_lossless_transform_tpu.ops"]
    assert imports.forbidden(["jax.numpy", "jaxlib", "flax.linen", "jaxtyping",
                              "numpy"]) == ["flax.linen", "jax.numpy", "jaxlib"]


def test_check_exits_and_names_what_it_found(monkeypatch, capsys):
    imports.check_loaded("clean")
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit) as e:
        imports.check_loaded("after the window")
    assert e.value.code == 3
    assert "jax" in capsys.readouterr().err


def test_the_harness_loads_no_jax():
    import port_bench.run  # noqa: F401

    assert imports.forbidden(list(sys.modules)) == []

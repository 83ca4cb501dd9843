"""The JAX package's batch pipeline as the reference of the port's batch step."""
import numpy as np


def jax_bytes(fmt: str, lanes, best, n: int) -> bytes:
    """The bytes that the JAX package's batch pipeline serializes for one file of n
    blocks from its device-scored step's lanes and pick: the bytes the port's step
    returns for the file."""
    from dxt_lossless_transform_tpu.parallel import pipeline as jax_pipeline

    cfg = jax_pipeline._FORMATS[fmt]
    return cfg["serialize"]([np.asarray(a) for a in lanes], n,
                            cfg["candidates"][int(best)])

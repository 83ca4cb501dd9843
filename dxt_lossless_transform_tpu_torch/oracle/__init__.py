"""Numpy reference decoders of the port (its own copies of
``dxt_lossless_transform_tpu/oracle/{color565,decode}.py``): BC1-BC3 blocks to RGBA
pixels, which ``debug-bc{1,2,3} roundtrip`` compares after each round trip."""

"""Command-line tool of the port: transform / untransform / debug-* commands
(counterpart of ``dxt_lossless_transform_tpu/cli``)."""

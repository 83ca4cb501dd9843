"""The benchmark of ``dxt_lossless_transform_tpu_torch`` on an NVIDIA card.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Configurations
(``configs/<name>.json``), traffic mixes (``traffic/<name>.json``), the code that
drives one kind of call (``entries/<name>.py``) and per-layer metrics
(``layer_metrics/<metric>.py``) are files of their own, found by name.
"""

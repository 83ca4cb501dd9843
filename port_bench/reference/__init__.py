"""Plain PyTorch references of the formats the benchmark's configurations run, one
module per format (``<format>.py``), found by the configuration's ``format``."""

"""Wrappers of the hand-written CUDA kernels, each with its plain PyTorch version.

A wrapper launches its kernel for a CUDA tensor and takes the plain version for a
CPU tensor; there is no fall back from one to the other."""

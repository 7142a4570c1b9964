"""The port's kernels: one CUDA kernel per ported Pallas kernel
(``selective_scan``, ``conv1d``, ``decode_step``), their plain PyTorch
versions (``ref``), the build and loader (``_lib``) and the dispatch the
models call (``ops``)."""

"""PyTorch + CUDA port of fitgnn_tpu.

The package mirrors ``fitgnn_tpu``'s module layout.  Host-side ingest stays
numpy; device work is PyTorch, and the TPU's Pallas kernels on the ported
paths are CUDA C++ kernels for Hopper under ``csrc/``, compiled with
``nvcc`` at first use into ``build/fitgnn_tpu_torch/`` and bound with
``ctypes``.  Importing any module here imports neither JAX nor
``fitgnn_tpu``.
"""

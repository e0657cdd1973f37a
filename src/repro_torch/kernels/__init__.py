"""Hand-written Hopper kernels of the port and their plain versions.

| kernel            | route                                  | replaces (TPU)                    |
|-------------------|----------------------------------------|-----------------------------------|
| block_attention   | CUDA C++ (csrc/block_attention.cu)     | repro/kernels/block_attention.py  |
| confidence_argmax | CUDA C++ (csrc/confidence.cu)          | repro/kernels/confidence.py       |

Each source builds with nvcc at first use into its own library under
``build/repro_torch/`` (``build.py``) and is bound with ``ctypes``.
The CPU tests (``tests/test_torch_*.py``) reach the plain versions and the
host-side geometry; ``python3 chip_smoke.py`` builds and checks the
kernels on the card.

``ops`` holds the checked, counted wrappers; ``ref`` the plain versions.
"""

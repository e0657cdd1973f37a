"""Hand-written Hopper kernels of the port and their plain versions.

| kernel            | route                      | replaces (TPU)                         |
|-------------------|----------------------------|----------------------------------------|
| block_attention   | CUDA C++ (csrc/*.cu, ctypes) | repro/kernels/block_attention.py      |
| confidence_argmax | Triton                     | repro/kernels/confidence.py            |

``ops`` holds the checked, counted wrappers; ``ref`` the plain versions.
"""

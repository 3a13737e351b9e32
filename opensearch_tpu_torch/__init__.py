"""opensearch_tpu_torch — the PyTorch and CUDA port of opensearch_tpu.

A second package beside the JAX one, laid out the same way (a module of
the port sits at the same relative path as its counterpart). It imports
torch and numpy, never jax and never opensearch_tpu. Device code runs on
one NVIDIA H100 by default; every entry point takes an explicit ``device``
and runs on the CPU only when asked (see backend.py). The hot kernels are
hand-written CUDA under ``csrc/``, built at first use (ops/cuda_lib.py).

Ported so far: kNN ``_search`` on one node (node.TorchNode) and the
REST server over it (rest/http.py).
"""

__version__ = "0.1.0"

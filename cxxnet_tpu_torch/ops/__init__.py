"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ops/lrn.py``, ``ops/conv.py``), and the seam that builds them
from ``csrc/`` (``ops/build.py``)."""

"""cxxnet_tpu_torch — the PyTorch/CUDA port of cxxnet_tpu for one NVIDIA H100.

The JAX package ``cxxnet_tpu`` stays the reference; this package runs the
same configs, netconfig graphs and checkpoints in PyTorch, with every
Pallas kernel on its path replaced by a kernel written by hand for Hopper
(``csrc/``, built by ``ops/build.py``). It imports ``torch`` and numpy,
never ``jax``, and nothing of ``cxxnet_tpu``: what it needs from there
(``config.py``, ``graph.py``, the checkpoint format) it keeps as its own
copy.

This slice serves AlexNet-family CNNs: ``python -m cxxnet_tpu_torch
<conf> task=serve model_in=<ckpt> conv_impl=pallas lrn_impl=pallas``.
Training, transformers, decode and paged serving come in later slices
(ROADMAP.md).
"""

__version__ = "0.1.0"

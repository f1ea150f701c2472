"""The port's LRN (cxxnet_tpu_torch/ops/lrn.py) against the JAX package's
Pallas LRN (cxxnet_tpu/ops/lrn.py) run in interpret mode on the CPU.

On the CPU the port's wrapper runs the kernel's plain PyTorch version,
so these hold the plain version — the arithmetic the CUDA kernel
repeats (tests/test_torch_cuda.py holds the kernel against it on the
card) — to the TPU kernel's semantics: the asymmetric window, its clamp
when nsize > C, and every special-cased beta form.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cxxnet_tpu.ops import lrn_pallas
from cxxnet_tpu_torch import layers as TL
from cxxnet_tpu_torch.ops import lrn as lrn_ops

ALPHA, KNORM = 0.01, 1.0


def _pair(shape, dtype, seed):
    """The same values for both packages: float32 numpy, rounded to bf16
    through torch when the case is bf16."""
    x = np.random.default_rng(seed).normal(0.0, 4.0, shape).astype(
        np.float32)
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(xt.float().numpy())
    if dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)
    return xt, xj


@pytest.mark.parametrize("nsize,beta,c,dtype", [
    (3, 0.75, 8, torch.float32),
    (5, 0.75, 8, torch.float32),
    (4, 0.75, 8, torch.float32),      # even window: lo = 2, hi = 1
    (5, 0.5, 8, torch.float32),
    (3, 1.0, 8, torch.float32),
    (3, 1.5, 8, torch.float32),
    (3, 1.75, 8, torch.float32),
    (3, 2.0, 8, torch.float32),
    (5, 1.3, 8, torch.float32),       # generic power
    (5, 0.75, 2, torch.float32),      # nsize > C: the window clamps
    (5, 0.75, 8, torch.bfloat16),
    (4, 0.5, 6, torch.bfloat16),
])
def test_lrn_matches_pallas(nsize, beta, c, dtype):
    xt, xj = _pair((2, c, 5, 6), dtype, seed=nsize * 10 + c)
    got = lrn_ops.lrn(xt, nsize, ALPHA, beta, KNORM)
    ref = np.asarray(lrn_pallas(xj, nsize, ALPHA, beta, KNORM,
                                interpret=True).astype(jnp.float32))
    assert got.dtype == dtype and got.shape == xt.shape
    # f32: the same ops in the same order, up to rsqrt/pow ulps;
    # bf16: one bf16 ulp at the final rounding
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=rtol,
                               atol=1e-6)


def test_lrn_cpu_tensor_runs_the_plain_version_and_counts_nothing():
    x = torch.randn(2, 7, 3, 3)
    before = lrn_ops.lrn.launches
    assert torch.equal(lrn_ops.lrn(x, 5, ALPHA, 0.75, KNORM),
                       lrn_ops.lrn_plain(x, 5, ALPHA, 0.75, KNORM))
    assert lrn_ops.lrn.launches == before


def test_lrn_other_devices_raise_instead_of_falling_back():
    x = torch.empty(2, 7, 3, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        lrn_ops.lrn(x, 5, ALPHA, 0.75, KNORM)


@pytest.mark.parametrize("knob,val", [("lrn_impl", "window"),
                                      ("lrn_impl", "band"),
                                      ("use_pallas", "0")])
def test_lrn_layer_xla_formulations_are_not_ported(knob, val):
    with pytest.raises(NotImplementedError):
        TL.create_layer("lrn", [(knob, val)])

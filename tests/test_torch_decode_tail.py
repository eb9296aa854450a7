"""Decode tail of the PyTorch port against the JAX package.

The port's plain version (what the wrapper runs on CPU tensors: the packed
algebra with ``F.conv2d``) is held to ``decode_tail_pallas`` in interpret mode,
to the exact un-packed ``MaskDecoder.decode_tail`` and to ``decode_tail_subpix``,
on the same numpy inputs and weights, rtol/atol 2e-4 (the packing sums taps
before the products, and fp32 sums of up to 1152 terms come in another order).
The CUDA kernel itself is held to the plain version by ``tests/test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from tests.torch_parity import port_tracker_network, seeded_tracker_variables, to_nchw
from yolo_puncture_tpu.ops.pallas.decode_tail import decode_tail_pallas
from yolo_puncture_tpu.track.network import PropagationNetwork as JaxNet
from yolo_puncture_tpu.track.network import _subpix_up_weights as jax_subpix_up_weights
from yolo_puncture_tpu.track.network import decode_tail_subpix as jax_decode_tail_subpix
from yolo_puncture_tpu_torch.ops.kernels.decode_tail import (
    decode_tail,
    decode_tail_reference,
    pack_decode_tail_params,
)
from yolo_puncture_tpu_torch.track.network import _subpix_up_weights, decode_tail_subpix

TOL = dict(rtol=2e-4, atol=2e-4)
N, NO, H16, W16 = 2, 2, 2, 4  # a 32×64 image


@pytest.fixture(scope="module")
def setup():
    variables = seeded_tracker_variables(seed=3)
    rng = np.random.default_rng(5)
    hidden = rng.standard_normal((N, NO, H16, W16, 128)).astype(np.float32)
    f8p = rng.standard_normal((N, 2 * H16, 2 * W16, 64)).astype(np.float32)
    f4p = rng.standard_normal((N, 4 * H16, 4 * W16, 64)).astype(np.float32)
    return variables, port_tracker_network(variables), hidden, f8p, f4p


def _jax_oracle(name, variables, hidden, f8p, f4p):
    h, f8, f4 = jnp.asarray(hidden), jnp.asarray(f8p), jnp.asarray(f4p)
    if name == "pallas_interpret":
        return np.asarray(decode_tail_pallas(variables, h, f8, f4, dtype=jnp.float32, interpret=True))
    if name == "subpix":
        return np.asarray(jax_decode_tail_subpix(variables, h, f8, f4, dtype=jnp.float32))
    net = JaxNet()
    tail = jax.jit(jax.vmap(lambda a, b, c: net.apply(variables, a, b, c, method=JaxNet.decode_tail)))
    return np.asarray(tail(h, f8, f4))


@pytest.mark.parametrize("oracle", ["pallas_interpret", "exact", "subpix"])
def test_plain_version_matches_jax(setup, oracle):
    variables, net, hidden, f8p, f4p = setup
    ref = _jax_oracle(oracle, variables, hidden, f8p, f4p)
    params = net.decoder.tail_params(torch.float32)
    got = decode_tail(params, torch.from_numpy(hidden), torch.from_numpy(f8p), torch.from_numpy(f4p)).numpy()
    assert got.shape == (N, NO, 4 * H16, 4 * W16) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **TOL)


def test_module_paths_agree(setup):
    """MaskDecoder.decode_tail (channel-first, through the wrapper), the exact
    un-packed tail and decode_tail_subpix give the same logits."""
    _, net, hidden, f8p, f4p = setup
    with torch.no_grad():
        fused = net.decoder.decode_tail(to_nchw(hidden), to_nchw(f8p), to_nchw(f4p)).numpy()
        exact = np.stack([net.decoder.decode_tail_exact(to_nchw(hidden[n]), to_nchw(f8p[n]), to_nchw(f4p[n])).numpy()
                          for n in range(N)])
        subpix = decode_tail_subpix(net.decoder, torch.from_numpy(hidden), torch.from_numpy(f8p),
                                    torch.from_numpy(f4p)).numpy()
    np.testing.assert_allclose(fused, exact, **TOL)
    np.testing.assert_allclose(subpix, exact, **TOL)


def test_subpix_up_weights_exact():
    K = np.random.default_rng(0).standard_normal((3, 3, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(_subpix_up_weights(torch.from_numpy(K)).numpy(),
                                  np.asarray(jax_subpix_up_weights(jnp.asarray(K))))


def test_bf16_rounds_where_the_kernel_does(setup):
    """bf16 activations: the plain version stays within bf16 noise of the fp32
    result (logits of a few units, 2^-8 relative rounding at three places)."""
    _, net, hidden, f8p, f4p = setup
    ref = decode_tail_reference(net.decoder.tail_params(torch.float32), torch.from_numpy(hidden),
                                torch.from_numpy(f8p), torch.from_numpy(f4p))
    p16 = net.decoder.tail_params(torch.bfloat16)
    assert p16.w8.dtype == torch.float32 and (p16.w8 == p16.w8.bfloat16().float()).all()
    got = decode_tail(p16, torch.from_numpy(hidden).bfloat16(), torch.from_numpy(f8p).bfloat16(),
                      torch.from_numpy(f4p).bfloat16())
    assert got.dtype == torch.float32
    assert float((got - ref).abs().max()) < 0.15


def test_params_are_cached_until_a_weight_changes(setup):
    _, net, *_ = setup
    a = net.decoder.tail_params(torch.float32)
    assert net.decoder.tail_params(torch.float32) is a
    with torch.no_grad():
        net.decoder.dec8.conv.weight.mul_(1.0)
    assert net.decoder.tail_params(torch.float32) is not a


def test_wrapper_checks_shapes_and_types(setup):
    _, net, hidden, f8p, f4p = setup
    params = net.decoder.tail_params(torch.float32)
    h, f8, f4 = torch.from_numpy(hidden), torch.from_numpy(f8p), torch.from_numpy(f4p)
    with pytest.raises(ValueError):
        decode_tail(params, h, f8[:, :-1], f4)
    with pytest.raises(ValueError):
        decode_tail(params, h[0], f8, f4)
    with pytest.raises(TypeError):
        decode_tail(params, h.bfloat16(), f8.bfloat16(), f4)
    dec = net.decoder
    assert pack_decode_tail_params(dec.dec8, dec.dec4, dec.out).w4.shape == (3, 3, 64, 256)

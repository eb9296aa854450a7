"""Memory readout of the PyTorch port against the JAX package.

The port's plain version (what the wrapper runs on CPU tensors) is held to
``memory_readout_pallas`` in interpret mode and to ``memory_readout_dense`` on
the shapes of ``tests/test_pallas_kernels.py``, rtol/atol 2e-4 (fp32 sums of up
to 1024 terms in another order).  The CUDA kernel itself is held to the plain
version by ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from yolo_puncture_tpu.ops.pallas.mem_attention import memory_readout_pallas
from yolo_puncture_tpu.track.network import memory_readout_dense as jax_dense
from yolo_puncture_tpu_torch.ops.kernels.memory_readout import memory_readout, memory_readout_reference

TOL = dict(rtol=2e-4, atol=2e-4)
CASES = {  # name: (Q, M, No, Cv, valid)
    "full_softmax": (256, 1024, 4, 128, "random"),
    "all_invalid": (256, 512, 2, 128, "none"),
    "ragged": (52, 300, 3, 32, "random"),
}


def _inputs(Q, M, No, Cv, valid, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Q, 64)).astype(np.float32)
    k = rng.standard_normal((M, 64)).astype(np.float32)
    v = rng.standard_normal((No, M, Cv)).astype(np.float32)
    ok = rng.uniform(size=M) > 0.3 if valid == "random" else np.zeros(M, bool)
    return q, k, v, ok


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("oracle", ["pallas_interpret", "dense"])
def test_plain_version_matches_jax(case, oracle):
    Q, M, No, Cv, valid = CASES[case]
    q, k, v, ok = _inputs(Q, M, No, Cv, valid)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ok))
    ref = np.asarray(memory_readout_pallas(*args, interpret=True) if oracle == "pallas_interpret"
                     else jax_dense(*args))
    got = memory_readout(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(ok)).numpy()
    assert got.shape == (No, Q, Cv) and got.dtype == np.float32
    assert np.isfinite(got).all()
    if valid == "none":
        assert (got == 0).all()
    np.testing.assert_allclose(got, ref, **TOL)


def test_first_valid_element_in_the_last_tile_and_bf16():
    q, k, v, _ = _inputs(70, 333, 2, 128, "none")
    ok = np.arange(333) >= 330
    ref = np.asarray(jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ok)))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = memory_readout_reference(*t, torch.from_numpy(ok))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # bf16 storage: fp32 statistics, output in the values' type, one bf16 ulp from the fp32 result
    got16 = memory_readout_reference(*(a.bfloat16() for a in t), torch.from_numpy(ok))
    assert got16.dtype == torch.bfloat16
    ref16 = memory_readout_reference(*(a.bfloat16().float() for a in t), torch.from_numpy(ok))
    assert ((got16.float() - ref16).abs() <= 2.0 ** -8 * ref16.abs().clamp_min(1.0)).all()


def test_wrapper_checks_shapes_and_types():
    q, k, v = torch.zeros(4, 64), torch.zeros(6, 64), torch.zeros(2, 6, 128)
    ok = torch.ones(6, dtype=torch.bool)
    with pytest.raises(ValueError):
        memory_readout(q, k, torch.zeros(2, 5, 128), ok)
    with pytest.raises(ValueError):
        memory_readout(torch.zeros(4, 32), k, v, ok)
    with pytest.raises(TypeError):
        memory_readout(q, k, v, ok.float())

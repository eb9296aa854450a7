"""The tracker's memory of the PyTorch port against the JAX package, exact:
``write_memory`` around the ring's wrap, ``consolidate`` with tied usage
(``jax.lax.top_k`` returns the lowest index first), ``init_memory`` and
``engaged``.  The same numpy keys, values and usage go through both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_puncture_tpu.track import memory as jm
from yolo_puncture_tpu_torch.track import memory as tm

H16, W16, NO, T, CV = 2, 3, 2, 3, 128
HW = H16 * W16


def _assert_same(t_state: tm.MemoryState, j_state: jm.MemoryState):
    for name in ("keys", "values", "valid", "usage", "lt_keys", "lt_values", "lt_valid", "active"):
        np.testing.assert_array_equal(getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)), err_msg=name)
    for name in ("write_pos", "lt_pos", "frame_idx"):
        assert getattr(t_state, name) == int(getattr(j_state, name)), name
    # the sensory state is channel-first in the port
    np.testing.assert_array_equal(t_state.sensory.permute(0, 2, 3, 1).numpy(), np.asarray(j_state.sensory))


def _states(num_prototypes=4):
    return (tm.init_memory(H16, W16, NO, T, num_prototypes=num_prototypes),
            jm.init_memory(H16, W16, NO, T, num_prototypes=num_prototypes))


def test_init_memory_and_engaged():
    ts, js = _states()
    _assert_same(ts, js)
    assert ts.keys.shape == (T, HW, 64) and ts.values.shape == (NO, T, HW, CV)
    assert tm.engaged(ts) is False and not bool(jm.engaged(js))
    tq, jq = tm.init_memory(H16, W16, NO, T, quantized=True), jm.init_memory(H16, W16, NO, T, quantized=True)
    _assert_same(tq, jq)                                     # the int8 ring is ported
    assert tq.keys.dtype == tq.values.dtype == torch.int8 and tq.lt_keys.dtype == torch.float32
    assert tq.k_scale.shape == (T,) and tq.v_scale.shape == (NO, T)


def test_write_memory_int8_ring_equals_jax_bit_for_bit():
    """The int8 ring and its scales after writes past the wrap: equal to the
    jitted JAX ``write_memory`` (as ``TrackerCore`` runs it) bit for bit, one
    object's value all zeros (its scale floored at 1e-8)."""
    import jax

    ts, js = tm.init_memory(H16, W16, NO, T, quantized=True), jm.init_memory(H16, W16, NO, T, quantized=True)
    jwrite = jax.jit(jm.write_memory)
    rng = np.random.default_rng(2)
    for i in range(T + 2):
        key = (rng.standard_normal((HW, 64)) * (i + 1)).astype(np.float32)
        val = rng.standard_normal((NO, HW, CV)).astype(np.float32)
        val[1] *= 0.0 if i == 1 else 3.0
        ts = tm.write_memory(ts, torch.from_numpy(key), torch.from_numpy(val))
        js = jwrite(js, jnp.asarray(key), jnp.asarray(val), jnp.asarray(True))
        _assert_same(ts, js)
        np.testing.assert_array_equal(ts.k_scale.numpy(), np.asarray(js.k_scale))
        np.testing.assert_array_equal(ts.v_scale.numpy(), np.asarray(js.v_scale))
    assert ts.keys.dtype == torch.int8 and int(ts.keys.abs().max()) == 127


def test_write_memory_wraps_the_ring():
    ts, js = _states()
    rng = np.random.default_rng(0)
    first = ts
    for i in range(T + 2):                                   # two writes past the wrap
        key = rng.standard_normal((HW, 64)).astype(np.float32)
        val = rng.standard_normal((NO, HW, CV)).astype(np.float32)
        ts = tm.write_memory(ts, torch.from_numpy(key), torch.from_numpy(val))
        js = jm.write_memory(js, jnp.asarray(key), jnp.asarray(val), jnp.asarray(True))
        _assert_same(ts, js)
        assert ts.write_pos == (i + 1) % T
    assert tm.engaged(ts) is True
    assert not first.valid.any() and float(first.keys.abs().sum()) == 0.0   # an earlier state is left as it was


@pytest.mark.parametrize("usage_kind", ["zeros", "tied", "distinct"])
def test_consolidate_matches_jax_with_tied_usage(usage_kind):
    ts, js = _states(num_prototypes=5)
    rng = np.random.default_rng(1)
    for _ in range(T):
        key = rng.standard_normal((HW, 64)).astype(np.float32)
        val = rng.standard_normal((NO, HW, CV)).astype(np.float32)
        ts = tm.write_memory(ts, torch.from_numpy(key), torch.from_numpy(val))
        js = jm.write_memory(js, jnp.asarray(key), jnp.asarray(val), jnp.asarray(True))
    usage = {"zeros": np.zeros((T, HW), np.float32),
             "tied": np.tile(np.float32([0.5, 2.0, 2.0, 0.5, 2.0, 0.5]), (T, 1)),
             "distinct": rng.uniform(0, 1, (T, HW)).astype(np.float32)}[usage_kind]
    ts = ts._replace(usage=torch.from_numpy(usage.copy()))
    js = js._replace(usage=jnp.asarray(usage))
    for _ in range(3):                                       # 3 × 3 prototypes into a bank of 5: the bank wraps too
        ts = tm.consolidate(ts, 3)
        js = jm.consolidate(js, 3, jnp.asarray(True))
        _assert_same(ts, js)
        key = rng.standard_normal((HW, 64)).astype(np.float32)
        val = rng.standard_normal((NO, HW, CV)).astype(np.float32)
        ts = tm.write_memory(ts, torch.from_numpy(key), torch.from_numpy(val))
        js = jm.write_memory(js, jnp.asarray(key), jnp.asarray(val), jnp.asarray(True))
        _assert_same(ts, js)
    assert ts.lt_pos == 9 % 5 and bool(ts.lt_valid.all())

"""The port's own flax-msgpack reader against ``flax.serialization.msgpack_restore``
on the shipped tracker checkpoints: the same tree, every array equal bit for bit."""

import jax
import numpy as np
import pytest
from flax import serialization

from tests.torch_parity import NEEDLE_CHECKPOINT, SHARED_CHECKPOINT, repo_path
from yolo_puncture_tpu_torch.utils.convert import (
    export_tracker_state_dict,
    load_tracker_state_dict,
    read_msgpack,
)


@pytest.mark.parametrize("rel,n_leaves", [(NEEDLE_CHECKPOINT, 149), (SHARED_CHECKPOINT, 174)])
def test_reader_matches_flax(rel, n_leaves):
    path = repo_path(rel)
    got = read_msgpack(path)
    with open(path, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(got_leaves) == n_leaves
    assert [p for p, _ in got_leaves] == [p for p, _ in ref_leaves]
    for (_, a), (_, b) in zip(got_leaves, ref_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_reader_takes_bytes_and_small_values():
    tree = {"a": {"k": np.arange(6, dtype=np.float32).reshape(2, 3)}, "n": 7, "neg": -3, "big": 70000,
            "s": "x" * 40, "flag": True, "none": None, "f": 0.5, "list": [1, 2, 3],
            "scalar": np.float32(2.5), "i8": np.arange(4, dtype=np.int8)}
    got = read_msgpack(serialization.msgpack_serialize(tree))
    assert got["n"] == 7 and got["neg"] == -3 and got["big"] == 70000 and got["s"] == "x" * 40
    assert got["flag"] is True and got["none"] is None and got["f"] == 0.5 and got["list"] == [1, 2, 3]
    assert got["scalar"] == np.float32(2.5) and got["scalar"].dtype == np.float32
    np.testing.assert_array_equal(got["a"]["k"], tree["a"]["k"])
    np.testing.assert_array_equal(got["i8"], tree["i8"])


def test_reader_refuses_truncated_and_trailing_data():
    data = serialization.msgpack_serialize({"a": np.zeros(4, np.float32)})
    with pytest.raises(ValueError):
        read_msgpack(data[:-3])
    with pytest.raises(ValueError):
        read_msgpack(data + b"\x00")


@pytest.mark.parametrize("rel,adapter", [(NEEDLE_CHECKPOINT, False), (SHARED_CHECKPOINT, True)])
def test_checkpoints_load_into_the_port(rel, adapter):
    from yolo_puncture_tpu_torch.track.network import PropagationNetwork

    variables = read_msgpack(repo_path(rel))
    sd = export_tracker_state_dict(variables)
    net = PropagationNetwork(with_pyramid_adapter=adapter)
    load_tracker_state_dict(net, sd)
    w = variables["params"]["decoder"]["dec8"]["conv"]["kernel"]              # HWIO
    np.testing.assert_array_equal(net.decoder.dec8.conv.weight.detach().numpy(), w.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(net.key_encoder.stem.bn.running_var.numpy(),
                                  variables["batch_stats"]["key_encoder"]["stem"]["bn"]["var"])
    if not adapter:                                                          # a network with an adapter misses its weights
        with pytest.raises(ValueError):
            load_tracker_state_dict(PropagationNetwork(with_pyramid_adapter=True), sd)


def test_detector_loads_flax_msgpack_weights(tmp_path):
    """``YOLO("….msgpack")``: the JAX package's detector variables, written by
    flax, load through the port's reader and the weight bridge."""
    import jax.numpy as jnp
    import torch

    from tests.torch_parity import port_model_from_jax, seeded_jax_variables
    from yolo_puncture_tpu.models.yolo import YOLOModel as JaxYOLOModel
    from yolo_puncture_tpu_torch.predict.predictor import YOLO

    variables = seeded_jax_variables(JaxYOLOModel(version="v10", scale="n", nc=1, task="segment"),
                                     jnp.zeros((1, 64, 64, 3)), seed=2)
    path = tmp_path / "yolo10n-seg.msgpack"
    path.write_bytes(serialization.msgpack_serialize(jax.tree_util.tree_map(np.asarray, variables)))
    det = YOLO(str(path), nc=1, device="cpu")
    ref = port_model_from_jax("v10", "n", 1, "segment", variables).state_dict()
    got = det.model.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k

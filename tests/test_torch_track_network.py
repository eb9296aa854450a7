"""The tracker's propagation network of the PyTorch port against the JAX package:
each module with the same seeded weights and numpy inputs (atol 1e-4: fp32
convolutions summed in another order through up to eight layers), the readout
functions, the packed decode-tail algebra and soft aggregation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from tests.torch_parity import port_tracker_network, seeded_tracker_variables, to_nchw, to_nhwc
from yolo_puncture_tpu.track import network as jn
from yolo_puncture_tpu_torch.track import network as tn

ATOL = 1e-4
H, W = 32, 64
H16, W16 = H // 16, W // 16
NO = 3


@pytest.fixture(scope="module")
def nets():
    variables = seeded_tracker_variables(seed=1, image_hw=(H, W), with_pyramid_adapter=True)
    return variables, jn.PropagationNetwork(with_pyramid_adapter=True), \
        port_tracker_network(variables, with_pyramid_adapter=True)


def _apply(net, variables, method, *args, **kw):
    return jax.jit(lambda v, *a: net.apply(v, *a, method=method, **kw))(variables, *map(jnp.asarray, args))


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_space_to_depth():
    x = _rng().standard_normal((2, 16, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(to_nhwc(tn.space_to_depth(to_nchw(x), 4)), np.asarray(jn.space_to_depth(jnp.asarray(x), 4)))


def test_key_encoder(nets):
    variables, jnet, tnet = nets
    img = _rng(1).uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    key, skips = _apply(jnet, variables, jn.PropagationNetwork.encode_key, img)
    with torch.no_grad():
        tkey, tskips = tnet.encode_key(to_nchw(img))
    assert tuple(tkey.shape) == (2, tn.KEY_DIM, H16, W16)
    np.testing.assert_allclose(to_nhwc(tkey), np.asarray(key), rtol=0, atol=ATOL)
    for name in ("f4", "f8", "f16"):
        np.testing.assert_allclose(to_nhwc(tskips[name]), np.asarray(skips[name]), rtol=0, atol=ATOL)


@pytest.mark.parametrize("window", [None, ((0.125, 0.875), (0.0, 1.0))])
def test_resize_bilinear(window):
    x = _rng(2).standard_normal((2, 5, 9, 4)).astype(np.float32)
    ref = np.asarray(jn.resize_bilinear_nhwc(jnp.asarray(x), 8, 12, window))
    np.testing.assert_allclose(to_nhwc(tn.resize_bilinear(to_nchw(x), 8, 12, window)), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("content_box", [None, ((0.125, 0.875), (0.0, 1.0))])
def test_pyramid_adapter(nets, content_box):
    variables, jnet, tnet = nets
    rng = _rng(3)
    p3 = rng.standard_normal((2, 8, 8, 128)).astype(np.float32)
    p4 = rng.standard_normal((2, 4, 4, 256)).astype(np.float32)
    p5 = rng.standard_normal((2, 2, 2, 512)).astype(np.float32)
    key, skips = jax.jit(lambda v, a, b, c: jnet.apply(
        v, a, b, c, (H16, W16), method=jn.PropagationNetwork.encode_from_pyramid, content_box=content_box
    ))(variables, p3, p4, p5)
    with torch.no_grad():
        tkey, tskips = tnet.encode_from_pyramid(to_nchw(p3), to_nchw(p4), to_nchw(p5), (H16, W16), content_box)
    np.testing.assert_allclose(to_nhwc(tkey), np.asarray(key), rtol=0, atol=ATOL)
    for name in ("f4", "f8", "f16"):
        np.testing.assert_allclose(to_nhwc(tskips[name]), np.asarray(skips[name]), rtol=0, atol=ATOL)


def _object_inputs(seed):
    rng = _rng(seed)
    return (rng.standard_normal((H16, W16, 256)).astype(np.float32),
            rng.uniform(0, 1, (NO, H16, W16, 1)).astype(np.float32),
            rng.standard_normal((NO, H16, W16, tn.SENSORY_DIM)).astype(np.float32),
            rng.standard_normal((NO, H16, W16, tn.VALUE_DIM)).astype(np.float32))


def test_value_encoder(nets):
    variables, jnet, tnet = nets
    f16, mask, sensory, _ = _object_inputs(4)
    ref = _apply(jnet, variables, jn.PropagationNetwork.encode_value, f16, mask, sensory)
    with torch.no_grad():
        got = tnet.encode_value(to_nchw(f16), to_nchw(mask), to_nchw(sensory))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), rtol=0, atol=ATOL)


def test_sensory_updater(nets):
    variables, jnet, tnet = nets
    _, _, sensory, _ = _object_inputs(5)
    feat = _rng(6).standard_normal((NO, H16, W16, 128)).astype(np.float32)
    ref = _apply(jnet, variables, jn.PropagationNetwork.update_sensory, sensory, feat)
    with torch.no_grad():
        got = tnet.update_sensory(to_nchw(sensory), to_nchw(feat))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), rtol=0, atol=ATOL)


def test_decoder_head_and_skips(nets):
    variables, jnet, tnet = nets
    _, _, sensory, readout = _object_inputs(7)
    hidden, logits16 = _apply(jnet, variables, jn.PropagationNetwork.decode_head, readout, sensory)
    with torch.no_grad():
        thidden, tlogits16 = tnet.decode_head(to_nchw(readout), to_nchw(sensory))
    np.testing.assert_allclose(to_nhwc(thidden), np.asarray(hidden), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tlogits16.numpy(), np.asarray(logits16), rtol=0, atol=ATOL)
    rng = _rng(8)
    skips = {"f8": rng.standard_normal((2, 2 * H16, 2 * W16, 256)).astype(np.float32),
             "f4": rng.standard_normal((2, 4 * H16, 4 * W16, 128)).astype(np.float32)}
    ref = jax.jit(lambda v, s: jnet.apply(v, s, method=jn.PropagationNetwork.project_skips))(variables, skips)
    with torch.no_grad():
        got = tnet.project_skips({k: to_nchw(v) for k, v in skips.items()})
    for name in ("f8p", "f4p"):
        np.testing.assert_allclose(to_nhwc(got[name]), np.asarray(ref[name]), rtol=0, atol=ATOL)


@pytest.mark.parametrize("full_res", [True, False])
@pytest.mark.parametrize("projected", [False, True])
def test_decoder_whole(nets, full_res, projected):
    """MaskDecoder.__call__: head, the fused tail (the port) against the exact
    tail (JAX), and the ×4 upsample of the logits."""
    variables, jnet, tnet = nets
    _, _, sensory, readout = _object_inputs(9)
    rng = _rng(10)
    skips = {"f8": rng.standard_normal((2 * H16, 2 * W16, 256)).astype(np.float32),
             "f4": rng.standard_normal((4 * H16, 4 * W16, 128)).astype(np.float32)}
    tskips = {k: to_nchw(v) for k, v in skips.items()}
    if projected:
        skips = jax.jit(lambda v, s: jnet.apply(v, s, method=jn.PropagationNetwork.project_skips))(
            variables, {k: v[None] for k, v in skips.items()})
        skips = {k: np.asarray(v[0]) for k, v in skips.items()}
        tskips = {k: to_nchw(v) for k, v in skips.items()}
    ref = jax.jit(lambda v, r, s, h: jnet.apply(v, r, s, h, method=jn.PropagationNetwork.decode,
                                                full_res=full_res))(variables, readout, skips, sensory)
    with torch.no_grad():
        got = tnet.decode(to_nchw(readout), tskips, to_nchw(sensory), full_res=full_res)
    side = (4 * H16, 4 * W16) if not full_res else (H, W)
    assert tuple(got[0].shape) == (NO, *side)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(to_nhwc(got[1]), np.asarray(ref[1]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=0, atol=ATOL)


def _readout_inputs(seed, Q=40, M=96, No=3, Cv=16):
    rng = _rng(seed)
    return (rng.standard_normal((Q, 64)).astype(np.float32), rng.standard_normal((M, 64)).astype(np.float32),
            rng.standard_normal((No, M, Cv)).astype(np.float32), rng.uniform(size=M) > 0.3)


def test_memory_readout_topk():
    q, k, v, ok = _readout_inputs(11)
    ref = np.asarray(jn.memory_readout(*map(jnp.asarray, (q, k, v, ok)), top_k=30))
    got = tn.memory_readout(*map(torch.from_numpy, (q, k, v, ok)), top_k=30).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("affinity_bf16", [False, True])
@pytest.mark.parametrize("return_usage", [False, True])
@pytest.mark.parametrize("all_invalid", [False, True])
def test_memory_readout_dense(affinity_bf16, return_usage, all_invalid):
    q, k, v, ok = _readout_inputs(12)
    if all_invalid:
        ok = np.zeros_like(ok)
    ref = jn.memory_readout_dense(*map(jnp.asarray, (q, k, v, ok)), return_usage=return_usage,
                                  affinity_bf16=affinity_bf16)
    got = tn.memory_readout_dense(*map(torch.from_numpy, (q, k, v, ok)), return_usage=return_usage,
                                  affinity_bf16=affinity_bf16)
    # a bf16 affinity is rounded from fp32 sums that differ in the last bit: one bf16 ulp of a
    # logit of a few units moves a weight by about 1 %
    atol = 5e-2 if affinity_bf16 else 1e-5
    if return_usage:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0, atol=atol)
        got, ref = got[0], ref[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol)
    if all_invalid:
        assert (got.numpy() == 0).all()


def _int8_ring(seed, T, HW, No, Cv, Q, valid):
    """``tests/test_track.py``'s int8 readout inputs: a ring quantised per slot
    (keys) and per (object, slot) (values), a query and the slots' validity."""
    rng = _rng(seed)
    keys = rng.normal(size=(T, HW, 64)).astype(np.float32)
    vals = rng.normal(size=(No, T, HW, Cv)).astype(np.float32)
    q = rng.normal(size=(Q, 64)).astype(np.float32)
    ks = (np.abs(keys).max(axis=(1, 2)) / 127.0).astype(np.float32)
    ki8 = np.clip(np.round(keys / np.maximum(ks, 1e-8)[:, None, None]), -127, 127).astype(np.int8)
    vs = (np.abs(vals).max(axis=(2, 3)) / 127.0).astype(np.float32)
    vi8 = np.clip(np.round(vals / np.maximum(vs, 1e-8)[:, :, None, None]), -127, 127).astype(np.int8)
    return q, ki8, ks, vi8, vs, np.asarray(valid)


@pytest.mark.parametrize("shape", [(3, 24, 2, 32, 24, (True, True, False)), (4, 405, 2, 128, 405, (True,) * 3 + (False,)),
                                   (2, 405, 1, 128, 16, (False, False))],
                         ids=["test_track", "quality_hw405", "all_invalid"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_memory_readout_dense_int8(shape, out_dtype, monkeypatch):
    """Against the jitted JAX ``memory_readout_dense_int8``: the int32 parts (the
    affinity product and each slot's value product) exactly, the readout and the
    usage within 1e-6 of their largest values."""
    from yolo_puncture_tpu_torch.nn import quant

    T, HW, No, Cv, Q, valid = shape
    args = _int8_ring(14, T, HW, No, Cv, Q, valid)
    jdt, tdt = (jnp.float32, torch.float32) if out_dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    products = []
    real = quant.int_mm

    def spy(a, b):
        y = real(a, b)
        products.append((a, b, y))
        return y

    monkeypatch.setattr(tn, "int_mm", spy)
    got, got_usage = tn.memory_readout_dense_int8(*map(torch.from_numpy, args), out_dtype=tdt, return_usage=True)
    ref, ref_usage = jax.jit(jn.memory_readout_dense_int8, static_argnames=("out_dtype", "return_usage"))(
        *map(jnp.asarray, args), out_dtype=jdt, return_usage=True)
    assert got.dtype == tdt and got.shape == (No, Q, Cv) and got_usage.shape == (T, HW)
    # the int32 parts, from the JAX function's own int8 operands
    q, ki8 = args[0], args[1]
    (a, b, aff), *values = products
    sq = np.float32(max(np.abs(q).max(), 1e-8)) * np.float32(quant.RCP127)
    qi8 = np.clip(np.round(q / sq), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(a.numpy(), qi8)
    np.testing.assert_array_equal(aff.numpy(), np.asarray(jnp.einsum(
        "qc,thc->qth", qi8, args[1], preferred_element_type=jnp.int32)).reshape(Q, T * HW))
    assert len(values) == T
    for t, (pi8, _, out_t) in enumerate(values):
        ref_t = np.einsum("qh,nhc->qnc", pi8.numpy().astype(np.int64), args[3][:, t].astype(np.int64))
        np.testing.assert_array_equal(out_t.numpy(), ref_t.reshape(Q, No * Cv))
    g, r = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    tol = 1e-6 if out_dtype == "float32" else 2.0 ** -8
    assert np.abs(g - r).max() <= tol * max(np.abs(r).max(), 1e-30)
    gu, ru = got_usage.numpy(), np.asarray(ref_usage)
    assert np.abs(gu - ru).max() <= 1e-6 * max(np.abs(ru).max(), 1e-30)
    if not any(valid):
        assert (g == 0).all() and (gu == 0).all()


def test_depth_to_space2():
    y = _rng(13).standard_normal((2, 3, 5, 4 * 6)).astype(np.float32)
    np.testing.assert_array_equal(tn._depth_to_space2(torch.from_numpy(y), 6).numpy(),
                                  np.asarray(jn._depth_to_space2(jnp.asarray(y), 6)))


@pytest.mark.parametrize("active", [(1, 1, 1), (1, 0, 1), (0, 0, 0)])
def test_soft_aggregate(active):
    logits = (4 * _rng(14).standard_normal((3, 8, 12))).astype(np.float32)
    logits[0, 0, :4] = [40.0, -40.0, 0.0, 17.0]   # saturated sigmoids meet the eps terms
    act = np.asarray(active, np.float32)
    ref = np.asarray(jn.soft_aggregate(jnp.asarray(logits), jnp.asarray(act)))
    got = tn.soft_aggregate(torch.from_numpy(logits), torch.from_numpy(act)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    batched = tn.soft_aggregate(torch.from_numpy(np.stack([logits, -logits])), torch.from_numpy(act)).numpy()
    np.testing.assert_allclose(batched[0], ref, rtol=0, atol=1e-6)

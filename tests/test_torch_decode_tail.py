"""Decode tail of the PyTorch port against the JAX package.

The port's plain version (what the wrapper runs on CPU tensors: the packed
algebra with ``F.conv2d``) is held to ``decode_tail_pallas`` in interpret mode,
to the exact un-packed ``MaskDecoder.decode_tail`` and to ``decode_tail_subpix``,
on the same numpy inputs and weights, rtol/atol 2e-4 (the packing sums taps
before the products, and fp32 sums of up to 1152 terms come in another order).
The CUDA kernel itself is held to the plain version by ``tests/test_torch_gpu.py``.
"""

import functools

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
    got = decode_tail(params, torch.from_numpy(hidden), torch.from_numpy(f8p), torch.from_numpy(f4p)).detach().numpy()
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


# -- what the host prepares for the tensor-core kernel --------------------------------------------

from yolo_puncture_tpu_torch.ops.kernels import decode_tail as dt  # noqa: E402


def unpack_weight_tiles(tiles: torch.Tensor) -> torch.Tensor:
    """Inverse of ``wgmma_weight_tiles`` up to the planes: (4, chunks, 4, planes,
    64, KC) → (planes, 4 groups, 4 taps, Cin, 64) in the channels' own order."""
    t = dt._swizzle_128(tiles)
    g, chunks, taps, planes, n, kc = t.shape
    k_inv = torch.argsort(dt.tile_k_order(tiles.dtype))
    n_inv = torch.argsort(dt.tile_n_order())
    t = t[..., n_inv, :][..., k_inv]                      # rows and slots back in channel order
    return t.permute(3, 0, 2, 1, 5, 4).reshape(planes, g, taps, chunks * kc, n)


def _tf32_bits_clear(x: torch.Tensor) -> bool:
    """At most 10 explicit mantissa bits: the low 13 of the fp32 mantissa are 0."""
    return bool(((x.contiguous().view(torch.int32) & 0x1FFF) == 0).all())


@pytest.mark.parametrize("which", ["w8", "w4"])
def test_tf32_planes_reassemble_exactly(setup, which):
    """hi + lo is the fp32 weight bit for bit, hi is a TF32 number, lo is what is left."""
    _, net, *_ = setup
    w = getattr(net.decoder.tail_params(torch.float32), which)
    hi, lo = dt.split_tf32(w)
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal(hi + lo, w)
    assert _tf32_bits_clear(hi)
    assert bool((lo.abs() <= w.abs() * 2.0 ** -11).all())          # half a TF32 ulp, ties away from zero
    planes = unpack_weight_tiles(getattr(net.decoder.tail_params(torch.float32), "t" + which[1]))
    assert _tf32_bits_clear(planes[0])
    assert torch.equal(planes[0] + planes[1], dt.live_taps(w))


@pytest.mark.parametrize("which", ["w8", "w4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_tiles_unpack_to_the_live_taps(setup, which, dtype):
    """The per-(group, tap) tiles, un-swizzled and put back in channel order, are the
    packed kernel's live taps; the five taps a group drops are exactly zero."""
    _, net, *_ = setup
    params = net.decoder.tail_params(dtype)
    w, tiles = getattr(params, which), getattr(params, "t" + which[1])
    cin = w.shape[2]
    kc, planes = (32, 2) if dtype == torch.float32 else (64, 1)
    assert tiles.dtype == dtype and tiles.is_contiguous()
    assert tuple(tiles.shape) == (4, cin // kc, 4, planes, 64, kc)
    assert tiles.shape[-1] * tiles.element_size() == dt.TILE_ROW_BYTES
    back = unpack_weight_tiles(tiles).float().sum(0)             # (4 groups, 4 taps, Cin, 64)
    assert torch.equal(back, dt.live_taps(w))
    rebuilt = torch.zeros_like(w)
    for g in range(4):
        for t in range(4):
            rebuilt[(g >> 1) + (t >> 1), (g & 1) + (t & 1), :, g * 64:(g + 1) * 64] = back[g, t]
    assert torch.equal(rebuilt, w)                                  # nothing outside the live taps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_orders_give_a_thread_contiguous_fragments(dtype):
    """k slots: quad lane c's slots of the four k-steps are the channels of the 32
    bytes it loads, in order.  Rows: its 16 accumulator columns are channels 16c … 16c+15."""
    k = dt.tile_k_order(dtype)
    per = 8 if dtype == torch.float32 else 16                       # channels in 32 bytes
    steps = k.reshape(4, -1)
    assert sorted(k.tolist()) == list(range(len(k)))
    for c in range(4):
        if dtype == torch.float32:                                  # slots c and c + 4 of each k-step
            mine = torch.stack([steps[:, c], steps[:, c + 4]], 1).reshape(-1)
        else:                                                       # slots 2c, 2c+1, 2c+8, 2c+9
            mine = torch.stack([steps[:, 2 * c], steps[:, 2 * c + 1], steps[:, 2 * c + 8], steps[:, 2 * c + 9]],
                               1).reshape(-1)
        assert mine.tolist() == list(range(per * c, per * (c + 1)))
    n = dt.tile_n_order()
    assert sorted(n.tolist()) == list(range(64))
    for c in range(4):
        cols = [8 * j + 2 * c + e for j in range(8) for e in range(2)]
        assert n[cols].tolist() == list(range(16 * c, 16 * c + 16))


def test_swizzle_is_the_128_byte_xor():
    x = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    s = dt._swizzle_128(x)
    assert torch.equal(dt._swizzle_128(s), x)
    for n, piece in ((0, 3), (5, 0), (13, 7), (63, 2)):
        assert torch.equal(s[n, 4 * (piece ^ (n % 8)):4 * (piece ^ (n % 8)) + 4], x[n, 4 * piece:4 * piece + 4])


def _tail_on_tf32(params, hidden, f8p, f4p, products: int) -> torch.Tensor:
    """The fp32 tail with each convolution taken as the tensor cores take it: operands
    split with ``split_tf32``, the low parts cut to TF32 as the hardware cuts them,
    ``products`` = 3: lo·hi + hi·lo + hi·hi; 1: hi·hi alone.  Sums in float64."""
    import torch.nn.functional as F

    def cut(x):
        return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)

    def conv(x, w):
        (xh, xl), (wh, wl) = dt.split_tf32(x), dt.split_tf32(w)
        pairs = [(xh, wh)] if products == 1 else [(cut(xl), wh), (xh, cut(wl)), (xh, wh)]
        y = sum(F.conv2d(a.double().permute(0, 3, 1, 2), b.double().permute(3, 2, 0, 1), padding=1) for a, b in pairs)
        return y.permute(0, 2, 3, 1).float()

    N, No, H16, W16, Cin = hidden.shape
    x = hidden.reshape(N * No, H16, W16, Cin)
    y8 = dt.depth_to_space2(F.silu(conv(x, params.w8) * params.a8[0] + params.a8[1]), 64)
    y8 = (y8.reshape(N, No, 2 * H16, 2 * W16, 64) + f8p[:, None]).reshape(N * No, 2 * H16, 2 * W16, 64)
    y4 = F.silu(conv(y8, params.w4) * params.a4[0] + params.a4[1])
    o = torch.einsum("bhwgc,c->bhwg", y4.reshape(*y4.shape[:-1], 4, 64), params.w_out)
    return dt.depth_to_space2(o, 1).reshape(N, No, 4 * H16, 4 * W16) + dt.skip_plane(params, f4p)[:, None]


@pytest.mark.parametrize("products", [3, 1])
def test_three_tf32_products_are_fp32_class_and_one_is_not(setup, products):
    """Three error-compensated TF32 products stay within the 2e-4 the kernel is held to
    on the card; a single TF32 product (the low planes dropped) does not."""
    _, net, hidden, f8p, f4p = setup
    params = net.decoder.tail_params(torch.float32)
    h, f8, f4 = torch.from_numpy(hidden), torch.from_numpy(f8p), torch.from_numpy(f4p)
    err = float((_tail_on_tf32(params, h, f8, f4, products) - decode_tail_reference(params, h, f8, f4)).abs().max())
    assert (err <= 2e-4) == (products == 3), err


# -- gradients (training) -----------------------------------------------------------------
GRAD_REL = 1e-5   # per tensor, ‖g_port − g_jax‖ / ‖g_jax‖, fp32
TAIL_RAW = {  # the port's parameter → the JAX decoder's
    "dec8.conv.weight": ("dec8", "conv", "kernel"), "dec8.bn.weight": ("dec8", "bn", "scale"),
    "dec8.bn.bias": ("dec8", "bn", "bias"), "dec4.conv.weight": ("dec4", "conv", "kernel"),
    "dec4.bn.weight": ("dec4", "bn", "scale"), "dec4.bn.bias": ("dec4", "bn", "bias"),
    "out.weight": ("out", "kernel"), "out.bias": ("out", "bias"),
}


@pytest.mark.parametrize("n", [1, 3])
def test_gradients_match_jax_grad_of_the_unpacked_tail(n):
    """The repair: through ``MaskDecoder.decode_tail`` every raw tail weight and the
    three activations get ``jax.grad`` of ``PropagationNetwork.decode_tail`` (before,
    the packed weights were made under ``no_grad`` from detached tensors and the
    weights' gradients stayed None).  The training shape: hidden 16×16 → 64×64
    logits, 4 objects, ``n`` frames."""
    variables = seeded_tracker_variables(seed=6, image_hw=(64, 64))
    net = port_tracker_network(variables)
    rng = np.random.default_rng(9)
    hidden = rng.standard_normal((n, 4, 16, 16, 128)).astype(np.float32)
    f8p = rng.standard_normal((n, 32, 32, 64)).astype(np.float32)
    f4p = rng.standard_normal((n, 64, 64, 64)).astype(np.float32)
    d_out = rng.standard_normal((n, 4, 64, 64)).astype(np.float32)

    jnet = JaxNet()

    def loss(params, h, f8, f4):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        out = jax.vmap(lambda a, b, c: jnet.apply(v, a, b, c, method=JaxNet.decode_tail))(h, f8, f4)
        return (out * d_out).sum()

    g_params, gh, g8, g4 = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        variables["params"], jnp.asarray(hidden), jnp.asarray(f8p), jnp.asarray(f4p))

    th, t8, t4 = (to_nchw(a).requires_grad_() for a in (hidden, f8p, f4p))
    out = net.decoder.decode_tail(th, t8, t4)
    assert out.grad_fn is not None
    (out * torch.from_numpy(d_out)).sum().backward()

    def rel(got, ref):
        return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))

    for name, got, ref in (("hidden", th.grad, gh), ("f8p", t8.grad, g8), ("f4p", t4.grad, g4)):
        got = np.moveaxis(got.numpy(), -3, -1)
        assert rel(got, np.asarray(ref)) <= GRAD_REL, (name, rel(got, np.asarray(ref)))
    dec = dict(net.decoder.named_parameters())
    for name, path in TAIL_RAW.items():
        ref = np.asarray(functools.reduce(lambda t, k: t[k], path, g_params["decoder"]))
        if path[-1] == "kernel":
            ref = ref.transpose(3, 2, 0, 1)
        assert dec[name].grad is not None, name
        assert rel(dec[name].grad.numpy(), ref) <= GRAD_REL, (name, rel(dec[name].grad.numpy(), ref))
    assert net.decoder.dec8.bn.running_var.grad is None


def test_gradient_path_keeps_the_forward_and_refuses_bf16(setup):
    """The gradient path gives the forward of the path without one, in fp32 and
    in bf16 (bf16 training); a type the Function does not take (fp16) raises."""
    _, net, hidden, f8p, f4p = setup
    args = (torch.from_numpy(hidden), torch.from_numpy(f8p), torch.from_numpy(f4p))
    for dtype in (torch.float32, torch.bfloat16):
        params = net.decoder.tail_params(dtype)
        typed = (args[0].to(dtype), args[1].to(dtype), args[2])
        with torch.no_grad():
            plain = decode_tail(params, *typed)
        out = decode_tail(params, typed[0].clone().requires_grad_(), *typed[1:])
        assert out.grad_fn is not None and torch.equal(out.detach(), plain)
    p16 = net.decoder.tail_params(torch.float16)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        decode_tail(p16, args[0].half().requires_grad_(), args[1].half(), args[2])

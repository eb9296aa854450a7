"""bf16 training of the PyTorch port against the JAX package's.

The JAX package trains a bf16 model (``dtype=bfloat16``) on fp32 parameters: flax
rounds them to bf16 at each use, and the gradients, the optimizer and its state
are fp32.  The port trains the same way on fp32 master weights
(``nn/common.py MasterWeights``).  Here the same seeded weights and inputs go
through four runs: the JAX package in fp32 and in bf16 (jitted: XLA's CPU
backend rounds bf16 otherwise op by op), the port in bf16 and in fp32.  This
file: the backward of the tracker's two kernels (their plain versions on the
CPU, the ``autograd.Function``s' bf16 backward) and one ``PropagationTrainer``
step in its three modes; ``test_torch_bf16_train_detector.py`` the detector's
``Trainer``; ``test_torch_bf16_train_finetune.py`` the fine-tuners and
``UNetPredictor(dtype=bfloat16)``.

Two rules hold each quantity, as ``tests/test_torch_bf16.py`` holds serving
(``d`` is the mean absolute difference, over a tensor or over a whole tree):

  * ``RULE``: d(port bf16, JAX fp32) ≤ 1.5 · d(JAX bf16, JAX fp32) + a floor,
    so that a wrong rounding cannot hide in a tolerance;
  * ``RAN``: d(port bf16, port fp32) ≥ 0.5 · d(JAX bf16, JAX fp32) over the
    gradients, so that a run that quietly fell back to fp32 fails.

The floors, per tensor, as a share of the whole tree's mean magnitude: a tensor
whose gradient nearly vanishes (the stride-16 head of the tracker's decoder, a
BatchNorm bias before a train-mode BatchNorm) carries rounding of the rest of
the network that bf16 on either side hardly moves.  After a step every
trainable parameter, every optimizer buffer and every EMA leaf must be fp32 and
the model's bf16 weights its masters rounded (the masters' lost bits would put
the parameters after the step about ten times the JAX bf16 distance off).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from tests.torch_parity import seeded_jax_variables, seeded_tracker_variables
from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from yolo_puncture_tpu_torch.nn.common import MasterWeights, to_compute_dtype
from yolo_puncture_tpu_torch.ops.kernels.decode_tail import pack_decode_tail_params
from yolo_puncture_tpu_torch.ops.kernels.memory_readout import memory_readout
from yolo_puncture_tpu_torch.track import train as pt
from yolo_puncture_tpu_torch.track.core import TrackerCore
from yolo_puncture_tpu_torch.utils.convert import export_tracker_state_dict

BF16 = torch.bfloat16
RULE, RAN = 1.5, 0.5
# a single tensor of a tree scatters about the tree's ratio: each is held to twice the JAX distance (two
# roundings of one network differ by about √2 of one, tests/test_torch_bf16.py DIRECT), the tree to RULE
PER_TENSOR_RULE = 2.0
# the readout's backward follows JAX's autodiff op for op: the port within this share
# of the JAX bf16 distance of the JAX bf16 gradients (measured below 1e-3)
READOUT_DIRECT = 0.05
GRAD_FLOOR = 1e-5    # per gradient tensor, of the tree's mean |g| (tracker: measured 1.04e-6 over the rule)
# per gradient tensor, of its own mean |g|: one bf16 rounding (at most 2^-8 of a value).  A bf16
# parameter's gradient is a bf16 value in the port, as flax's bf16 Conv and Dense give it for their
# bias; where XLA sums a small tensor's gradient in fp32 (the head's bias that decode_tail_subpix adds
# in fp32, a side output's bias of U2NETP), the JAX bf16 gradient is nearly exact
BF16_ROUND = 2.0 ** -8
# the smallest tensor held alone: the mean of a few differences is a draw, not a measurement (a
# 2-class head's bias, a BatchNorm's 16 scales); smaller tensors count in their tree's RULE
PER_TENSOR_MIN = 256
ADAM_TOL = 1e-4      # the port's Adam step against optax.adam's on the same fp32 gradient, of lr
H, W, NO, T = 32, 48, 2, 4
CORE = dict(image_size=(H, W), max_objects=NO, mem_frames=4, mem_every=1, enable_long_term=False)
LR = 3e-4


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _d(a, b) -> float:
    return float(np.abs(_f32(a) - _f32(b)).mean())


def _hold(name, port16, jax16, jax32, floor=0.0, rule=RULE):
    gap, port = _d(jax16, jax32), _d(port16, jax32)
    assert port <= rule * gap + floor, (name, port, gap, floor)
    return gap


def _hold_tree(what, port16, jax16, jax32, port32, floor_rel):
    """Each tensor of at least PER_TENSOR_MIN elements by PER_TENSOR_RULE with a
    floor of BF16_ROUND of its own mean magnitude plus ``floor_rel`` of the
    tree's, the whole tree by RULE, and the port's bf16 run RAN away from its
    fp32 run."""
    assert sorted(port16) == sorted(jax32), what
    scale = np.mean(np.concatenate([np.abs(_f32(v)).ravel() for v in jax32.values()]))
    gap = port = ran = 0.0
    for k in jax32:
        n = np.size(_f32(jax32[k]))
        if n >= PER_TENSOR_MIN:
            _hold((what, k), port16[k], jax16[k], jax32[k],
                  BF16_ROUND * np.abs(_f32(jax32[k])).mean() + floor_rel * scale, PER_TENSOR_RULE)
        gap += _d(jax16[k], jax32[k]) * n
        port += _d(port16[k], jax32[k]) * n
        ran += _d(port16[k], port32[k]) * n
    print(f"{what}: JAX bf16 vs fp32 {gap:.4g}, port bf16 vs JAX fp32 {port / gap:.3f}x, "
          f"port bf16 vs port fp32 {ran / gap:.3f}x (sums over the tree)")
    assert port <= RULE * gap and ran >= RAN * gap, what


def assert_fp32_training_state(module, masters, opt, ema=None):
    """Fault 1: after a bf16 step every trainable parameter (master), optimizer
    buffer and EMA leaf is fp32, and the module's bf16 weights are the masters
    rounded."""
    live = dict(module.named_parameters())
    assert any(live[n].dtype == BF16 for n in masters), "the module does not compute in bf16"
    for n, m in masters.items():
        assert m.dtype == torch.float32, n
        assert torch.equal(live[n].detach(), m.detach().to(live[n].dtype)), n
    for p, st in opt.state.items():
        for k, v in st.items():
            if isinstance(v, torch.Tensor) and v.numel() > 1:
                assert v.dtype == torch.float32, k
    for n, v in (ema or {}).items():
        assert v.dtype == torch.float32, n
    for n, b in module.named_buffers():
        if n.endswith(("running_mean", "running_var")):
            assert b.dtype == torch.float32, n


# ---------------------------------------------------------------------------
# the kernels' backward
# ---------------------------------------------------------------------------


def _readout_case(seed):
    rng = np.random.default_rng(seed)
    Q, M, No = 256, 1032, 4                        # the tracker trainer's readout at 256² (ring of 4 × 256 + 8)
    q = rng.standard_normal((Q, 64)).astype(np.float32)
    k = rng.standard_normal((M, 64)).astype(np.float32)
    v = rng.standard_normal((No, M, 128)).astype(np.float32)
    ok = np.arange(M) < 768
    return q, k, v, ok, rng.standard_normal((No, Q, 128)).astype(np.float32)


@pytest.mark.parametrize("affinity_bf16", [False, True])
def test_readout_bf16_backward_matches_jax_grad(affinity_bf16):
    """``MemoryReadout``'s bf16 backward against ``jax.vjp`` of the dense readout
    on bf16 inputs (``track/network.py memory_readout_dense``): dq, dk, dv by
    RULE and within READOUT_DIRECT of JAX's own bf16 gradients, RAN from fp32."""
    from yolo_puncture_tpu.track.network import memory_readout_dense

    q, k, v, ok, d_out = _readout_case(40 + affinity_bf16)

    def jax_grads(dt):
        def f(q, k, v):
            return memory_readout_dense(q, k, v, jnp.asarray(ok), affinity_bf16=affinity_bf16)

        def g(q, k, v, d):
            out, vjp = jax.vjp(f, q, k, v)
            return vjp(d.astype(out.dtype))

        return jax.jit(g)(*(jnp.asarray(a).astype(dt) for a in (q, k, v)), jnp.asarray(d_out))

    def port_grads(dtype):
        t = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
        out = memory_readout(*t, torch.from_numpy(ok), affinity_bf16=affinity_bf16)
        assert out.grad_fn is not None and out.dtype == dtype
        out.backward(torch.from_numpy(d_out).to(dtype))
        assert all(x.grad.dtype == dtype for x in t)
        return [x.grad for x in t]

    j32, j16 = jax_grads(jnp.float32), jax_grads(jnp.bfloat16)
    p16, p32 = port_grads(BF16), port_grads(torch.float32)
    for name, a, b, c, e in zip("qkv", p16, j16, j32, p32):
        gap = _hold(f"d{name}", a, b, c)
        assert _d(a, b) <= READOUT_DIRECT * gap, (name, _d(a, b), gap)
        assert _d(a, e) >= RAN * gap, name


@pytest.mark.parametrize("wanted", [(True, False, False), (False, False, True), (False, True, True)])
def test_readout_bf16_backward_gives_only_the_gradients_asked_for(wanted):
    """With only some of q, k, v requiring a gradient, the bf16 backward gives
    those, equal to the ones it gives when all three are asked for, and leaves
    the others without one, as the fp32 backward does."""
    q, k, v, ok, d_out = _readout_case(42)

    def grads(req):
        t = [torch.from_numpy(a).to(BF16).requires_grad_(r) for a, r in zip((q, k, v), req)]
        memory_readout(*t, torch.from_numpy(ok)).backward(torch.from_numpy(d_out).to(BF16))
        return [x.grad for x in t]

    full = grads((True, True, True))
    for w, g, f in zip(wanted, grads(wanted), full):
        assert (g is None) if not w else torch.equal(g, f)


def _tail_grads(net, dtype, hidden, f8p, f4p, d_out):
    """Gradients of ``MaskDecoder.decode_tail`` on a network cast to ``dtype``:
    the activations' (channels last, as given) and the raw weights' (those of
    their fp32 masters)."""
    to_compute_dtype(net, dtype)
    weights = MasterWeights(net.decoder)
    x = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (hidden, f8p, f4p)]
    out = net.decoder.decode_tail(*(t.permute(0, 3, 1, 2) if t.dim() == 4 else t.permute(0, 1, 4, 2, 3) for t in x))
    assert out.grad_fn is not None
    (out * torch.from_numpy(d_out)).sum().backward()
    weights.collect_grads()
    got = dict(zip(("hidden", "f8p", "f4p"), (t.grad for t in x)))
    for name in TAIL_RAW:
        got[name] = weights.named[name].grad
        assert got[name].dtype == torch.float32, name
    return got


TAIL_RAW = {  # the port's decoder parameter → the JAX decoder's, as tests/test_torch_decode_tail.py maps them
    "dec8.conv.weight": ("dec8", "conv", "kernel"), "dec8.bn.weight": ("dec8", "bn", "scale"),
    "dec8.bn.bias": ("dec8", "bn", "bias"), "dec4.conv.weight": ("dec4", "conv", "kernel"),
    "dec4.bn.weight": ("dec4", "bn", "scale"), "dec4.bn.bias": ("dec4", "bn", "bias"),
    "out.weight": ("out", "kernel"), "out.bias": ("out", "bias"),
}


@pytest.mark.parametrize("n", [1, 3])
def test_tail_bf16_backward_matches_jax_grad(n):
    """``DecodeTail``'s bf16 backward through ``MaskDecoder.decode_tail`` on a bf16
    network (hidden 16×16 → 64×64 logits, 4 objects, ``n`` frames) against
    ``jax.grad`` of ``decode_tail_subpix(..., dtype=bfloat16)``: the three
    activations' gradients and the eight raw weights' (fp32, on their masters),
    each by RULE with BF16_ROUND, the whole by RULE and RAN."""
    from tests.torch_parity import port_tracker_network
    from yolo_puncture_tpu.track.network import decode_tail_subpix

    variables = seeded_tracker_variables(seed=6, image_hw=(64, 64))
    rng = np.random.default_rng(9 + n)
    hidden = rng.standard_normal((n, 4, 16, 16, 128)).astype(np.float32)
    f8p = rng.standard_normal((n, 32, 32, 64)).astype(np.float32)
    f4p = rng.standard_normal((n, 64, 64, 64)).astype(np.float32)
    d_out = rng.standard_normal((n, 4, 64, 64)).astype(np.float32)

    def jax_grads(dt):
        def loss(params, h, f8, f4):
            v = {"params": params, "batch_stats": variables["batch_stats"]}
            return (decode_tail_subpix(v, h, f8, f4, dtype=dt) * d_out).sum()

        gp, gh, g8, g4 = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
            variables["params"], *(jnp.asarray(a).astype(dt) for a in (hidden, f8p, f4p)))
        out = {"hidden": gh, "f8p": g8, "f4p": g4}
        for name, path in TAIL_RAW.items():
            g = gp["decoder"]
            for part in path:
                g = g[part]
            out[name] = np.transpose(_f32(g), (3, 2, 0, 1)) if path[-1] == "kernel" else g
        return out

    def port(dtype):
        return _tail_grads(port_tracker_network(variables), dtype, hidden, f8p, f4p, d_out)

    j32, j16, p16, p32 = jax_grads(jnp.float32), jax_grads(jnp.bfloat16), port(BF16), port(torch.float32)
    for name in j32:
        _hold(name, p16[name], j16[name], j32[name], BF16_ROUND * np.abs(_f32(j32[name])).mean())
    _hold_tree("decode_tail gradients", p16, j16, j32, p32, 0.0)


# ---------------------------------------------------------------------------
# PropagationTrainer
# ---------------------------------------------------------------------------


def _clip(seed):
    images, masks = pt.make_domain_randomized_clip(np.random.default_rng(seed), T, H, W, NO)
    return images, masks, (masks.sum((0, 2, 3)) > 0).astype(np.float32)


def _shared_setup():
    from yolo_puncture_tpu.models.yolo import YOLOModel as JaxYOLO
    from yolo_puncture_tpu.track.network import PropagationNetwork as JaxNet
    from yolo_puncture_tpu_torch.models.yolo import pyramid_channels_for

    channels = pyramid_channels_for("v10", "n")
    variables = seeded_jax_variables(JaxNet(with_pyramid_adapter=True, pyramid_channels=channels),
                                     jnp.zeros((1, H, W, 3)), seed=2)
    bvars = seeded_jax_variables(JaxYOLO(version="v10", scale="n", nc=1, task="segment"),
                                 jnp.zeros((1, 64, 64, 3)), seed=4)
    return variables, bvars, dict(CORE, pyramid_adapter=True, pyramid_channels=channels)


def _jax_tracker_step(mode, variables, kw, images, masks, valid, dt, bvars=None):
    """(loss, gradients) of the JAX package's propagation loss in ``dt``, the
    gradients as a state-dict-keyed numpy tree."""
    from yolo_puncture_tpu.track import train as jt
    from yolo_puncture_tpu.track.core import TrackerCore as JaxCore

    jcore = JaxCore(variables=jax.tree.map(jnp.asarray, variables), dtype=dt, **kw)
    if mode == "windowed":
        loss_fn = jt.build_windowed_propagation_loss(jcore, 3)
    elif mode == "shared":
        jfn, _ = jt.make_yolo_pyramid_fn(scale="n", variables=jax.tree.map(jnp.asarray, bvars), dtype=dt)
        loss_fn = jt.build_propagation_loss(jcore, jfn)
    else:
        loss_fn = jt.build_propagation_loss(jcore)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jcore.variables, *(jnp.asarray(a) for a in
                                                                           (images, masks, valid)))
    return float(loss), export_tracker_state_dict({"params": jax.device_get(grads["params"])})


def _port_tracker_step(mode, variables, kw, images, masks, valid, dtype, bvars=None):
    """(loss, master gradients, the trainer, the masters before the step) of one
    ``PropagationTrainer.train_step`` on a core of ``dtype``."""
    core = TrackerCore(variables=variables, device="cpu", dtype=dtype, **kw)
    pfn = None
    if mode == "shared":
        pfn, _ = pt.make_yolo_pyramid_fn(scale="n", variables=bvars, device="cpu", dtype=dtype)
    trainer = pt.PropagationTrainer(core, lr=LR, pyramid_fn=pfn, window_mix=1.0 if mode == "windowed" else 0.0,
                                    window=3)
    before = {n: p.detach().numpy().copy() for n, p in trainer.weights.named.items()}
    batch = [torch.from_numpy(a)[None] for a in (images, masks, valid)]
    loss = trainer.train_step(*batch, windowed=mode == "windowed")
    return loss, {n: p.grad.numpy() for n, p in trainer.weights.named.items()}, trainer, before


def assert_adam_on_fp32_masters(named, before, weights, lr):
    """The masters started at the fp32 weights to the bit (no bits lost to bf16)
    and moved by ``optax.adam``'s first step on their own fp32 gradient (ADAM_TOL
    of lr: torch's Adam and optax's round their fp32 arithmetic apart)."""
    grads = {n: p.grad.numpy() for n, p in named.items()}
    adam = optax.adam(lr)
    updates, _ = adam.update(grads, adam.init(grads))
    for n, p in named.items():
        assert np.array_equal(before[n], np.asarray(weights[n], np.float32)), n
        want = before[n] + np.asarray(updates[n])
        assert np.abs(p.detach().numpy() - want).max() <= ADAM_TOL * lr + 2 ** -23 * np.abs(want).max(), n


@pytest.mark.parametrize("mode", ["per_frame", "windowed", "shared"])
def test_propagation_trainer_bf16_step_matches_jax(mode):
    """One ``PropagationTrainer`` step on a bf16 ``TrackerCore`` (32×48, 2
    objects, a ring of 4 written every frame, clips of 4): per frame, through the
    windowed program (one window of 3) and on the shared backbone (a frozen bf16
    YOLOv10-n, ``make_yolo_pyramid_fn(dtype=bfloat16)``).  The loss by RULE (a
    floor of 1e-6 of the loss), the gradients by ``_hold_tree`` with GRAD_FLOOR,
    RAN; the Adam step on fp32 masters that start at the fp32 weights; the
    masters, Adam's moments and the statistics fp32, the network bf16."""
    if mode == "shared":
        variables, bvars, kw = _shared_setup()
        images, masks, valid = _clip(5)
    else:
        variables, bvars, kw = seeded_tracker_variables(seed=1, image_hw=(H, W)), None, CORE
        images, masks, valid = _clip(3)
    args = (mode, variables, kw, images, masks, valid)
    j32 = _jax_tracker_step(*args, jnp.float32, bvars=bvars)
    j16 = _jax_tracker_step(*args, jnp.bfloat16, bvars=bvars)
    p16 = _port_tracker_step(*args, BF16, bvars=bvars)
    p32 = _port_tracker_step(*args, torch.float32, bvars=bvars)
    print(f"{mode} loss: JAX fp32 {j32[0]:.7f}, JAX bf16 {j16[0]:.7f}, port bf16 {p16[0]:.7f}, port fp32 {p32[0]:.7f}")
    assert abs(p16[0] - j32[0]) <= RULE * abs(j16[0] - j32[0]) + 1e-6 * abs(j32[0])
    _hold_tree(f"{mode} gradients", p16[1], j16[1], j32[1], p32[1], GRAD_FLOOR)
    trainer = p16[2]
    assert_adam_on_fp32_masters(trainer.weights.named, p16[3], export_tracker_state_dict(variables), LR)
    assert_fp32_training_state(trainer.core.net, trainer.weights.named, trainer.opt)
    assert not trainer.core.memory.valid.any()


def test_tracker_cache_of_packed_weights_follows_the_masters():
    """The decode tail's packed weights are made again after each update: the
    masters' copy into the bf16 network moves the weights' version counters."""
    core = TrackerCore(variables=seeded_tracker_variables(seed=1, image_hw=(H, W)), device="cpu", dtype=BF16,
                       **CORE)
    trainer = pt.PropagationTrainer(core, lr=1e-2)
    dec = core.net.decoder
    before = dec.tail_params(BF16)
    trainer.train_step(*(torch.from_numpy(a)[None] for a in _clip(3)))
    after = dec.tail_params(BF16)
    assert after is not before and not torch.equal(after.w8, before.w8)
    fresh = pack_decode_tail_params(dec.dec8, dec.dec4, dec.out, BF16)
    for name in ("w8", "a8", "w4", "a4", "w_out", "b_out"):
        assert torch.equal(getattr(after, name), getattr(fresh, name)), name


def test_bf16_trained_tracker_msgpack_loads_into_both_packages_in_fp32(tmp_path):
    """``export_tracker_msgpack`` of a bf16-trained tracker writes its fp32 masters:
    the JAX package's ``TrackerCore(variables=path)`` reads fp32 leaves equal to
    them, and the port's bf16 ``TrackerCore`` loads them with those fp32 values
    behind its bf16 weights."""
    from yolo_puncture_tpu.track.core import TrackerCore as JaxCore
    from yolo_puncture_tpu_torch.nn.common import fp32_value
    from yolo_puncture_tpu_torch.utils.convert import export_tracker_msgpack

    core = TrackerCore(variables=seeded_tracker_variables(seed=1, image_hw=(H, W)), device="cpu", dtype=BF16,
                       **CORE)
    trainer = pt.PropagationTrainer(core, lr=1e-2)
    trainer.train_step(*(torch.from_numpy(a)[None] for a in _clip(3)))
    path = tmp_path / "tracker.msgpack"
    export_tracker_msgpack(core.net, str(path))
    jcore = JaxCore(variables=str(path), **CORE)
    flat = export_tracker_state_dict(jax.device_get(jcore.variables))
    assert all(np.asarray(v).dtype == np.float32 for v in flat.values())
    for n, m in trainer.weights.named.items():
        assert np.array_equal(flat[n], m.detach().numpy()), n
    loaded = TrackerCore(variables=str(path), device="cpu", dtype=BF16, **CORE)
    live = dict(loaded.net.named_parameters())
    for n, m in trainer.weights.named.items():
        assert torch.equal(fp32_value(live[n]), m.detach()), n


def test_master_weights_refuse_a_bf16_weight_without_its_fp32_value():
    """``MasterWeights`` starts from the kept fp32 values and raises where there
    is none (a module rounded by ``.to(bfloat16)``, or bf16 weights loaded into
    it) or where it no longer rounds to the weight (written in place after the
    cast); ``fp32_value`` without ``required`` widens a weight that has none."""
    from yolo_puncture_tpu_torch.nn.common import fp32_value

    torch.manual_seed(0)
    fp32 = torch.nn.Conv2d(4, 8, 3)
    kept = to_compute_dtype(torch.nn.Conv2d(4, 8, 3).requires_grad_(True), BF16)
    kept.load_state_dict(fp32.state_dict())
    masters = MasterWeights(kept).named
    assert all(torch.equal(masters[n], p) for n, p in fp32.named_parameters())
    bare = torch.nn.Conv2d(4, 8, 3).to(BF16)
    assert torch.equal(fp32_value(bare.weight), bare.weight.detach().float())
    with pytest.raises(ValueError, match="no fp32 value"):
        MasterWeights(bare)
    loaded16 = to_compute_dtype(torch.nn.Conv2d(4, 8, 3), BF16)
    loaded16.load_state_dict({k: v.to(BF16) for k, v in fp32.state_dict().items()})
    with pytest.raises(ValueError, match="no fp32 value"):
        MasterWeights(loaded16)
    written = to_compute_dtype(torch.nn.Conv2d(4, 8, 3), BF16)
    with torch.no_grad():
        written.weight.add_(1.0)
    with pytest.raises(ValueError, match="no longer rounds"):
        MasterWeights(written)

"""The int8 convolutions of the port (``yolo_puncture_tpu_torch/nn/quant.py``)
against the JAX package's (``yolo_puncture_tpu/nn/quant.py``), on the CPU.

The JAX side runs jitted, as its predictor and bench run it: XLA folds a
division by the constant 127 into a product with the fp32 reciprocal, and the
port does the same (``quant.RCP127``).  Weights are seeded numpy variables
through the weight bridge.

Where both sides get the same input the port is held exactly: a ``ConvBN`` at
``tests/test_quant.py``'s shapes (int8 operands equal element for element, the
int32 products equal, the output within ``OUT_REL`` of its largest value), and,
in YOLOv8n and YOLOv10n at 128², every eligible convolution fed JAX's input of
that convolution (``test_every_conv_of_the_model_with_jax_inputs``).  The whole
model cannot be held that closely: its fp32 activations differ from XLA's by an
ulp here and there (convolutions summed in another order), and an ulp that
sits on a rounding tie of ``x / s`` moves one int8 operand by one step, which
every later layer carries on (measured: the first flipped operand, 1 of 8192,
is in YOLOv8n's layer 6).  So the whole model is held, as the bf16 tests hold
bf16, by ``RULE`` and ``DIRECT`` relative to JAX's own int8-versus-fp32 gap:
the port's int8 output no farther from the JAX fp32 output than 1.5 times the
gap, within twice the gap of the JAX int8 output, and more than ``RAN`` times
the gap from its own fp32 output (an fp forward would sit at 1× and 0×, and
pass the first two).  Measured, mean abs over the heads: the port within
0.42–0.94 of the gap from JAX's int8 output with dynamic scales, and 0.23–0.57
with JAX's static scales (percentile 99.9) on both sides, where a scale cannot
move a whole tensor; a bound of 0.1 of the gap holds in neither.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tests.torch_parity import port_model_from_jax, seeded_jax_variables, torch_single_thread  # noqa: F401
from yolo_puncture_tpu.models.yolo import YOLOModel as JaxYOLOModel
from yolo_puncture_tpu.nn import quant as jq
from yolo_puncture_tpu.nn.common import ConvBN as JaxConvBN
from yolo_puncture_tpu_torch.nn import quant
from yolo_puncture_tpu_torch.nn.common import ConvBN

OUT_REL = 1e-6          # an int8 layer's output against JAX's on the same input, relative to its largest value
SCALE_REL = 1e-6        # calibrated scales against JAX's
RULE, DIRECT = 1.5, 2.0
RAN = 0.5               # the port's int8 output at least this times the gap from its fp32 output
IMGSZ = 128


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _jax_int8(module, variables, x, act_scales=None, monkeypatch=None):
    """``module.apply`` under the JAX package's int8 path, jitted.  Returns (the
    outputs, {module key: (conv input, conv output)}, [(int8 lhs, int8 rhs,
    int32 product)] when ``monkeypatch`` is given)."""
    products = []
    if monkeypatch is not None:
        real = jax.lax.conv_general_dilated

        def spy(lhs, rhs, *a, **k):
            y = real(lhs, rhs, *a, **k)
            if lhs.dtype == jnp.int8:
                products.append((lhs, rhs, y))
            return y

        monkeypatch.setattr(jax.lax, "conv_general_dilated", spy)

    def run(v, x):
        rec = {}

        def interceptor(next_fn, args, kwargs, context):       # jq.int8_convs' interceptor, recording
            mod = context.module
            if context.method_name == "__call__" and jq._eligible(mod):
                s = act_scales.get(jq._module_key(mod)) if act_scales else None
                y = jq._int8_conv(mod, args[0], act_scale=s)
                rec[jq._module_key(mod)] = (args[0], y)
                return y
            return next_fn(*args, **kwargs)

        products.clear()
        with fnn.intercept_methods(interceptor):
            out = module.apply(v, x)
        return out, rec, list(products)

    out, rec, prods = jax.jit(run)(variables, jnp.asarray(x))
    return out, rec, prods


def _port_convbn(variables, c1, c2, k, s):
    m = ConvBN(c1, c2, k, s).eval()
    p, b = variables["params"], variables["batch_stats"]
    m.load_state_dict({"conv.weight": torch.from_numpy(np.asarray(p["conv"]["kernel"]).transpose(3, 2, 0, 1).copy()),
                       "bn.weight": torch.from_numpy(np.asarray(p["bn"]["scale"])),
                       "bn.bias": torch.from_numpy(np.asarray(p["bn"]["bias"])),
                       "bn.running_mean": torch.from_numpy(np.asarray(b["bn"]["mean"])),
                       "bn.running_var": torch.from_numpy(np.asarray(b["bn"]["var"]))}, strict=False)
    return m


@pytest.mark.parametrize("act_scale", [None, 3.7])
def test_convbn_int8_operands_products_and_output_equal_jax(act_scale, monkeypatch):
    """``tests/test_quant.py``'s ConvBN (16 → 32, 3×3, stride 2) on (2, 32, 32, 16):
    dynamic and static activation scales."""
    m = JaxConvBN(32, 3, 2)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 16)).astype(np.float32)
    v = seeded_jax_variables(m, jnp.asarray(x), 0)
    scales = None if act_scale is None else {"conv": act_scale}
    ref, _, prods = _jax_int8(m, v, x, scales, monkeypatch)
    (jx, jk, jy), = prods
    pm = _port_convbn(v, 16, 32, 3, 2)
    xt = _nchw(x)
    xi8, sx = quant.quantize_activation(xt, act_scale)
    ki8, _ = quant.quantize_weight(pm.conv.weight)
    np.testing.assert_array_equal(xi8.numpy(), np.moveaxis(np.asarray(jx), -1, 1))
    np.testing.assert_array_equal(ki8.numpy(), np.asarray(jk).transpose(3, 2, 0, 1))
    y = quant.conv2d_int8(xi8, ki8, pm.conv.stride, pm.conv.padding, pm.conv.dilation)
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), np.moveaxis(np.asarray(jy), -1, 1))
    with torch.no_grad(), quant.int8_convs(act_scales=scales):
        got = pm(xt).permute(0, 2, 3, 1).numpy()
    r = np.asarray(ref)
    assert np.abs(got - r).max() <= OUT_REL * np.abs(r).max()
    with torch.no_grad():
        fp = pm(xt).permute(0, 2, 3, 1).numpy()
    assert (got != fp).any() and np.corrcoef(got.ravel(), fp.ravel())[0, 1] > 0.99   # an int8 result, near fp


def test_biased_and_grouped_convs_stay_fp():
    """A biased convolution and a depthwise ``ConvBN`` give under the switch
    exactly what they give without it, as in the JAX package."""
    torch.manual_seed(0)
    pred = torch.nn.Conv2d(8, 8, 1, bias=True)
    dw = ConvBN(8, 8, 3, g=8).eval()
    x = torch.randn(1, 8, 8, 8)
    with torch.no_grad():
        ref = quant.conv_forward(pred, x), dw(x)
        with quant.int8_convs():
            got = quant.conv_forward(pred, x), dw(x)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert not quant._eligible(pred) and not quant._eligible(dw.conv)


def test_int_mm_pads_to_the_cards_rules():
    """Rows ≤ 16 and widths off a multiple of 8 are zero-padded and cut off again:
    the product equals an int64 matmul."""
    g = torch.Generator().manual_seed(1)
    for M, K, N in ((5, 27, 3), (17, 64, 24), (16, 405, 130)):
        a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
        assert torch.equal(quant.int_mm(a, b), (a.long() @ b.long().T).int())


def test_switch_does_not_leak_to_another_thread():
    """``int8_convs`` held open in one thread; a model run meanwhile in another
    thread stays fp, and runs int8 inside its own block."""
    torch.manual_seed(2)
    m = ConvBN(8, 16, 3).eval()
    x = torch.randn(1, 8, 16, 16)
    with torch.no_grad():
        fp = m(x)
        with quant.int8_convs():
            q8 = m(x)
    assert not torch.equal(fp, q8)
    entered, done, got = threading.Event(), threading.Event(), {}

    def holder():
        with quant.int8_convs():
            entered.set()
            done.wait(60)

    def other():
        with torch.no_grad():
            got["fp"] = m(x)
            with quant.int8_convs():
                got["q8"] = m(x)

    th = threading.Thread(target=holder)
    th.start()
    try:
        assert entered.wait(60)
        to = threading.Thread(target=other)
        to.start()
        to.join(60)
        assert not to.is_alive()
        with torch.no_grad():
            got["main"] = m(x)
    finally:
        done.set()
        th.join(60)
    assert not th.is_alive()
    assert torch.equal(got["fp"], fp) and torch.equal(got["main"], fp) and torch.equal(got["q8"], q8)


def test_percentile_is_jaxs_on_large_inputs():
    """``percentile_linear`` against ``jnp.percentile`` exactly, past 2²⁴ elements too
    (where ``torch.quantile`` refuses)."""
    rng = np.random.default_rng(3)
    for n, pcts in ((1001, (99.9, 50.0)), (123457, (99.9, 50.0)), ((1 << 24) + 5, (99.9,))):
        a = np.abs(rng.standard_normal(n)).astype(np.float32)
        for pct in pcts:
            assert quant.percentile_linear(torch.from_numpy(a), pct) == float(jnp.percentile(jnp.asarray(a), pct))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model(version):
    jm = JaxYOLOModel(version=version, scale="n", nc=1, task="segment")
    v = seeded_jax_variables(jm, jnp.zeros((1, IMGSZ, IMGSZ, 3)), 0)
    x = np.random.default_rng(1).uniform(size=(2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    return jm, v, port_model_from_jax(version, "n", 1, "segment", v), x


@functools.lru_cache(maxsize=None)
def _jax_forwards(version):
    jm, v, _, x = _model(version)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    q8, rec, _ = _jax_int8(jm, v, x)
    return ref, q8, rec


def _mean_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).mean())


@pytest.mark.parametrize("version", ["v8", "v10"])
def test_every_conv_of_the_model_with_jax_inputs(version):
    """Each eligible convolution of the model, fed JAX's input of that
    convolution in the JAX int8 forward, gives JAX's int8 output within
    ``OUT_REL``; the keys are the port's ``flax_path``s."""
    _, _, pm, _ = _model(version)
    _, _, rec = _jax_forwards(version)
    convs = {m.flax_path: m for m in pm.modules() if quant._eligible(m)}
    assert set(rec) == set(convs) and len(rec) > 60
    worst = 0.0
    for key, (xin, yref) in rec.items():
        with torch.no_grad():
            got = quant._int8_conv(convs[key], _nchw(xin))
        r = np.moveaxis(np.asarray(yref), -1, 1)
        worst = max(worst, float(np.abs(got.numpy() - r).max() / max(np.abs(r).max(), 1e-30)))
    print(f"{version}: {len(rec)} convolutions, worst relative difference {worst:.3g}")
    assert worst <= OUT_REL


@pytest.mark.parametrize("version", ["v8", "v10"])
def test_model_int8_heads_within_the_gap_of_jax(version):
    """The whole int8 model against the JAX package's (``RULE``, ``DIRECT``)."""
    _, _, pm, x = _model(version)
    ref, q8, _ = _jax_forwards(version)
    with torch.no_grad():
        fp = pm(torch.from_numpy(x))
        with quant.int8_convs():
            got = pm(torch.from_numpy(x))
    for k in ("boxes", "probs", "coeffs"):
        g = got[k].numpy()
        assert np.isfinite(g).all()
        gap, e_port, e_direct = _mean_err(q8[k], ref[k]), _mean_err(g, ref[k]), _mean_err(g, q8[k])
        l2 = np.linalg.norm(g - np.asarray(q8[k])) / np.linalg.norm(np.asarray(q8[k]) - np.asarray(ref[k]))
        ran = _mean_err(g, fp[k].numpy())
        print(f"{version} {k}: JAX int8 vs fp32 {gap:.4g}, port int8 vs JAX fp32 {e_port / gap:.3f}x, "
              f"port int8 vs JAX int8 {e_direct / gap:.3f}x (L2 {l2:.3f}x), port int8 vs port fp32 {ran / gap:.3f}x")
        assert gap > 0 and e_port <= RULE * gap and e_direct <= DIRECT * gap and ran > RAN * gap, k


@pytest.mark.parametrize("version", ["v8", "v10"])
def test_calibrated_scales_match_jax(version):
    """``collect_act_scales``: the same keys as JAX's, the first convolution's scale
    (its input is the image on both sides) equal, every scale within
    ``SCALE_REL`` at percentile 100 and 99.9."""
    jm, v, pm, x = _model(version)
    for pct in (100.0, 99.9):
        js = jq.collect_act_scales(lambda b: jm.apply(v, b), [jnp.asarray(x)], percentile=pct)
        ps = quant.collect_act_scales(pm, [torch.from_numpy(x)], percentile=pct)
        assert set(ps) == set(js)
        assert ps["model_0/conv"] == js["model_0/conv"]
        worst = max(abs(ps[k] - js[k]) / js[k] for k in js)
        print(f"{version} percentile {pct}: {len(js)} scales, worst relative difference {worst:.3g}")
        assert worst <= SCALE_REL


@pytest.mark.parametrize("version", ["v8", "v10"])
def test_jax_scales_run_in_the_port(version):
    """JAX's scales dict installed on both sides: the port's static int8 forward
    within ``DIRECT`` of JAX's static gap from JAX's static int8 forward (no
    dynamic scale there to shift a whole tensor; measured 0.23–0.57, so the
    0.1 bound does not hold here either), more than ``RAN`` of it from the
    port's fp32 forward, and within ``DIRECT`` of the port's forward on its own
    scales (which differ from JAX's in the last digits)."""
    jm, v, pm, x = _model(version)
    ref, _, _ = _jax_forwards(version)
    js = jq.collect_act_scales(lambda b: jm.apply(v, b), [jnp.asarray(x)], percentile=99.9)
    ps = quant.collect_act_scales(pm, [torch.from_numpy(x)], percentile=99.9)
    with torch.no_grad():
        fp = pm(torch.from_numpy(x))
        with quant.int8_convs(act_scales={k: float(s) for k, s in js.items()}):
            a = pm(torch.from_numpy(x))
        with quant.int8_convs(act_scales=ps):
            b = pm(torch.from_numpy(x))
    jstat, _, _ = _jax_int8(jm, v, x, act_scales=js)
    for k in ("boxes", "probs"):
        gap = _mean_err(jstat[k], ref[k])
        direct, ran = _mean_err(a[k].numpy(), jstat[k]), _mean_err(a[k].numpy(), fp[k].numpy())
        print(f"{version} {k}: JAX static int8 vs fp32 {gap:.4g}, port vs JAX with JAX's scales {direct / gap:.3f}x, "
              f"port static int8 vs port fp32 {ran / gap:.3f}x")
        assert gap > 0 and _mean_err(a[k].numpy(), b[k].numpy()) <= DIRECT * gap, k
        assert direct <= DIRECT * gap and ran > RAN * gap, k


def test_bf16_model_quantises_its_fp32_weights():
    """A model frozen in fp32 and cast to bf16 keeps the int8 weights of its fp32
    ones, as the JAX package quantises flax's fp32 parameters; ``YOLO`` builds
    its int8 model so.  A bf16 convolution without them raises, and so does one
    whose weights changed after the freeze; the operands stay out of the state
    dict and follow the model's moves."""
    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.models.yolo import YOLOModel
    from yolo_puncture_tpu_torch.utils.convert import export_yolo_state_dict, load_yolo_state_dict

    _, v, p32, x = _model("v10")
    p16 = YOLOModel("v10", "n", 1, "segment")
    load_yolo_state_dict(p16, export_yolo_state_dict(v))
    quant.freeze_int8_weights(p16).cast(torch.bfloat16)
    c32, c16 = p32.model[0].conv, p16.model[0].conv
    assert c16.weight.dtype == torch.bfloat16 and c16.int8_kernel.dtype == torch.int8
    for a, b in zip(quant._weight_operand(c16), quant._weight_operand(c32)):
        assert torch.equal(a, b)
    assert not any("int8" in k for k in p16.state_dict())
    assert torch.equal(p16.to("cpu").model[0].conv.int8_kernel, c16.int8_kernel)
    with torch.no_grad(), quant.int8_convs():
        assert p16(torch.from_numpy(x[:1]))["boxes"].isfinite().all()
        plain16 = YOLOModel("v10", "n", 1, "segment", dtype=torch.bfloat16)
        with pytest.raises(RuntimeError, match="freeze_int8_weights"):
            plain16(torch.from_numpy(x[:1]))
        c16.weight.mul_(0.5)
        with pytest.raises(RuntimeError, match="changed after freeze_int8_weights"):
            p16(torch.from_numpy(x[:1]))
    with pytest.raises(ValueError, match="fp32 weights"):
        quant.freeze_int8_weights(plain16)
    det = YOLO("yolo10n-seg", nc=1, seed=3, dtype=torch.bfloat16, int8_serving=True, device="cpu")
    ref = YOLO("yolo10n-seg", nc=1, seed=3, device="cpu").model
    assert det.model.dtype == torch.bfloat16 and det.model.model[0].conv.weight.dtype == torch.bfloat16
    for a, b in zip(quant._weight_operand(det.model.model[1].conv), quant._weight_operand(ref.model[1].conv)):
        assert torch.equal(a, b)

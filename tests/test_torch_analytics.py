"""The port's host analytics against the JAX package: key frame and class repair,
the insertion state machine (host loop bit-equal; tensor form against the JAX
``lax.scan``), speed statistics, smoothing, the model registry and the config.

Inputs are seeded numpy sequences plus the edge cases the pipeline meets: every
frame a dropout, fewer frames than the voting window, an empty calibration
window.  The host functions are the same numpy arithmetic on both sides, so
they must agree exactly; the fp32 tensor forms within fp32 rounding.
"""

import dataclasses
import math
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter1d
from scipy.signal import savgol_filter

from tests.torch_parity import torch_single_thread  # noqa: F401
from yolo_puncture_tpu.analytics import keyframe as jkey
from yolo_puncture_tpu.analytics import speed as jspeed
from yolo_puncture_tpu.analytics import stats as jstats
from yolo_puncture_tpu.ops import signal as jsig
from yolo_puncture_tpu_torch import analytics as pan
from yolo_puncture_tpu_torch.analytics import keyframe as pkey
from yolo_puncture_tpu_torch.ops import signal as psig

FP32_RTOL = 1e-6  # the tensor forms: a 5-element mean and one division in fp32, in another order


def _sequence(seed: int):
    """A classifier-like sequence: mostly 0 then mostly 1 around a random switch,
    flipped frames, probabilities in [0.5, 1); random window and detections."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 120))
    switch = int(rng.integers(0, n))
    classes = (np.arange(n) >= switch).astype(int)
    flip = rng.random(n) < rng.uniform(0.0, 0.3)
    classes = np.where(flip, 1 - classes, classes)
    probs = rng.uniform(0.5, 1.0, n)
    wnd = int(rng.integers(10, 41))
    detected = rng.random(n) < rng.uniform(0.3, 1.0)
    lens = np.where(np.arange(n) < switch, 100.0, 100.0 - 3.0 * (np.arange(n) - switch)) + rng.normal(0, 2, n)
    return classes.tolist(), probs.tolist(), wnd, detected.tolist(), np.maximum(lens, 0.0).tolist()


EDGE = {
    "all-dropout": ([0] * 30, [0.7] * 30, 20, [False] * 30, [0.0] * 30),
    "shorter-than-window": ([0, 0, 1, 1, 1], [0.9] * 5, 20, [True] * 5, [50.0, 50.0, 40.0, 30.0, 20.0]),
    "empty-window": ([0] * 10 + [1] * 30, [0.95] * 40, 20, [False] * 40, [80.0] * 10 + list(np.linspace(80, 10, 30))),
    "all-ones": ([1] * 40, [0.99] * 40, 20, [True] * 40, list(np.linspace(100, 50, 40))),
    "empty": ([], [], 20, [], []),
}


def _cases():
    return [pytest.param(_sequence(100 + i), id=f"seed{i}") for i in range(25)] + \
        [pytest.param(v, id=k) for k, v in EDGE.items()]


@pytest.mark.parametrize("case", _cases())
def test_keyframe_and_repair_match_jax(case):
    classes, probs, wnd, _, _ = case
    start = pkey.find_insert_start(classes, probs, wnd)
    assert start == jkey.find_insert_start(classes, probs, wnd)
    assert pkey.fix_class_prob(classes, probs, start) == jkey.fix_class_prob(classes, probs, start)
    assert pkey.predict_and_find_start_inserted_from_scores(classes, probs, wnd) == \
        jkey.predict_and_find_start_inserted_from_scores(classes, probs, wnd)


@pytest.mark.parametrize("case", _cases())
def test_state_machine_matches_jax(case):
    """The host loop bit-equal; the tensor form against the JAX scan: the same
    end frame, speed and lengths within fp32 rounding, NaN where uncalibrated."""
    classes, probs, wnd, detected, lens = case
    start = jkey.find_insert_start(classes, probs, wnd)
    classes, _ = jkey.fix_class_prob(classes, probs, start)
    smooth = jsig.gaussian_smoothing(lens)
    for fps in (30.0, 25.0):
        got = pan.insertion_state_machine(classes, smooth, detected, start, fps)
        ref = jspeed.insertion_state_machine(classes, smooth, detected, start, fps)
        assert (got.start_frame, got.end_frame, got.speed_mm_s) == (ref.start_frame, ref.end_frame, ref.speed_mm_s)
        np.testing.assert_array_equal(got.actual_lens, ref.actual_lens)

        if not classes:
            continue  # lax.scan needs at least one step to carry its state
        p_start, p_end, p_speed, p_lens = pan.insertion_state_machine_torch(
            torch.tensor(classes), torch.tensor(smooth, dtype=torch.float32), torch.tensor(detected), start, fps)
        j_start, j_end, j_speed, j_lens = jspeed.insertion_state_machine_jax(
            jnp.asarray(classes), jnp.asarray(smooth, jnp.float32), jnp.asarray(detected), start, fps)
        assert int(p_start) == int(j_start) and int(p_end) == int(j_end)
        np.testing.assert_allclose(float(p_speed), float(j_speed), rtol=FP32_RTOL)
        np.testing.assert_allclose(p_lens.numpy(), np.asarray(j_lens), rtol=FP32_RTOL, equal_nan=True)
        # and the scan agrees with the host loop where the loop triggered
        assert int(p_end) == (-1 if got.end_frame is None else got.end_frame)


def test_state_machine_torch_reports_no_end_and_no_calibration():
    start, end, speed, lens = pan.insertion_state_machine_torch([1, 1, 1], [0.0, 0.0, 0.0], [False] * 3, 0, 30.0)
    assert int(end) == -1 and float(speed) == 0.0
    np.testing.assert_array_equal(lens.numpy(), [20.0, 20.0, 20.0])  # mean 0: uncalibratable, 20 mm
    _, end, _, lens = pan.insertion_state_machine_torch([0, 0], [5.0, 5.0], [False, False], 0, 30.0)
    assert int(end) == -1 and np.isnan(lens.numpy()).all()
    assert pan.insertion_state_machine_torch([], [], [], 0, 30.0)[3].shape == (0,)


@pytest.mark.parametrize("seed", range(8))
def test_stats_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(12, 80))
    lens = (100.0 + rng.normal(0, 5, n) - np.maximum(np.arange(n) - n // 3, 0) * 2.0).tolist()
    lens[int(rng.integers(0, n))] = 400.0  # an outlier
    assert pan.remove_outliers(lens) == jstats.remove_outliers(lens)
    assert pan.remove_outliers([3.0] * 6) == jstats.remove_outliers([3.0] * 6)  # MAD 0
    s, e = int(rng.integers(1, n // 2)), int(rng.integers(n // 2, n))
    assert pan.calculate_speed_mm(lens, s, e, 30.0) == jstats.calculate_speed_mm(lens, s, e, 30.0)
    assert pan.compute_pixel_to_mm_ratio(lens, s) == jstats.compute_pixel_to_mm_ratio(lens, s)
    with pytest.raises(ValueError):
        pan.compute_pixel_to_mm_ratio(lens, 0)
    assert pan.compute_metrics(lens, (s, e), (s + 1, e + 2), 30.0) == jstats.compute_metrics(lens, (s, e), (s + 1, e + 2), 30.0)


@pytest.mark.parametrize("n", [1, 4, 10, 57, 301])
def test_signal_matches_jax_and_scipy(n):
    x = np.random.default_rng(n).normal(size=n) * 50 + 100
    for sigma in (1, 3):
        got = np.array(psig.gaussian_smoothing(x, sigma=sigma))
        np.testing.assert_allclose(got, jsig.gaussian_smoothing(x, sigma=sigma), rtol=0, atol=1e-12)
        np.testing.assert_allclose(got, gaussian_filter1d(x, sigma=sigma), rtol=1e-10, atol=1e-10)
    if n >= 7:
        got = np.array(psig.savitzky_golay_smoothing(x, 7, 2))
        np.testing.assert_allclose(got, jsig.savitzky_golay_smoothing(x, 7, 2), rtol=0, atol=1e-12)
        np.testing.assert_allclose(got, savgol_filter(x, 7, 2), rtol=1e-8, atol=1e-8)
    else:
        with pytest.raises(ValueError):
            psig.savitzky_golay_smoothing(x, 7, 2)
    np.testing.assert_allclose(psig.difference(x), jsig.difference(x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(psig.median_smoothing(x, 7), jsig.median_smoothing(x, 7), rtol=0, atol=1e-12)
    assert psig.gaussian_smoothing([]) == [] and psig.median_smoothing([]) == []


@pytest.mark.parametrize("n", [2, 5, 13, 123])
def test_gaussian_smoothing_torch_matches_jnp(n):
    """fp32 on both sides; n below the kernel's radius (12) repeats the mirror."""
    x = (np.random.default_rng(n).normal(size=n) * 50 + 100).astype(np.float32)
    got = psig.gaussian_smoothing_torch(torch.from_numpy(x))
    ref = np.asarray(jsig.gaussian_smoothing_jnp(jnp.asarray(x)))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), gaussian_filter1d(x.astype(np.float64), 3), rtol=1e-5, atol=1e-3)


def test_registry_matches_jax():
    from yolo_puncture_tpu import registry as jreg
    from yolo_puncture_tpu_torch import registry as preg
    from yolo_puncture_tpu_torch.models.efficientnet import EfficientNet

    names = [f"efficientnet_b{i}" for i in range(8)]
    assert set(names) <= set(preg.list_models()) and set(names) <= set(jreg.list_models())
    m = preg.create_model("efficientnet_b0", num_classes=3)
    assert isinstance(m, EfficientNet) and m.classifier.out_features == 3
    with pytest.raises(KeyError):
        preg.create_model("no_such_model")

    @preg.register_model(name="_test_tiny")
    def tiny(**kw):
        return torch.nn.Linear(2, kw.get("num_classes", 2))

    try:
        assert preg.create_model("_test_tiny", num_classes=4).out_features == 4
        preg.register_model(tiny)  # the bare form: the function's own name
        assert "tiny" in preg.list_models()
    finally:
        preg._MODEL_REGISTRY.pop("_test_tiny")
        preg._MODEL_REGISTRY.pop("tiny")


def test_config_matches_jax_without_yaml(tmp_path, monkeypatch):
    from yolo_puncture_tpu.utils import config as jcfg
    from yolo_puncture_tpu_torch.utils import config as pcfg

    monkeypatch.setitem(sys.modules, "yaml", None)  # 'import yaml' now raises
    assert dataclasses.asdict(pcfg.load_config()) == dataclasses.asdict(jcfg.Config())
    assert pcfg.get_config() is pcfg.get_config()
    monkeypatch.delitem(sys.modules, "yaml")
    path = tmp_path / "config.yaml"
    path.write_text("analytics:\n  judge_wnd: 12\n  gaussian_sigma: 2.5\npredict:\n  conf: 0.4\nunknown: 1\n")
    got, ref = pcfg.load_config(str(path)), jcfg.load_config(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.analytics.judge_wnd == 12 and math.isclose(got.predict.conf, 0.4)
    assert got.replace(PATH=pcfg.PathConfig("d", "w")).PATH.WEIGHTS_PATH == "w"

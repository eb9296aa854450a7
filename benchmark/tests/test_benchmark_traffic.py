"""The traffic is a function of the seed alone, with the same sizes for every seed."""

import torch

from benchmark import run as harness, traffic
from benchmark.tests.conftest import TINY


def _tiny(name="stream.b128"):
    tr = harness.load_json("traffic", name)
    tr.update(TINY["traffic"])
    tr["bar"] = {**harness.load_json("traffic", name)["bar"], **TINY["traffic"]["bar"]}
    return tr


def test_same_seed_same_frames_other_seed_other_pixels():
    tr = _tiny()
    seed = 2 ** 31 + 977                    # larger than 32 signed bits hold
    a, b, c = traffic.frames(tr, seed, "cpu"), traffic.frames(tr, seed, "cpu"), traffic.frames(tr, seed + 1, "cpu")
    assert len(a) == tr["distinct_batches"]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    assert [x.shape for x in a] == [x.shape for x in c] == [(8, 72, 128, 3)] * tr["distinct_batches"]


def test_bar_moves_by_its_speed_and_stays_inside():
    tr = _tiny()
    f = traffic.frames(tr, 5, "cpu")
    top, bottom = tr["bar"]["rows"]
    x0 = traffic.bar_starts(tr, 5)
    span = tr["frame_hw"][1] - tr["bar"]["width"]
    for b, batch in enumerate(f):
        for i in range(batch.shape[0]):
            x = (x0 + tr["bar"]["speed"] * (b * batch.shape[0] + i)) % span
            assert (batch[i, top:bottom, x:x + tr["bar"]["width"]] == tr["bar"]["value"]).all()
            lo, hi = tr["texture"]
            assert int(batch[i, :top].min()) >= lo and int(batch[i, :top].max()) < hi

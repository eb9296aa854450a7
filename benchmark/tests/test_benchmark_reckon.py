"""The yardstick's counts at the cells' launch shapes, against the reckoning
``chip_smoke.py`` prints for the same kernels (phases 6b, 6c, 6f)."""

import json

import pytest
import torch

from benchmark import reckon
from benchmark.run import HERE


def _cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_proto_decode_bf16_at_the_bench_launch_moves_216_mb():
    # chip_smoke.proto_decode_bf16_times: 2 * (B * 32 * P + B * N * 32 + B * N * P) + 4 * B * N * 4
    B, N, P = 128, 1, 160 * 160
    nbytes, flops = reckon.proto_decode(B, N, 160, 160)
    assert nbytes == 2 * (B * 32 * P + B * N * 32 + B * N * P) + 4 * B * N * 4 == 216_279_040
    assert flops == 2 * B * N * P * 32


@pytest.mark.parametrize("Q, No", [(4 * 1620, 2), (8100, 4)])
def test_memory_readout_matches_chip_smoke(Q, No):
    # chip_smoke 6b (bf16): esize * (Q*64 + n_valid*64 + No*n_valid*Cv + No*Q*Cv) + M; 2*Q*n_valid*(64 + No*Cv)
    M, n_valid, Cv = 12968, 8 * 1620, 128
    nbytes, flops = reckon.memory_readout(Q, M, n_valid, No)
    assert nbytes == 2 * (Q * 64 + n_valid * 64 + No * n_valid * Cv + No * Q * Cv) + M
    assert flops == 2 * Q * n_valid * (64 + No * Cv)


@pytest.mark.parametrize("N, No", [(128, 2), (64, 2), (5, 4)])
def test_decode_tail_matches_chip_smoke(N, No):
    from yolo_puncture_tpu_torch.ops.kernels.decode_tail import pack_decode_tail_params
    from yolo_puncture_tpu_torch.track.network import MaskDecoder

    H16, W16 = 30, 54
    params = pack_decode_tail_params(*(lambda d: (d.dec8, d.dec4, d.out))(MaskDecoder()), torch.bfloat16)
    cells, esize = N * No, 2
    hidden, f8p, f4p, out = cells * H16 * W16 * 128, N * 4 * H16 * W16 * 64, N * 16 * H16 * W16 * 64, cells * 16 * H16 * W16
    smoke_bytes = (esize * (hidden + f8p + f4p) + 4 * out + params.t8.numel() * params.t8.element_size()
                   + params.t4.numel() * params.t4.element_size() + 4 * (2 * params.a8.numel() + 65))
    smoke_flops = 2 * cells * 4 * 256 * (H16 * W16 * 128 + 4 * H16 * W16 * 64) + 2 * cells * 16 * H16 * W16 * 64
    assert reckon.decode_tail(N, No, H16, W16) == (smoke_bytes, smoke_flops)


def test_tracker_geometry_of_720p():
    assert reckon.tracker_hw(_cfg("yolov10s-seg.tracker")) == (480, 864)


def test_step_flops_follow_the_published_detector_sizes():
    # YOLOv10-S 21.6 and YOLOv10-X 160.4 GFLOPs of detection at 640² (arXiv:2405.14458 table 1);
    # the seg head's prototypes at 160² (128 and 320 channels) add 10-70 GFLOPs, and the
    # tracker is the same in both
    tr = {"batch": 2, "long_term": False, "conf": 0.25, "max_det": 8}
    s, x = (reckon.step_flops(_cfg(n), tr) / 2 for n in ("yolov10s-seg.tracker", "yolov10x-seg.tracker"))
    assert 160.4e9 - 21.6e9 < x - s < 160.4e9 - 21.6e9 + 70e9
    assert s > 21.6e9

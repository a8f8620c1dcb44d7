"""The work counters against hand counts."""

import math

import pytest

from h100bench.reference.style import param_shapes
from h100bench.work import flops
from h100bench.work.peaks import bound
from h100bench.work.stats import percentile


def test_encoder_flops_by_hand_at_a_small_width():
    # 2 blocks of 4 channels, kernel 3, dilations (1, 2), embedding 6, MLP 5,
    # on 64 samples: block 0 conv0 (stride 2) 1 -> 4 over 31 outputs, conv1
    # 4 -> 4 over 29; block 1 conv0 (dilation 2, stride 2) over 13, conv1
    # over 11; dense 4 -> 5 -> 5 -> 6
    by_hand = 2 * (4 * 1 * 3 * 31 + 4 * 4 * 3 * 29 + 4 * 4 * 3 * 13 + 4 * 4 * 3 * 11) + 2 * (4 * 5 + 5 * 5 + 5 * 6)
    assert flops.encoder_flops(64, 4, (1, 2), 3, 6, mlp=5) == by_hand


def test_published_encoder_count_and_weights():
    net = dict(ch_dim=256, encoder_dilations=[1, 2, 4, 8, 16] * 2, kernel_size=7, embed_dim=512, mlp_hidden=256,
               projector_hidden=256, num_params=[18, 6, 25, 1])
    assert sum(math.prod(s) for s in param_shapes(net).values()) == 10322246
    assert flops.style_train_flops(net, 8, 131072) == pytest.approx(8.6255e12, rel=1e-4)


def test_too_short_a_clip_raises():
    with pytest.raises(ValueError):
        flops.encoder_flops(100, 4, (16, 16, 16), 7, 8)


def test_kernel_work_and_bound():
    nbytes, ops = flops.sosfilt_work((8, 6, 6), (8, 1, 1000))
    assert (nbytes, ops) == (2 * 8 * 1000 * 4 + 288 * 4, 9 * 8 * 1000 * 6)
    assert flops.ballistics_work((8, 1, 1000)) == (64000, 32000)
    b = bound(3.35e9, 1.0)
    assert b == {"bound_ms": pytest.approx(1.0), "bound_by": "bytes"}


def test_nearest_rank_percentile():
    values = list(range(1, 101))
    assert percentile(values, 95) == 95 and percentile(values, 50) == 50 and percentile([7.0], 95) == 7.0
    assert percentile(list(reversed(values)), 100) == 100

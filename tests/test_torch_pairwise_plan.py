"""The split plan of the pairwise_l2 kernel (avtex_torch/ops/pairwise.py):
how many contiguous feature ranges (splits) the Gram kernel cuts F into,
and where they fall. The plan is pure Python, so it is held here on the
CPU; the kernel that follows it runs on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 6)."""

import pytest

from avtex_torch.ops import pairwise
from avtex_torch.ops.pairwise import SLAB, TILE, _split_plan

SHAPES = [(n, f) for n in (1, 2, 127, 128, 129, 777, 1800, 4000, 20000)
          for f in (1, 3, 15, 16, 17, 500, 511, 512, 1001, 12289, 12292,
                    150528, 150529)]
CARDS = [(132, 2), (132, 1), (114, 2), (8, 3)]


def split_bounds(f, splits):
    """The feature ranges ``[k0, k1)`` the kernel gives the splits
    (pairwise_l2.cu: split s holds slabs [s*slabs/S, (s+1)*slabs/S), the
    last clipped at f)."""
    slabs = -(-f // SLAB)
    return [(slabs * s // splits * SLAB,
             min(f, slabs * (s + 1) // splits * SLAB))
            for s in range(splits)]


def _tiles(n):
    t = -(-n // TILE)
    return t * (t + 1) // 2


@pytest.mark.parametrize("sms,bps", CARDS)
def test_splits_cover_f_once_in_whole_slabs(sms, bps):
    for n, f in SHAPES:
        s = _split_plan(n, f, sms, bps)
        bounds = split_bounds(f, s)
        assert len(bounds) == s >= 1
        assert bounds[0][0] == 0 and bounds[-1][1] == f
        for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
            assert a1 == b0  # contiguous, no overlap
        for k0, k1 in bounds:
            assert k1 > k0, (n, f, s)  # no empty split
            assert k0 % SLAB == 0
        for k0, k1 in bounds[:-1]:
            assert (k1 - k0) % SLAB == 0  # whole slabs; only the last is cut
        slabs = [-(-(k1 - k0) // SLAB) for k0, k1 in bounds]
        assert max(slabs) - min(slabs) <= 1  # balanced


@pytest.mark.parametrize("sms,bps", CARDS)
def test_no_split_for_small_f_or_many_tiles(sms, bps):
    for n in (1, 129, 1800, 4000):
        for f in (1, 3, 500, SLAB * (2 * pairwise.MIN_SPLIT_SLABS - 1)):
            assert _split_plan(n, f, sms, bps) == 1, (n, f)
    wave = sms * bps
    for n in (TILE * 60, 20000):
        assert _tiles(n) >= pairwise.FULL_WAVES * wave
        assert _split_plan(n, 150528, sms, bps) == 1


def test_classic_path_shape_fills_whole_waves():
    """N = 1800 frames of 224 x 224 x 3 on an H100 (132 SMs): 120 tiles x
    11 splits = 1320 blocks, 5 waves of two blocks per SM (10 of one)."""
    for bps in (1, 2):
        s = _split_plan(1800, 150528, 132, bps)
        assert s == 11
        assert _tiles(1800) * s % (132 * bps) == 0
    assert _split_plan(1800, 150528, 132, 2) * _tiles(1800) == 1320


@pytest.mark.parametrize("f,want", [(512, 1), (640, 1), (12800, 11)])
def test_classic_resnet_feature_shapes(f, want):
    """-f ResNet (F = 512: 32 slabs, exactly MIN_SPLIT_SLABS, so no split;
    one wave of 120 blocks on an H100) and ResNet_VGGish (F = 512 + 12288:
    the RGB path's 11 splits) at N = 1800."""
    assert -(-f // pairwise.SLAB) >= pairwise.MIN_SPLIT_SLABS
    assert _split_plan(1800, f, 132, 2) == want


@pytest.mark.parametrize("sms,bps", CARDS)
def test_plan_fills_the_last_wave_best_and_bounds_the_workspace(sms, bps):
    wave = sms * bps
    for n, f in SHAPES:
        s = _split_plan(n, f, sms, bps)
        tiles = _tiles(n)
        ws = s * tiles * TILE * TILE * 4
        assert s == 1 or ws <= pairwise.WORKSPACE_CAP
        assert s == 1 or -(-f // SLAB) // s >= pairwise.MIN_SPLIT_SLABS

        def fill(k):
            return tiles * k / (-(-tiles * k // wave) * wave)
        if tiles < pairwise.FULL_WAVES * wave:
            s_max = max(1, min(-(-f // SLAB) // pairwise.MIN_SPLIT_SLABS,
                               pairwise.WORKSPACE_CAP
                               // (tiles * TILE * TILE * 4)))
            assert fill(s) == max(fill(k) for k in range(1, s_max + 1))
            assert all(fill(k) < fill(s) for k in range(1, s))

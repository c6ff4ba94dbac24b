"""The launch plan of the fused_stage kernel (avtex_torch/ops/stage_fused.py):
each block's output tile, consumer warpgroups and weight-ring depth, and
the shared memory they take. The plan is pure Python, so it is held here on
the CPU; the kernel that follows it runs on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 8)."""

import pytest

from avtex_torch.ops import stage_fused as sf

# (h, w, cin, f, cout, stride): the main path's seven blocks of slow res2
# (SFBottleneck_0/2/4) and res3 (_6/8/10/12) of SlowFast-R50 ...
PATH = [(56, 56, 80, 64, 256, 1), (56, 56, 256, 64, 256, 1),
        (56, 56, 256, 64, 256, 1), (56, 56, 320, 128, 512, 2),
        (28, 28, 512, 128, 512, 1), (28, 28, 512, 128, 512, 1),
        (28, 28, 512, 128, 512, 1)]
# ... and the small and ragged blocks of phase 8 and the GPU tests
SMALL = [(16, 16, 24, 16, 64, 1), (16, 16, 64, 16, 64, 1),
         (16, 16, 24, 16, 64, 2), (8, 8, 64, 16, 64, 2),
         (15, 13, 24, 16, 64, 1), (15, 13, 64, 16, 64, 1),
         (15, 13, 64, 32, 128, 1), (15, 13, 128, 32, 128, 1),
         (28, 28, 512, 128, 512, 1), (56, 56, 80, 64, 256, 1),
         (56, 56, 320, 128, 512, 2), (8, 8, 24, 16, 64, 1),
         (1, 1, 24, 16, 64, 1), (2, 2, 24, 32, 64, 2), (3, 50, 64, 48, 96, 1)]
SHAPES = PATH + SMALL


def _covered(p, ho, wo):
    """How often each output pixel falls in a tile of the plan's grid
    (block b owns tile b % tiles of slice b / tiles, row-major over
    tiles_w)."""
    th, tw = p["tile"]
    tiles_h, tiles_w = -(-ho // th), -(-wo // tw)
    assert tiles_h * tiles_w == p["tiles"]
    seen = [[0] * wo for _ in range(ho)]
    for tile in range(p["tiles"]):
        oh0, ow0 = tile // tiles_w * th, tile % tiles_w * tw
        for i in range(th):
            for j in range(tw):
                if oh0 + i < ho and ow0 + j < wo:  # the epilogue's mask
                    seen[oh0 + i][ow0 + j] += 1
    return seen


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_fits_shared_memory_and_covers_every_pixel_once(shape):
    h, w, cin, f, cout, s = shape
    p = sf.plan(h, w, cin, f, cout, s)
    ho, wo = h // s, w // s
    assert p["smem_bytes"] <= 232448
    assert p["smem_bytes"] == sf.smem_bytes(f, p["warpgroups"],
                                            p["b_stages"], p["halo_rows"])
    th, tw = p["tile"]
    assert 1 <= th <= ho and 1 <= tw <= wo
    assert th * tw <= sf.BM * p["warpgroups"]
    assert p["warpgroups"] in sf.WARPGROUPS
    assert p["b_stages"] in sf.B_STAGES
    assert all(n == 1 for row in _covered(p, ho, wo) for n in row)
    hh, hw = p["halo"]
    assert (hh, hw) == ((th - 1) * s + 3, (tw - 1) * s + 3)
    assert p["halo_rows"] == hh * hw
    assert 0 <= p["padded_share"] < 1
    assert p["ctas_per_sm"] in (1, 2)
    assert p["ctas"] == p["tiles"]  # bt = 1


@pytest.mark.parametrize("shape", PATH)
def test_path_widths_are_not_padded(shape):
    """F = 64 / 128 multiply at their width, C_out = 256 / 512 in whole
    128-column chunks; only the small test widths pad."""
    h, w, cin, f, cout, s = shape
    p = sf.plan(h, w, cin, f, cout, s, bt=1200)
    assert p["product_widths"] == (f, cout)
    assert p["ctas"] == 1200 * p["tiles"]
    assert sf.plan(h, w, cin, f, cout, s, bt=1200) == p  # deterministic
    # res2 and res3's later blocks fit two blocks an SM; their halo is at
    # most two 64-row chunks (stride 1)
    if s == 1:
        assert p["ctas_per_sm"] * p["warpgroups"] >= 2
        assert p["halo_rows"] <= 2 * sf.BM * p["warpgroups"]


@pytest.mark.parametrize("f", [16, 32, 48])
def test_small_widths_pad_to_64_columns(f):
    p = sf.plan(16, 16, 24, f, 64, 1)
    assert p["product_widths"] == (64, 128)


def test_plan_is_the_least_weighted_work_among_its_options():
    """No other tile the plan could have taken at the same depth and
    warpgroups has less padded work, weighted by ONE_WG_RATE where an SM
    holds one consumer warpgroup."""
    for h, w, cin, f, cout, s in SHAPES:
        best = sf.plan(h, w, cin, f, cout, s)
        ho, wo = h // s, w // s

        def cost(p):
            work = 1 / (1 - p["padded_share"])  # per needed operation
            rate = (1.0 if p["warpgroups"] * p["ctas_per_sm"] >= 2
                    else sf.ONE_WG_RATE)
            return work / rate
        m = sf.BM * best["warpgroups"]
        for th in range(1, min(ho, m) + 1):
            tw = min(wo, m // th)
            for st in sf.B_STAGES:
                try:
                    other = sf.plan(h, w, cin, f, cout, s, tile=(th, tw),
                                    warpgroups=best["warpgroups"],
                                    b_stages=st)
                except ValueError:  # over the shared memory
                    continue
                assert cost(best) <= cost(other) * (1 + 1e-12)


def test_pinned_plans_and_refusals():
    p = sf.plan(56, 56, 320, 128, 512, 2, tile=(8, 8), b_stages=2)
    assert p["tile"] == (8, 8) and p["b_stages"] == 2
    assert p["halo"] == (17, 17)
    with pytest.raises(ValueError):  # more pixels than 64 rows
        sf.plan(56, 56, 80, 64, 256, 1, tile=(9, 8))
    with pytest.raises(ValueError):  # outside the output
        sf.plan(8, 8, 24, 16, 64, 2, tile=(5, 1))
    with pytest.raises(ValueError):  # a 17 x 33 halo: over 227 KB
        sf.plan(56, 56, 320, 128, 512, 2, tile=(8, 16), warpgroups=2,
                b_stages=4)

"""Tests that need an NVIDIA GPU (marked ``cuda``; they skip elsewhere).

On a machine with a card, without JAX installed::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same inputs.
fused_conv1x1: both accumulate in fp32 and round to bf16 once, so they
differ by the accumulation order and one bf16 rounding of the output
(tolerance 2e-2 relative + 2e-2 absolute, as tests/test_fused_matmul.py).
pairwise_l2: both are fp32 Gram forms, so their squared distances differ
by rounding at the scale of the operands (tolerance 1e-5 (|x_i|^2 +
|x_j|^2)).
fused_stage: both round to bf16 after each conv's ReLU and at each
block's output, summing in other orders: one block within 2e-2 relative +
2e-2 absolute; a whole stage within 1e-2 relative Frobenius error.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(M, K, N, residual, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(M, K, generator=g).to(device, torch.bfloat16)
    w = (torch.randn(N, K, generator=g) * K ** -0.5).to(device,
                                                        torch.bfloat16)
    scale = (torch.rand(N, generator=g) + 0.5).to(device)
    bias = (torch.randn(N, generator=g) * 0.1).to(device)
    r = (torch.randn(M, N, generator=g).to(device, torch.bfloat16)
         if residual else None)
    return x, w, scale, bias, r


@pytest.mark.parametrize("M,K,N,residual,relu", [
    (1000, 320, 128, False, True),      # ragged M
    (392 * 3, 1280, 2048, False, False),
    (777, 128, 512, True, True),
    (300, 104, 200, True, True),        # K not a multiple of the k slab
    (129, 24, 200, False, True),        # K < k slab, N not a multiple of 128
    (128 * 600 + 37, 128, 512, True, True),   # ragged M, > 4 x 132 tiles
    (128 * 300 + 77, 104, 384, True, False),  # N-chunk tail of 128
    (5000, 1280, 384, True, True),
    (37, 24, 384, True, True),          # M < 64: one half tile only
    (50, 320, 200, False, True),
    (4096, 80, 64, False, True),        # the 64-channel shapes' tile
    (4096, 64, 256, True, True),
])
def test_kernel_matches_plain_version(cuda, M, K, N, residual, relu):
    from avtex_torch.ops import fused_matmul
    x, w, scale, bias, r = _operands(M, K, N, residual, cuda)
    before = fused_matmul.launches
    got = fused_matmul.fused_conv1x1(x, w, scale, bias, r, relu)
    torch.cuda.synchronize()
    assert fused_matmul.launches == before + 1
    want = fused_matmul.fused_conv1x1_reference(x, w, scale, bias, r, relu)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_persistent_schedule_many_tiles_per_sm(cuda):
    """Over 10 output tiles per SM: every block walks many tiles, through
    the ring and the epilogue buffer many times."""
    from avtex_torch.ops import fused_matmul
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    M = 128 * 11 * sms + 5
    x, w, scale, bias, r = _operands(M, 128, 256, True, cuda)
    got = fused_matmul.fused_conv1x1(x, w, scale, bias, r, True)
    want = fused_matmul.fused_conv1x1_reference(x, w, scale, bias, r, True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_kernel_is_deterministic(cuda):
    """No atomics: repeated calls give bit-identical output."""
    from avtex_torch.ops import fused_conv1x1
    x, w, scale, bias, r = _operands(128 * 40 + 3, 320, 512, True, cuda)
    first = fused_conv1x1(x, w, scale, bias, r, True)
    for _ in range(3):
        assert torch.equal(fused_conv1x1(x, w, scale, bias, r, True), first)


def test_kernel_refuses_float32_on_cuda(cuda):
    from avtex_torch.ops import fused_matmul
    x, w, scale, bias, _ = _operands(64, 32, 16, False, cuda)
    before = fused_matmul.launches
    with pytest.raises(TypeError):
        fused_matmul.fused_conv1x1(x.float(), w.float(), scale, bias)
    assert fused_matmul.launches == before


@pytest.mark.parametrize("K,N,offset,res_offset", [
    (100, 200, 0, None),    # K % 8 != 0
    (24, 9, 0, None),       # odd N
    (24, 12, 0, None),      # N % 8 != 0
    (24, 200, 1, None),     # x starts 2 bytes past a 16-byte boundary
    (24, 200, 0, 1),        # so does the residual
])
def test_kernel_refuses_shapes_it_does_not_take(cuda, K, N, offset,
                                                res_offset):
    from avtex_torch.ops import fused_matmul
    x, w, scale, bias, _ = _operands(65, K, N, False, cuda)
    x = x.view(-1)[offset:offset + 64 * K].view(64, K)
    r = None
    if res_offset is not None:
        r = torch.zeros(65 * N, device=cuda, dtype=torch.bfloat16)
        r = r[res_offset:res_offset + 64 * N].view(64, N)
    before = fused_matmul.launches
    with pytest.raises(ValueError):
        fused_matmul.fused_conv1x1(x, w, scale, bias, r)
    assert fused_matmul.launches == before


# --------------------------------------------------------------------- #
# pairwise_l2 (avtex_torch/csrc/pairwise_l2.cu)
# --------------------------------------------------------------------- #

def _rgb_rows(n, f, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, 256, (n, f), generator=g).float().to(device)


@pytest.mark.parametrize("n,f,normalize", [
    (129, 1001, False),     # ragged rows and features (scalar loads)
    (777, 12292, False),    # 16-byte loads, ragged last k slab
    (300, 4099, True),
    (1, 3, False),
])
def test_pairwise_kernel_matches_plain_version(cuda, n, f, normalize):
    """Squared distances within 1e-5 (|x_i|^2 + |x_j|^2) of the plain
    version (the Gram form's cancellation scale), exact zero diagonal."""
    from avtex_torch.ops import pairwise
    x = _rgb_rows(n, f, cuda)
    before = pairwise.launches
    got = pairwise.pairwise_l2(x, normalize=normalize)
    torch.cuda.synchronize()
    assert pairwise.launches == before + 1
    want = pairwise.pairwise_l2_reference(x, normalize=normalize)
    rows = pairwise._rows(x, normalize).double()
    sq = (rows * rows).sum(1)
    err = (got.double() ** 2 - want.double() ** 2).abs()
    assert bool((err <= 1e-5 * (sq[:, None] + sq[None, :])).all())
    assert bool((got.diagonal() == 0).all())
    assert bool((got == got.t()).all())


@pytest.mark.parametrize("n,f", [
    (1, 150528),     # one row, F cut into many splits
    (129, 12289),    # scalar loads, a ragged last split
    (777, 12292),    # 28 tiles x S blocks: not a whole number of waves
    (1800, 500),     # the classic path's N, F shorter than one split
    (600, 150528),   # the classic path's F
    (300, 100003),   # scalar loads over many splits, ragged last slab
])
def test_pairwise_split_cases_match_plain_version(cuda, n, f):
    """Every split plan against the plain version within 1e-5 (|x_i|^2 +
    |x_j|^2); the output exactly symmetric with an exact zero diagonal,
    and a second launch bit-identical (the splits are summed in a fixed
    order)."""
    from avtex_torch.ops import pairwise
    x = _rgb_rows(n, f, cuda)
    p = pairwise.plan(n, f, cuda)
    assert p["splits"] == pairwise._split_plan(n, f, p["sms"],
                                               p["blocks_per_sm"])
    assert (p["splits"] > 1) == (f > 2 * 16 * pairwise.MIN_SPLIT_SLABS)
    got = pairwise.pairwise_l2(x)
    again = pairwise.pairwise_l2(x)
    torch.cuda.synchronize()
    want = pairwise.pairwise_l2_reference(x)
    sq = (x.double() ** 2).sum(1)
    err = (got.double() ** 2 - want.double() ** 2).abs()
    assert bool((err <= 1e-5 * (sq[:, None] + sq[None, :])).all())
    assert bool((got.diagonal() == 0).all())
    assert torch.equal(got, got.t())
    assert torch.equal(got, again)


def test_pairwise_two_gram_blocks_per_sm(cuda):
    """127 registers and 112 KB of shared memory: two Gram-kernel blocks
    share an SM, the occupancy the split plan counts waves in."""
    from avtex_torch.ops import pairwise
    assert pairwise.plan(1800, 150528, cuda)["blocks_per_sm"] == 2


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "cpu_sq"])
def test_pairwise_kernel_refuses_what_it_does_not_take(cuda, bad):
    from avtex_torch.ops import pairwise
    x = _rgb_rows(64, 40, cuda)
    before = pairwise.launches
    if bad == "float64":
        with pytest.raises(TypeError):
            pairwise.pairwise_l2(x.double())
    elif bad == "non_contiguous":
        with pytest.raises(ValueError):
            pairwise.pairwise_l2(x[:, ::2])
    else:  # rows on the card, their norms on the host
        with pytest.raises(ValueError):
            pairwise.pairwise_l2_gram(x, (x * x).sum(1).cpu())
    assert pairwise.launches == before


# --------------------------------------------------------------------- #
# fused_stage (avtex_torch/csrc/fused_stage.cu)
# --------------------------------------------------------------------- #

def _stage(cin, f, cout, n_blocks, device, proj=True, seed=0):
    """Random blocks whose activations stay O(1): weights ~ N(0, 1/K)."""
    from avtex_torch.ops.stage_fused import BlockWeights
    g = torch.Generator(device="cpu").manual_seed(seed)

    def mk(*shape):
        return (torch.randn(*shape, generator=g)
                * (shape[-2] if len(shape) == 2 else 9 * shape[-2]) ** -0.5
                ).to(device)

    def aff(n):
        return ((torch.rand(n, generator=g) + 0.5).to(device),
                (torch.randn(n, generator=g) * 0.1).to(device))

    blocks, c = [], cin
    for i in range(n_blocks):
        p = proj and i == 0
        s1, b1 = aff(f)
        s2, b2 = aff(f)
        s3, b3 = aff(cout)
        sp, bp = aff(cout) if p else (None, None)
        blocks.append(BlockWeights(
            w1=mk(c, f), s1=s1, b1=b1, w2=mk(3, 3, f, f), s2=s2, b2=b2,
            w3=mk(f, cout), s3=s3, b3=b3, wp=mk(c, cout) if p else None,
            sp=sp, bp=bp))
        c = cout
    return blocks


@pytest.mark.parametrize("bt,h,w,cin,f,cout,stride,proj", [
    (6, 16, 16, 24, 16, 64, 1, True),       # avtex's test shapes
    (6, 16, 16, 24, 16, 64, 2, True),
    (7, 15, 13, 64, 32, 128, 1, True),      # odd H, W; ragged tiles
    (5, 28, 28, 512, 128, 512, 1, False),   # res3's later blocks
    (3, 56, 56, 80, 64, 256, 1, True),      # res2 block 0
    (2, 56, 56, 320, 128, 512, 2, True),    # res3 block 0
])
def test_stage_block_matches_plain_version(cuda, bt, h, w, cin, f, cout,
                                           stride, proj):
    """One block: elementwise within 2e-2 |ref| + 2e-2 (a one-ulp bf16
    difference in y1 or y2 moves the output by about one ulp)."""
    from avtex_torch.ops import stage_fused
    blocks = _stage(cin, f, cout, 1, cuda, proj)
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(bt, h, w, cin, generator=g).to(cuda, torch.bfloat16)
    before = stage_fused.launches
    if proj:
        got = stage_fused.fused_stage(x, blocks, stride)
        want = stage_fused.stage_reference(x, blocks, stride)
    else:  # a stage's later block: only the launch takes it alone
        got = stage_fused.launch_block(
            x, stage_fused.pack_block(blocks[0], cuda), stride)
        want = stage_fused._block_reference(x, blocks[0], stride)
    torch.cuda.synchronize()
    assert stage_fused.launches == before + 1
    assert got.shape == want.shape == (bt, h // stride, w // stride, cout)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("cin,f,cout,n_blocks,stride", [
    (80, 64, 256, 3, 1),      # slow res2
    (320, 128, 512, 4, 2),    # slow res3
])
def test_path_stage_matches_plain_version(cuda, cin, f, cout, n_blocks,
                                          stride):
    """A whole stage at a small BT: relative Frobenius error <= 1e-2."""
    from avtex_torch.ops import stage_fused
    blocks = _stage(cin, f, cout, n_blocks, cuda)
    g = torch.Generator(device="cpu").manual_seed(2)
    x = torch.randn(3, 56, 56, cin, generator=g).to(cuda, torch.bfloat16)
    before = stage_fused.launches
    got = stage_fused.fused_stage(x, blocks, stride).float()
    torch.cuda.synchronize()
    assert stage_fused.launches == before + n_blocks
    want = stage_fused.stage_reference(x, blocks, stride).float()
    assert bool(torch.isfinite(got).all())
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    assert rel <= 1e-2, rel


@pytest.mark.parametrize("cin,f,cout", [(12, 16, 64),    # C_in % 8
                                        (24, 8, 64),     # F % 16
                                        (24, 256, 64),   # F > 128
                                        (24, 16, 72)])   # C_out % 16
def test_stage_kernel_refuses_shapes_it_does_not_take(cuda, cin, f, cout):
    from avtex_torch.ops import stage_fused
    blocks = _stage(cin, f, cout, 1, cuda)
    x = torch.zeros(2, 8, 8, cin, device=cuda, dtype=torch.bfloat16)
    before = stage_fused.launches
    with pytest.raises(ValueError):
        stage_fused.fused_stage(x, blocks, 1)
    assert stage_fused.launches == before


def test_stage_launch_refuses_float32(cuda):
    from avtex_torch.ops import stage_fused
    blocks = _stage(24, 16, 64, 1, cuda)
    x = torch.zeros(2, 8, 8, 24, device=cuda)
    with pytest.raises(TypeError):
        stage_fused.launch_block(x, stage_fused.pack_block(blocks[0], cuda),
                                 1)


def _one_block(cin, f, cout, proj, cuda, bt, h, w, seed=3):
    from avtex_torch.ops import stage_fused
    blk = _stage(cin, f, cout, 1, cuda, proj, seed)[0]
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    x = torch.randn(bt, h, w, cin, generator=g).to(cuda, torch.bfloat16)
    return x, blk, stage_fused.pack_block(blk, cuda)


@pytest.mark.parametrize("f,stride", [(16, 1), (16, 2), (32, 1), (32, 2),
                                      (48, 1)])
def test_stage_padded_widths_match_plain_version(cuda, f, stride):
    """F below 64 multiplies padded to 64 columns: the zero-filled weight
    rows and the masked epilogue leave the plain version's output."""
    from avtex_torch.ops import stage_fused
    x, blk, packed = _one_block(40, f, 96, True, cuda, 5, 14, 18)
    p = stage_fused.plan(14, 18, 40, f, 96, stride)
    assert p["product_widths"] == (64, 128)
    got = stage_fused.launch_block(x, packed, stride, p)
    want = stage_fused._block_reference(x, blk, stride)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_stage_res3_block0_under_its_shared_memory_plan(cuda):
    """Res3 block 0 (stride 2, C_in 320, F 128): the largest halo; the
    kernel's own shared-memory count and occupancy agree with the plan."""
    from avtex_torch.ops import stage_fused
    x, blk, packed = _one_block(320, 128, 512, True, cuda, 3, 56, 56)
    p = stage_fused.plan(56, 56, 320, 128, 512, 2, bt=3)
    assert stage_fused.kernel_plan_check(p, 128, cuda) == {
        "smem_bytes": p["smem_bytes"], "ctas_per_sm": p["ctas_per_sm"]}
    got = stage_fused.launch_block(x, packed, 2, p)
    want = stage_fused._block_reference(x, blk, 2)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("shape,tile", [
    ((56, 56, 80, 64, 256, 1), (8, 12)),   # 140 halo rows: the second
                                           # warpgroup's last chunk is padding
    ((28, 28, 512, 128, 512, 1), (4, 8)),  # 32 pixels: the second warpgroup
                                           # multiplies only padding rows
    ((56, 56, 320, 128, 512, 2), (4, 8)),  # stride 2, 9 x 17 halo
])
def test_stage_two_warpgroups_with_a_padding_warpgroup(cuda, shape, tile):
    from avtex_torch.ops import stage_fused
    h, w, cin, f, cout, s = shape
    x, blk, packed = _one_block(cin, f, cout, cin != cout or s != 1, cuda,
                                2, h, w)
    p = stage_fused.plan(h, w, cin, f, cout, s, tile=tile, warpgroups=2,
                         b_stages=3)
    assert stage_fused.kernel_plan_check(p, f, cuda)["smem_bytes"] == \
        p["smem_bytes"]
    got = stage_fused.launch_block(x, packed, s, p)
    want = stage_fused._block_reference(x, blk, s)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_stage_second_launch_is_bit_identical(cuda):
    """No atomics and a fixed order of every sum: a repeat launch on the
    same inputs gives the same bits."""
    from avtex_torch.ops import stage_fused
    blocks = _stage(80, 64, 256, 3, cuda)
    g = torch.Generator(device="cpu").manual_seed(4)
    x = torch.randn(4, 56, 56, 80, generator=g).to(cuda, torch.bfloat16)
    first = stage_fused.fused_stage(x, blocks, 1)
    assert torch.equal(stage_fused.fused_stage(x, blocks, 1), first)


_RES2_B0 = (56, 56, 80, 64, 256, 1)


@pytest.mark.parametrize("shape,bad", [
    (_RES2_B0, dict(tile=(9, 8), warpgroups=1, b_stages=4)),  # 72 > 64 rows
    (_RES2_B0, dict(tile=(1, 57), warpgroups=1, b_stages=4)),  # past W
    (_RES2_B0, dict(tile=(8, 8), warpgroups=3, b_stages=4)),
    (_RES2_B0, dict(tile=(8, 8), warpgroups=1, b_stages=1)),
    (_RES2_B0, dict(tile=(8, 8), warpgroups=1, b_stages=9)),
    # res3 block 0 at two warpgroups, 8 x 16: a 17 x 33 halo, over 227 KB
    ((56, 56, 320, 128, 512, 2), dict(tile=(8, 16), warpgroups=2,
                                      b_stages=4)),
])
def test_stage_launcher_refuses_a_plan_it_cannot_run(cuda, shape, bad):
    """The launcher returns an error, nothing runs, the counter stays."""
    from avtex_torch.ops import stage_fused
    h, w, cin, f, cout, s = shape
    x, _, packed = _one_block(cin, f, cout, True, cuda, 1, h, w)
    before = stage_fused.launches
    with pytest.raises(RuntimeError):
        stage_fused.launch_block(x, packed, s, bad)
    assert stage_fused.launches == before


# ---- modules on stock torch ops: s2d stems, SuperSloMo, checkpoints ----- #
# s2d stem vs plain stem in bf16: each conv output rounds an fp32 sum to
# bf16 once (one ulp apart at most) and the affine rounds twice, so both
# agree within 2^-6 of the largest |conv * scale| (chip_smoke.py phase 4b).

@pytest.mark.parametrize("kt,o,f", [(1, 64, 4), (5, 8, 4), (5, 8, 8)])
def test_s2d_stem_bf16_matches_plain_stem(cuda, kt, o, f):
    from avtex_torch.ops import s2d_stem as st
    g = torch.Generator(device="cpu").manual_seed(kt + o + f)
    x = torch.randn(4, 8, 64, 64, 3, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(o, 3, kt, 7, 7, generator=g) / 8).to(cuda,
                                                           torch.bfloat16)
    sc = (1 + 0.25 * torch.randn(o, generator=g)).to(cuda)
    bi = (0.25 * torch.randn(o, generator=g)).to(cuda)
    plain = st.stem_pooled_plain(x, w, sc, bi)
    tol = 2.0 ** -6 * float(
        (st.stem_conv_plain(x, w).float() * sc).abs().amax())
    outs = [st.fast_stem_s2d_pooled(x, w, sc, bi, f=f, pool=p)
            for p in st.POOLS]
    assert torch.equal(outs[0], outs[1])
    assert outs[0].shape == plain.shape
    assert float((outs[0].float() - plain.float()).abs().max()) <= tol
    conv = st.fast_stem_s2d(x, w)
    assert float((conv.float() - st.stem_conv_plain(x, w).float()
                  ).abs().max()) <= tol


def test_encoder_with_s2d_stems_matches_plain_stems(cuda):
    from avtex_torch.config import Config
    from avtex_torch.nn.slowfast import SlowFastR50
    from avtex_torch.synth.pipeline import init_params_for_synthesis
    enc = SlowFastR50(width=16, layers=(1, 1, 1, 1), norm="affine")
    enc.load_state_dict(init_params_for_synthesis(
        Config(enc_arch="slowfast", norm="affine"), enc))
    enc = enc.to(cuda).eval()
    g = torch.Generator(device="cpu").manual_seed(0)
    slow = torch.randn(4, 8, 64, 64, 3, generator=g).to(cuda)
    fast = torch.randn(4, 32, 64, 64, 3, generator=g).to(cuda)
    with torch.no_grad():
        a = enc(slow, fast)
        enc.s2d_stem = False
        b = enc(slow, fast)
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    assert torch.isfinite(a).all() and float(cos.min()) >= 0.999


def test_superslomo_bf16_matches_fp32(cuda, tmp_path):
    """The loader's bf16 net against the same weights in fp32, on uint8
    mid frames: mean |diff| <= 1 level, max <= 32 (chip_smoke.py 5b)."""
    import numpy as np
    from avtex_torch.checkpoints import (maybe_make_slomo_interp_fn,
                                         save_slomo_checkpoint)
    from avtex_torch.synth.interp import init_slomo
    path = save_slomo_checkpoint(
        init_slomo(seed=0, dtype=torch.float32, device="cpu"),
        str(tmp_path / "SuperSloMo.ckpt"))
    bf16 = maybe_make_slomo_interp_fn(path, device=cuda)
    fp32 = maybe_make_slomo_interp_fn(path, device=cuda,
                                      dtype=torch.float32)
    g = np.random.default_rng(0)
    yy, xx = np.mgrid[0:100, 0:136]
    f0 = np.clip(127 + 90 * np.sin(xx / 9)[..., None]
                 + 20 * g.standard_normal((100, 136, 3)), 0, 255)
    f1 = np.roll(f0, 3, axis=1)
    a = bf16(f0.astype(np.uint8), f1.astype(np.uint8), 4).astype(int)
    b = fp32(f0.astype(np.uint8), f1.astype(np.uint8), 4).astype(int)
    assert a.shape == b.shape == (4, 100, 136, 3)
    d = np.abs(a - b)
    assert d.mean() <= 1.0 and d.max() <= 32


def test_checkpoint_round_trip_of_a_cuda_model(cuda, tmp_path):
    from avtex_torch.contrastive.model import ContrastiveTextures
    from avtex_torch.convert import convert_params, export_params
    from avtex_torch.synth.pipeline import init_params_for_synthesis
    from avtex_torch.config import Config
    from avtex_torch.train import restore_checkpoint, save_checkpoint
    kw = dict(arch="slowfast", norm="affine", width=16, layers=(1, 1, 1, 1))
    model = ContrastiveTextures(**kw)
    model.load_state_dict(init_params_for_synthesis(
        Config(enc_arch="slowfast", norm="affine"), model))
    model = model.to(cuda).eval()
    path = save_checkpoint(str(tmp_path), "run",
                           export_params(model.state_dict()), 1, "slowfast",
                           0.5, True)
    again = ContrastiveTextures(**kw)
    again.load_state_dict(convert_params(restore_checkpoint(path)["state"],
                                         again))
    again = again.to(cuda).eval()
    g = torch.Generator(device="cpu").manual_seed(1)
    clips = (torch.randn(2, 8, 64, 64, 3, generator=g).to(cuda),
             torch.randn(2, 32, 64, 64, 3, generator=g).to(cuda))
    with torch.no_grad():
        for tower in ("query", "target"):
            assert torch.equal(model.embed(clips, tower=tower),
                               again.embed(clips, tower=tower))


# --------------------------------------------------------------------- #
# Training: one step on the card
# --------------------------------------------------------------------- #

def _train_case(arch, device, dtype):
    """A width-16 encoder at 64 px, LR 1e-3 (chip_smoke.py's phase 9 (e)
    says why not narrower), on ``device``."""
    import numpy as np
    from avtex_torch.config import Config
    from avtex_torch.contrastive.model import ContrastiveTextures
    from avtex_torch.data.pipeline import SegmentBatches
    from avtex_torch.synth.pipeline import flax_style_init
    from avtex_torch.train import create_state, make_train_step
    kw = dict(width=16)
    if arch == "slowfast":
        kw["layers"] = (1, 1, 1, 1)
    cfg = Config(enc_arch=arch, img_size=64, n_negs=2, batch_size=2,
                 lr=1e-3)
    model = ContrastiveTextures(arch, dtype=dtype, remat=True, **kw)
    params = flax_style_init(model, 0)
    state = create_state(model.to(device), cfg, 1, params)
    video = np.random.default_rng(0).integers(0, 256, (30, 72, 72, 3),
                                              dtype=np.uint8)
    batch = next(SegmentBatches(video, 8, 2, n_negs=2, batch_size=2).epoch(0))
    return state, make_train_step(model, 64, arch == "slowfast"), batch


@pytest.mark.parametrize("arch", ["resnet10", "slowfast"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One fp32 step (TF32 off, augmentation drawn from the same CPU
    generator) from the same parameters on the card and on the CPU
    (oneDNN off, tests/test_torch_train.py says why): loss within 1e-4,
    all master parameters together within 1e-4 relative L2 (single
    GroupNorm biases' gradients come out of cancellation)."""
    runs = {}
    for dev in ("cpu", cuda):
        with torch.backends.cudnn.flags(allow_tf32=False), \
                torch.backends.mkldnn.flags(enabled=False):
            state, step, batch = _train_case(arch, dev, torch.float32)
            state, m = step(state, batch, torch.Generator().manual_seed(0))
        runs[str(dev)] = (float(m["loss"]),
                          {n: p.detach().cpu()
                           for n, p in state.params.items()})
    (lc, pc), (lg, pg) = runs["cpu"], runs[str(cuda)]
    assert abs(lc - lg) <= 1e-4
    diff = sum(float(((pc[n] - pg[n]) ** 2).sum()) for n in pc)
    norm = sum(float((p ** 2).sum()) for p in pc.values())
    assert (diff / norm) ** 0.5 <= 1e-4


def test_bf16_train_step_on_the_card_steps_the_master_copy(cuda):
    state, step, batch = _train_case("resnet10", cuda, torch.bfloat16)
    before = {n: p.clone() for n, p in state.params.items()}
    state, m = step(state, batch, torch.Generator().manual_seed(0))
    assert torch.isfinite(m["loss"]) and state.step == 1
    for n, p in state.model.named_parameters():
        assert state.params[n].dtype == torch.float32
        assert torch.equal(p.detach(), state.params[n].to(p.dtype)), n
    assert any(not torch.equal(before[n], p)
               for n, p in state.params.items())


# --------------------------------------------------------------------- #
# Audio: the log-mel frontend, VGGish, a driving-audio request
# --------------------------------------------------------------------- #

def _tone(seconds, sr, seed=0):
    import numpy as np
    g = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.4 * np.sin(2 * np.pi * 440 * t * (1 + 0.2 * np.sin(3 * t))) \
        + 0.05 * g.standard_normal(len(t))
    x[: len(x) // 6] *= 1e-3  # quiet frames, where log(x + 0.01) is steep
    return x.astype(np.float32)


@pytest.mark.parametrize("sr", [16000, 44100])
def test_mel_frontend_on_the_card_matches_the_cpu(cuda, sr):
    """cuFFT and the CPU's FFT round differently: log-mel within 1e-3
    (chip_smoke.py phase 5d's gate), the product in fp32 (no TF32)."""
    from avtex_torch.audio import waveform_to_examples
    x = _tone(6.0, sr)
    got = waveform_to_examples(x, sr, device=cuda)
    want = waveform_to_examples(x, sr, device="cpu")
    assert got.device.type == "cuda" and got.shape == want.shape
    assert float((got.cpu() - want).abs().max()) <= 1e-3


def test_vggish_bf16_matches_fp32(cuda):
    """The same weights in bf16 (avtex's default) and fp32: cosine per
    row >= 0.999 (chip_smoke.py phase 5d)."""
    from avtex_torch.audio import waveform_to_examples
    from avtex_torch.nn.vggish import VGGish
    from avtex_torch.synth.embeddings import vggish_audio_features
    from avtex_torch.synth.pipeline import flax_style_init
    state = flax_style_init(VGGish(torch.float32), 0)
    nets = {}
    for dt in (torch.bfloat16, torch.float32):
        nets[dt] = VGGish(dt)
        nets[dt].load_state_dict(state)
        nets[dt] = nets[dt].to(cuda).eval()
    ex = waveform_to_examples(_tone(10.0, 22050, 1), 22050, device=cuda)
    a = vggish_audio_features(nets[torch.bfloat16], ex)
    b = vggish_audio_features(nets[torch.float32], ex)
    assert a.shape == b.shape == (len(ex), 12288)
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    assert torch.isfinite(a).all() and float(cos.min()) >= 0.999


def test_driving_audio_request_on_the_card(cuda, tmp_path):
    import numpy as np
    from avtex_torch.config import Config
    from avtex_torch.media import read_wav, write_wav
    from avtex_torch.synth import TextureServer
    g = np.random.default_rng(0)
    t, res = 96, 64
    phase = np.sin(np.arange(t) / 5.0)
    frames = np.clip(127 + 60 * phase[:, None, None, None]
                     + 10 * g.standard_normal((t, res, res, 3)),
                     0, 255).astype(np.uint8)
    src = write_wav(str(tmp_path / "src.wav"), _tone(4.0, 22050, 2), 22050)
    drv = write_wav(str(tmp_path / "drv.wav"), _tone(3.0, 44100, 3), 44100)
    for daf in ("VGG", "Mel"):
        cfg = Config(enc_arch="slowfast", model_type=2, norm="affine",
                     img_size=64, mini_batchsize=16, da_feats=daf)
        server = TextureServer.from_frames(cfg, frames, 24.0, audio_path=src,
                                           device=cuda, width=16,
                                           layers=(1, 1, 1, 1))
        assert server.q_table.shape == (
            server.L, server.model.q_embedder.video_feat_dim + 12288)
        assert torch.isfinite(server.q_table).all()
        a = server.synthesize(seconds=10, driving_audio=drv, alpha=0.5,
                              seed=1)
        b = server.synthesize(seconds=10, driving_audio=drv, alpha=0.5,
                              seed=1)
        assert "scorer_s" in a["timings"] and "scorer_s" not in b["timings"]
        np.testing.assert_array_equal(a["result"].indices,
                                      b["result"].indices)
        assert a["sample_rate"] == 44100
        np.testing.assert_array_equal(a["audio"], read_wav(drv)[0])
        assert len(a["frames"]) < 10 * 24  # the 3 s clip sets the length


@pytest.mark.parametrize("audio", [False, True])
def test_device_walk_on_the_card_matches_the_cpu(cuda, audio):
    """The contrastive walk on the card and on the CPU from the same
    logits and noise: the same choices, statistics within rtol 1e-5 (sums
    in other orders)."""
    import numpy as np
    from avtex_torch.synth.engine import walk_logits
    g = torch.Generator(device="cpu").manual_seed(3)
    q = torch.randn(300, 64, generator=g).abs()
    q = q / q.norm(dim=1, keepdim=True)
    logits = (q @ q.roll(1, 0).t()) / 0.1
    noise = torch.rand(120, 300, generator=g)
    rows = torch.rand(120, 300, generator=g) / 0.1 if audio else None
    kw = dict(threshold=0.3, seed_id=5, noise=noise)
    cpu = walk_logits(logits, 120, audio_logits=rows, **kw)
    card = walk_logits(logits.to(cuda), 120, audio_logits=None if rows is None
                       else rows.to(cuda), **kw)
    for key in ("indices", "jumps", "nonzero_counts", "greedy_ids"):
        np.testing.assert_array_equal(getattr(card, key), getattr(cpu, key))
    np.testing.assert_allclose(card.entropies, cpu.entropies, rtol=1e-5)
    np.testing.assert_allclose(card.pos_prob, cpu.pos_prob, rtol=1e-5)


@pytest.mark.parametrize("advance", [0, 4])
def test_classic_walk_on_the_card_matches_the_cpu(cuda, advance):
    from avtex_torch.classic import sample_texture_walk
    g = torch.Generator(device="cpu").manual_seed(4)
    p = torch.rand(500, 500, generator=g)
    p = torch.where(p > 0.97, p, 0.0)
    p[torch.arange(499), torch.arange(1, 500)] = 1.0
    p[499, 0] = 1.0
    noise = torch.rand(400, 500, generator=g)
    cpu = sample_texture_walk(p, 7, 400, noise=noise, advance=advance)
    card = sample_texture_walk(p.to(cuda), 7, 400, noise=noise,
                               advance=advance)
    assert torch.equal(card[0].cpu(), cpu[0])
    assert torch.equal(card[1].cpu(), cpu[1])
    gen = torch.Generator(device=cuda).manual_seed(9)
    a = sample_texture_walk(p.to(cuda), 7, 50, generator=gen)
    gen = torch.Generator(device=cuda).manual_seed(9)
    b = sample_texture_walk(p.to(cuda), 7, 50, generator=gen)
    assert torch.equal(a[0], b[0]) and a[0].device.type == "cuda"

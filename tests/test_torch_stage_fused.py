"""The port's fused_stage (avtex_torch/ops/stage_fused.py) against avtex's
Pallas kernel in interpret mode and its jnp reference.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is
held against that plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 8). Same numpy inputs on both sides, small sizes.
Tolerance rtol = atol = 2e-2 (avtex's tests/test_stage_fused.py): both
sides round to bf16 after every conv's ReLU, so a one-ulp difference in y1
or y2 (sums in another order) moves the block's output by about a bf16 ulp.
The weights carried over from avtex's tree are compared bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avtex.nn.slowfast import SFBottleneck as JaxBottleneck
from avtex.nn.slowfast import SlowFastR50 as JaxSF
from avtex.ops import stage_fused as jax_stage
from avtex_torch.convert import convert_params
from avtex_torch.nn.slowfast import SFBottleneck, SlowFastR50
from avtex_torch.ops import stage_fused as port_stage
from avtex_torch.ops.stage_fused import (BlockWeights, fused_stage,
                                         stage_reference,
                                         stage_weights_from_params)

torch.set_num_threads(1)

CIN, F, COUT = 24, 16, 64   # avtex's test shapes
TOL = dict(rtol=2e-2, atol=2e-2)


def _np_block(g, cin, f, cout, proj):
    def mk(*shape, scale=0.1):
        return (g.standard_normal(shape) * scale).astype(np.float32)
    return dict(
        w1=mk(cin, f), s1=mk(f, scale=0.2) + 1, b1=mk(f),
        w2=mk(3, 3, f, f, scale=0.05), s2=mk(f, scale=0.2) + 1, b2=mk(f),
        w3=mk(f, cout), s3=mk(cout, scale=0.2) + 1, b3=mk(cout),
        wp=mk(cin, cout) if proj else None,
        sp=(mk(cout, scale=0.2) + 1) if proj else None,
        bp=mk(cout) if proj else None)


def _both(blocks):
    """numpy blocks -> (avtex BlockWeights, port BlockWeights)."""
    def conv(kind, wrap):
        return [kind(**{k: None if v is None else wrap(v)
                        for k, v in b.items()}) for b in blocks]
    return (conv(jax_stage.BlockWeights, jnp.asarray),
            conv(BlockWeights, torch.from_numpy))


def _stage_case(seed=0, bt=6, h=16, w=16):
    g = np.random.default_rng(seed)
    blocks = [_np_block(g, CIN, F, COUT, True),
              _np_block(g, COUT, F, COUT, False)]
    x = g.standard_normal((bt, h, w, CIN)).astype(np.float32)
    return x, blocks


def _port_run(x, blocks, stride):
    return fused_stage(torch.from_numpy(x), blocks, stride).float().numpy()


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("against", ["interpret_k1", "interpret_k2",
                                     "reference"])
def test_port_matches_avtex(stride, against):
    x, blocks = _stage_case()
    jb, pb = _both(blocks)
    xj = jnp.asarray(x, jnp.bfloat16)
    if against == "reference":
        want = jax_stage.stage_reference(xj, jb, stride)
    else:
        want = jax_stage.fused_stage(xj, jb, stride, interpret=True,
                                     slices_per_step=int(against[-1]))
    got = _port_run(x, pb, stride)
    assert got.shape == (6, 16 // stride, 16 // stride, COUT)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("h,w,bt", [(15, 13, 3), (16, 16, 1)])
def test_port_matches_avtex_reference_odd_sizes(h, w, bt):
    """Odd spatial sizes at stride 1 and a single slice."""
    x, blocks = _stage_case(seed=4, bt=bt, h=h, w=w)
    jb, pb = _both(blocks)
    want = jax_stage.stage_reference(jnp.asarray(x, jnp.bfloat16), jb, 1)
    np.testing.assert_allclose(_port_run(x, pb, 1),
                               np.asarray(want, np.float32), **TOL)


def _flax_stage(stride):
    """avtex's 2-block slow stage (t_kernel 1, fp32, affine) with
    randomized parameters, as avtex's own test builds it."""
    import flax.linen as nn

    class Stage(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = JaxBottleneck(F, 1, stride, dtype=jnp.float32,
                              norm="affine", fuse=False,
                              name="SFBottleneck_0")(x)
            return JaxBottleneck(F, 1, 1, dtype=jnp.float32, norm="affine",
                                 fuse=False, name="SFBottleneck_2")(x)

    x5 = np.random.default_rng(1).random((2, 3, 16, 16, CIN)).astype(
        np.float32)
    m = Stage()
    params = m.init(jax.random.key(0), x5)
    g = np.random.default_rng(3)
    params = jax.tree.map(
        lambda a: g.standard_normal(a.shape).astype(np.float32) * 0.1
        + (1.0 if a.ndim == 1 else 0.0), params)
    return m, params, x5


def _port_stage_module(stride, tree):
    """A module with the port's SFBottleneck_0 / _2 children, loaded from
    avtex's tree through convert_params."""
    holder = torch.nn.Module()
    holder.add_module("SFBottleneck_0", SFBottleneck(
        CIN, F, 1, stride, norm="affine", fuse=False))
    holder.add_module("SFBottleneck_2", SFBottleneck(
        COUT, F, 1, 1, norm="affine", fuse=False))
    holder.load_state_dict(convert_params(tree, holder))
    return holder


@pytest.mark.parametrize("stride", [1, 2])
def test_stage_weights_match_avtex_bit_for_bit(stride):
    _, params, _ = _flax_stage(stride)
    holder = _port_stage_module(stride, params)
    got = stage_weights_from_params(holder.state_dict(), [0, 2])
    want = jax_stage.stage_weights_from_params(params, [0, 2])
    assert len(got) == len(want) == 2
    for gb, wb in zip(got, want):
        for name in BlockWeights._fields:
            a, b = getattr(gb, name), getattr(wb, name)
            if b is None:
                assert a is None, name
                continue
            assert tuple(a.shape) == tuple(b.shape), name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


@pytest.mark.parametrize("stride", [1, 2])
def test_port_matches_port_bottleneck_chain(stride):
    """fused_stage reproduces the port's SFBottleneck chain (fp32, affine,
    fuse=False). The chain adds the projection unrounded here; the model's
    bf16 blocks round it first, fused_stage never (the 2e-2 gate holds
    either way)."""
    m, params, x5 = _flax_stage(stride)
    holder = _port_stage_module(stride, params)
    xt = torch.from_numpy(x5).permute(0, 4, 1, 2, 3)   # NCDHW
    with torch.no_grad():
        want = holder.SFBottleneck_2(holder.SFBottleneck_0(xt))
    want = want.permute(0, 2, 3, 4, 1).reshape(6, 16 // stride,
                                               16 // stride, COUT)
    blocks = stage_weights_from_params(holder.state_dict(), [0, 2])
    got = fused_stage(torch.from_numpy(x5).reshape(6, 16, 16, CIN), blocks,
                      stride)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), **TOL)
    flax_out = np.asarray(m.apply(params, x5), np.float32)
    np.testing.assert_allclose(got.float().numpy(),
                               flax_out.reshape(want.shape), **TOL)


# ------------------------------------------------------------------ #
# the slice as a whole: a narrow SlowFastR50's slow res2 and res3
# ------------------------------------------------------------------ #

SMALL = dict(width=8, layers=(2, 2, 1, 1))
STAGES = {"res2": ([0, 2], 1), "res3": ([4, 6], 2)}


@pytest.fixture(scope="module")
def small_encoder_run():
    """avtex params (norm affine, perturbed), the port encoder carrying
    them, and the inputs/outputs of its slow res2 and res3 captured by
    hooks in one fp32 forward pass."""
    g = np.random.default_rng(0)
    slow = g.standard_normal((2, 8, 32, 32, 3)).astype(np.float32)
    fast = g.standard_normal((2, 32, 32, 32, 3)).astype(np.float32)
    m = JaxSF(**SMALL, dtype=jnp.float32, norm="affine", fuse=False)
    params = m.init(jax.random.key(0), slow, fast)
    g = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + (0.1 * g.standard_normal(a.shape).astype(
            np.float32) if np.ndim(a) == 1 else 0.0), params)
    enc = SlowFastR50(**SMALL, dtype=torch.float32, norm="affine",
                      fuse=False)
    enc.load_state_dict(convert_params(params, enc))
    seen = {}

    def grab(key):
        def hook(mod, args, out):
            seen[key] = (args[0].detach().clone(), out.detach().clone())
        return hook

    hooks = []
    for name, (idx, _) in STAGES.items():
        first = getattr(enc, f"SFBottleneck_{idx[0]}")
        last = getattr(enc, f"SFBottleneck_{idx[-1]}")
        hooks.append(first.register_forward_hook(grab(name + "_in")))
        hooks.append(last.register_forward_hook(grab(name + "_out")))
    with torch.no_grad():
        enc(torch.from_numpy(slow), torch.from_numpy(fast))
    for h in hooks:
        h.remove()

    def slices(t):  # NCDHW -> [B*T, H, W, C]
        return t.permute(0, 2, 3, 4, 1).reshape(
            -1, t.shape[3], t.shape[4], t.shape[1])

    caps = {name: (slices(seen[name + "_in"][0]),
                   slices(seen[name + "_out"][1])) for name in STAGES}
    return params, enc, caps


@pytest.mark.parametrize("stage", ["res2", "res3"])
def test_slice_stage_matches_avtex_and_the_model(small_encoder_run, stage):
    params, enc, caps = small_encoder_run
    idx, stride = STAGES[stage]
    x, model_out = caps[stage]
    got = fused_stage(x, stage_weights_from_params(enc.state_dict(), idx),
                      stride).float().numpy()
    want = jax_stage.fused_stage(
        jnp.asarray(x.numpy(), jnp.bfloat16),
        jax_stage.stage_weights_from_params(params, idx), stride,
        interpret=True)
    assert got.shape == tuple(model_out.shape)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **TOL)
    np.testing.assert_allclose(got, model_out.numpy(), **TOL)


def test_slice_rejects_stages_that_do_not_qualify(small_encoder_run):
    """Slow res4 (temporal conv1) and every fast block raise."""
    _, enc, _ = small_encoder_run
    sd = enc.state_dict()
    for idx in ([8], [1, 3], [5, 7]):
        with pytest.raises(ValueError):
            stage_weights_from_params(sd, idx)


# ------------------------------------------------------------------ #
# errors and dispatch
# ------------------------------------------------------------------ #

def _holder(*blocks):
    holder = torch.nn.Module()
    for idx, blk in blocks:
        holder.add_module(f"SFBottleneck_{idx}", blk)
    return holder


@pytest.mark.parametrize("case", ["temporal_conv1", "late_projection",
                                  "first_without_projection"])
def test_stage_weights_raise(case):
    aff = dict(norm="affine", fuse=False)
    if case == "temporal_conv1":
        sd, idx = _holder((0, SFBottleneck(8, 3, 3, 1, **aff))), [0]
    elif case == "late_projection":
        sd, idx = _holder((0, SFBottleneck(8, 4, 1, 1, **aff)),
                          (2, SFBottleneck(16, 8, 1, 2, **aff))), [0, 2]
    else:
        sd, idx = _holder((2, SFBottleneck(16, 4, 1, 1, **aff))), [2]
    with pytest.raises(ValueError):
        stage_weights_from_params(sd.state_dict(), idx)


def test_odd_size_at_stride_2_raises():
    x, blocks = _stage_case(bt=2, h=15, w=16)
    _, pb = _both(blocks)
    with pytest.raises(ValueError, match="even"):
        fused_stage(torch.from_numpy(x), pb, 2)
    with pytest.raises(ValueError, match="even"):
        stage_reference(torch.from_numpy(x), pb, 2)


def test_cpu_runs_plain_version_and_counts_no_launch():
    x, blocks = _stage_case(bt=2)
    _, pb = _both(blocks)
    before = port_stage.launches
    got = fused_stage(torch.from_numpy(x), pb, 2)
    assert port_stage.launches == before
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, stage_reference(torch.from_numpy(x), pb, 2))


@pytest.mark.parametrize("how", ["launch_cpu_tensor", "meta_device"])
def test_kernel_path_without_cuda_raises(how):
    x, blocks = _stage_case(bt=2)
    _, pb = _both(blocks)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    before = port_stage.launches
    with pytest.raises(ValueError):
        if how == "launch_cpu_tensor":
            port_stage.launch_block(xt, port_stage.pack_block(pb[0], "cpu"),
                                    1)
        else:
            fused_stage(xt.to("meta"), pb, 1)
    assert port_stage.launches == before


def test_wrong_chaining_raises():
    x, blocks = _stage_case(bt=2)
    _, pb = _both(blocks)
    with pytest.raises(ValueError):            # C_in mismatch
        fused_stage(torch.from_numpy(x[..., :16]), pb, 1)
    with pytest.raises(ValueError):            # projection on block 1
        fused_stage(torch.from_numpy(x), [pb[0], pb[0]._replace(
            w1=pb[1].w1)], 1)
    with pytest.raises(ValueError):            # stage without blocks
        fused_stage(torch.from_numpy(x), [], 1)

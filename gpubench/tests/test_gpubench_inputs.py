"""The seeded weights: the trainer's init for the training form, drawn
norm scales and shifts for a served model, the same for the same seed."""

import torch

from gpubench import inputs

SHAPES = [("q.Conv_0.weight", (8, 3, 3, 3, 3)), ("q.Affine_0.scale", (8,)),
          ("q.Affine_0.bias", (8,)), ("t.Conv_0.weight", (16, 8, 1, 1, 1)),
          ("t.GroupNorm_0.weight", (16,)), ("t.GroupNorm_0.bias", (16,))]


def test_training_form_has_the_trainers_init():
    w = inputs.seeded_weights(SHAPES, 7)
    assert [n for n, _ in SHAPES] == list(w)
    for name in ("q.Affine_0.scale", "t.GroupNorm_0.weight"):
        assert torch.equal(w[name], torch.ones_like(w[name]))
    for name in ("q.Affine_0.bias", "t.GroupNorm_0.bias"):
        assert torch.equal(w[name], torch.zeros_like(w[name]))


def test_served_form_draws_scales_and_shifts_from_the_seed():
    init = inputs.seeded_weights(SHAPES, 7)
    w = inputs.seeded_weights(SHAPES, 7, served=True)
    again = inputs.seeded_weights(SHAPES, 7, served=True)
    other = inputs.seeded_weights(SHAPES, 8, served=True)
    for name, _ in SHAPES:
        assert torch.equal(w[name], again[name])
        assert not torch.equal(w[name], other[name])
        if name.endswith("Conv_0.weight"):
            assert torch.equal(w[name], init[name])
    for name in ("q.Affine_0.scale", "t.GroupNorm_0.weight"):
        assert 0.5 <= float(w[name].min()) and float(w[name].max()) < 1.5
        assert float(w[name].std()) > 0.1
    for name in ("q.Affine_0.bias", "t.GroupNorm_0.bias"):
        assert 0.0 < float(w[name].abs().mean()) < 0.3

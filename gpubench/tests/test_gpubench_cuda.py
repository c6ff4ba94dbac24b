"""On the card only (marked ``cuda``; each test looks for a device and
skips without one): one short run of each embed cell at its full size,
and each cell's run with the fp8 control in the program's place, judged
by the cell's own limits, coming out not correct."""

import pytest
import torch

from gpubench import run

CELLS = ["embed.slowfast_r50.fresh", "embed.r3d18.fresh",
         "train.r3d18.default", "train.slowfast_r50.bs12"]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["embed.slowfast_r50.fresh",
                                      "embed.r3d18.fresh"])
def test_embed_cell_runs_correct_on_the_card(workload):
    _need_cuda()
    r = run.run_cell(workload, 2 ** 31 + 3, 2.0, False)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_fp8_control_fails_the_limit_on_the_card(workload):
    _need_cuda()
    r = run.run_cell(workload, 2 ** 31 + 5, 1.0, False, fault="control")
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())

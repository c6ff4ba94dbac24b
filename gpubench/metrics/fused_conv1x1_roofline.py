"""``fused_conv1x1``'s share of its roofline: for each launch in the
window the least time its bytes or its operations allow
(``flops.fused_bound_s``, from the shapes the harness recorded), summed,
over the kernel's device time. Silent when the launches recorded and the
kernels traced do not pair up."""

from gpubench import flops

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "embed_segments_per_s"
RECORD = ("avtex_torch.ops.fused_matmul", "fused_conv1x1")


def shape(x, weight, scale, bias, residual=None, relu=True):
    return (int(x.shape[0]), int(x.shape[1]), int(weight.shape[0]),
            residual is not None)


def read(ctx):
    calls = ctx.calls.get("fused_conv1x1_roofline")
    if ctx.trace is None or not calls:
        return None
    seconds, count = ctx.trace.device_s(lambda n: "fused_conv1x1" in n)
    if count != len(calls) or seconds <= 0:
        return None
    return 100.0 * flops.fused_bounds_total_s(calls) / seconds

"""A whole slow-pathway bottleneck stage (Hopper CUDA kernel, one per block).

``fused_stage(x, blocks, stride)`` runs N bottlenecks on channels-last
slices ``x [BT, H, W, C_in] -> [BT, H/s, W/s, C_out]``: each block is
conv1 1x1 -> affine -> ReLU -> conv2 3x3 (pad 1, ``stride`` on block 0) ->
affine -> ReLU -> conv3 1x1 -> affine -> + residual (block 0: the
projection ``affine(x[::s, ::s] @ wp)``, kept in fp32) -> ReLU. It is
``SFBottleneck`` with ``norm="affine"`` and ``t_kernel == 1``
(``avtex_torch/nn/slowfast.py``), except that the model rounds the
projection to bf16 before the residual add and this function does not,
as avtex's ``fused_stage`` does not.

Kernel: ``avtex_torch/csrc/fused_stage.cu``. It replaces the TPU kernel
``avtex/ops/stage_fused.py::fused_stage`` (``_stage_kernel`` /
``_block_body``, ``pallas_call`` at line 293). A stage is one launch per
bottleneck: conv1's and conv2's outputs stay in shared memory, each block's
bf16 output goes through device memory to the next (avtex rounds it to bf16
there too). avtex's ``interpret`` and ``slices_per_step`` are knobs of the
TPU's Pallas grid and have no counterpart here: ``plan`` (pure Python,
tested on the CPU) picks each block's output tile, consumer warpgroups and
weight-ring depth, and the launcher checks the plan it is given.

Dispatch: a CUDA tensor launches the kernel or raises (the kernel takes
C_in % 8 == 0, F % 16 == 0, F <= 128, C_out % 16 == 0); there is no
fallback. A CPU tensor runs ``stage_reference``, the plain version. Like
avtex, the wrapper casts x and the weight matrices to bf16 and the
scale/bias vectors to fp32. Odd H or W at stride 2 raise ``ValueError``
(avtex's decimating reshape fails there).

``launches`` counts the kernel launches made by this module (one per block).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build

launches = 0
_lib = None
BF16 = torch.bfloat16

# The kernel's shapes (avtex_torch/csrc/fused_stage.cu), which the plan
# counts shared memory and padded work in.
BM = 64             # rows of one consumer warpgroup's product
BK = 64             # k slab of every product
BN3 = 128           # column chunk of conv3 and the projection
A_STAGES = 4        # slots of the ring of gathered x rows (conv1, projection)
A_SLOT_BYTES = BM * BK * 2  # a consumer warpgroup's share of one slot
B_STAGE_BYTES = BN3 * BK * 2
MAX_SMEM = 232448   # dynamic shared memory one block may use (H100)
SM_SMEM = 233472    # an SM's shared memory; each block also takes
CTA_RESERVED = 1024  # this much of it
WARPGROUPS = (1, 2)  # consumer warpgroups a plan may pick
B_STAGES = tuple(range(2, 9))  # slots of the weight ring a plan may pick
# Assumed share of the tensor cores' rate that an SM holding one consumer
# warpgroup keeps against one holding two (nothing fills the gaps while a
# warpgroup waits on its loads or runs an epilogue); the plan weighs padded
# work by it. It decides res3's block 0 (two warpgroups); check it on the
# card with ``tools/stage_plan_ab.py default res3wg1``.
ONE_WG_RATE = 0.75


class BlockWeights(NamedTuple):
    """One bottleneck's folded weights, in avtex's layouts ([K, N])."""

    w1: torch.Tensor             # [C_in, F]
    s1: torch.Tensor             # [F] affine scale
    b1: torch.Tensor             # [F] affine bias
    w2: torch.Tensor             # [3, 3, F, F] spatial conv
    s2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor             # [F, C_out]
    s3: torch.Tensor
    b3: torch.Tensor
    wp: Optional[torch.Tensor]   # [C_in, C_out] projection (block 0) or None
    sp: Optional[torch.Tensor]
    bp: Optional[torch.Tensor]


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 product of the bf16-rounded operands (avtex's ``_mm``)."""
    return torch.matmul(a.to(BF16).float(), w.to(BF16).float())


def _block_reference(v: torch.Tensor, blk: BlockWeights,
                     stride: int) -> torch.Tensor:
    """One bottleneck on [K, H, W, C_in] -> [K, H/s, W/s, C_out] (avtex's
    ``_block_body``): nine tap products summed in fp32 for the 3x3 conv."""
    k, h, w, cin = v.shape
    f, cout = blk.w1.shape[1], blk.w3.shape[1]
    ho, wo = h // stride, w // stride
    y = torch.relu(_mm(v.reshape(-1, cin), blk.w1) * blk.s1.float()
                   + blk.b1.float())
    yp = F.pad(y.to(BF16).reshape(k, h, w, f), (0, 0, 1, 1, 1, 1))
    acc = None
    for dh in range(3):
        for dw in range(3):
            tap = yp[:, dh:dh + ho * stride:stride,
                     dw:dw + wo * stride:stride]
            part = _mm(tap.reshape(-1, f), blk.w2[dh, dw])
            acc = part if acc is None else acc + part
    y = torch.relu(acc * blk.s2.float() + blk.b2.float()).to(BF16)
    y = _mm(y, blk.w3) * blk.s3.float() + blk.b3.float()
    if blk.wp is not None:
        vs = v[:, ::stride, ::stride].reshape(-1, cin)
        r = _mm(vs, blk.wp) * blk.sp.float() + blk.bp.float()
    else:
        r = v.reshape(-1, cout).float()
    return torch.relu(y + r).to(BF16).reshape(k, ho, wo, cout)


def _check_stage(x: torch.Tensor, blocks: Sequence[BlockWeights],
                 stride: int) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be [BT, H, W, C_in]; got {tuple(x.shape)}")
    if not blocks:
        raise ValueError("a stage needs at least one block")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2; got {stride}")
    _, h, w, c = x.shape
    if stride == 2 and (h % 2 or w % 2):
        raise ValueError(f"stride 2 needs even H and W; got {h}x{w}")
    for i, blk in enumerate(blocks):
        if (i == 0) != (blk.wp is not None):
            raise ValueError(f"block {i}: the projection belongs on the "
                             f"stage's first block only")
        cin, f = blk.w1.shape
        cout = blk.w3.shape[1]
        if (cin != c or blk.w2.shape != (3, 3, f, f)
                or blk.w3.shape[0] != f
                or (blk.wp is not None and blk.wp.shape != (cin, cout))):
            raise ValueError(f"block {i}: weights do not chain from {c} "
                             f"input channels")
        if blk.wp is None and cin != cout:
            raise ValueError(f"block {i}: no projection needs C_in == C_out")
        c = cout


def stage_reference(x: torch.Tensor, blocks: Sequence[BlockWeights],
                    stride: int) -> torch.Tensor:
    """Plain torch version of ``fused_stage`` (bf16 in and out, fp32
    products). On a card, call it with TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``, the default)."""
    _check_stage(x, blocks, stride)
    x = x.to(BF16)
    for i, blk in enumerate(blocks):
        x = _block_reference(x, blk, stride if i == 0 else 1)
    return x


def stage_weights_from_params(state_dict: Mapping[str, torch.Tensor],
                              block_indices: Sequence[int]
                              ) -> List[BlockWeights]:
    """A slow-pathway stage's BlockWeights from a SlowFastR50 state_dict.

    ``state_dict`` has the port's ``SFBottleneck_{i}.Conv_k.weight``
    (OIDHW) and ``SFBottleneck_{i}.Affine_k.{scale,bias}`` keys, as
    ``SlowFastR50.state_dict()`` or ``avtex_torch.convert.convert_params``
    give them. ``block_indices`` lists the stage's blocks in order (slow
    blocks are even: res2 = [0, 2, 4], res3 = [6, 8, 10, 12]). Only
    ``t_kernel == 1`` blocks qualify, and only the first block may carry
    the projection; anything else raises ``ValueError``.
    """
    def mat(w):  # [out, in, 1, 1, 1] -> [in, out]
        return w[:, :, 0, 0, 0].t()

    blocks = []
    for j, idx in enumerate(block_indices):
        p = f"SFBottleneck_{idx}."
        w1 = state_dict[p + "Conv_0.weight"]
        if w1.shape[2] != 1:
            raise ValueError(
                f"SFBottleneck_{idx} has a temporal conv1 (kernel "
                f"{tuple(w1.shape)}); stage fusion needs t_kernel == 1")
        has_proj = p + "Conv_3.weight" in state_dict
        if (j == 0) != has_proj:
            raise ValueError(f"SFBottleneck_{idx}: projection expected only "
                             "on the stage's first block")

        def get(name, p=p):
            return state_dict[p + name]

        blocks.append(BlockWeights(
            w1=mat(w1), s1=get("Affine_0.scale"), b1=get("Affine_0.bias"),
            # [F, F, 1, 3, 3] -> [3, 3, F_in, F_out]
            w2=get("Conv_1.weight")[:, :, 0].permute(2, 3, 1, 0),
            s2=get("Affine_1.scale"), b2=get("Affine_1.bias"),
            w3=mat(get("Conv_2.weight")),
            s3=get("Affine_2.scale"), b3=get("Affine_2.bias"),
            wp=mat(get("Conv_3.weight")) if has_proj else None,
            sp=get("Affine_3.scale") if has_proj else None,
            bp=get("Affine_3.bias") if has_proj else None))
    return blocks


def smem_bytes(f: int, warpgroups: int, b_stages: int, halo_rows: int
               ) -> int:
    """Dynamic shared memory of one block (``fused_stage.cu::layout``): the
    weight ring, the ring of gathered x rows, y1 (y2 is written over it;
    at least 64 rows a warpgroup) in rows of F + 8, both rings' barriers
    and 1 KB to align the base."""
    rows = max(halo_rows, BM * warpgroups)
    return (b_stages * B_STAGE_BYTES + A_STAGES * warpgroups * A_SLOT_BYTES
            + -(-rows * (f + 8) * 2 // 16) * 16 + 16 * (b_stages + A_STAGES)
            + 1024)


@functools.lru_cache(maxsize=None)
def _plan(h: int, w: int, cin: int, f: int, cout: int, stride: int,
          proj: bool, tile, warpgroups, b_stages) -> tuple:
    ho, wo = h // stride, w // stride
    nf = 64 if f <= 64 else 128     # conv1's and conv2's product width
    nc = -(-cout // BN3) * BN3      # conv3's and the projection's
    needed = (h * w * cin * f + ho * wo * (9 * f * f + f * cout
                                           + (cin * cout if proj else 0)))
    best = None
    for nwg in (warpgroups,) if warpgroups else WARPGROUPS:
        m = BM * nwg
        if tile is not None:
            th, tw = tile
            if not (1 <= th <= ho and 1 <= tw <= wo and th * tw <= m):
                raise ValueError(f"tile {tile} does not fit {ho}x{wo} "
                                 f"outputs with {nwg} warpgroup(s)")
            tiles = [tile]
        else:
            tiles = [(th, min(wo, m // th)) for th in range(1, min(ho, m) + 1)]
        for th, tw in tiles:
            hh, hw = (th - 1) * stride + 3, (tw - 1) * stride + 3
            n_tiles = -(-ho // th) * -(-wo // tw)
            work = n_tiles * (-(-hh * hw // m) * m * cin * nf + m * (
                9 * f * nf + nc * (f + (cin if proj else 0))))
            for st in (b_stages,) if b_stages else B_STAGES:
                smem = smem_bytes(f, nwg, st, hh * hw)
                if smem > MAX_SMEM:
                    continue
                per_sm = min(2 if nwg == 1 else 1,
                             SM_SMEM // (smem + CTA_RESERVED))
                rate = 1.0 if nwg * per_sm >= 2 else ONE_WG_RATE
                key = (work / rate, -st, th)
                if best is None or key < best[0]:
                    best = (key, (("tile", (th, tw)), ("warpgroups", nwg),
                                  ("b_stages", st), ("halo", (hh, hw)),
                                  ("halo_rows", hh * hw),
                                  ("smem_bytes", smem), ("tiles", n_tiles),
                                  ("ctas_per_sm", per_sm),
                                  ("padded_share", 1 - needed / work),
                                  ("product_widths", (nf, nc))))
    if best is None:
        raise ValueError(f"no plan fits {MAX_SMEM} bytes of shared memory "
                         f"for {h}x{w}, F={f}, stride {stride}")
    return best[1]


def plan(h: int, w: int, cin: int, f: int, cout: int, stride: int,
         proj: Optional[bool] = None, bt: int = 1, tile=None,
         warpgroups: Optional[int] = None,
         b_stages: Optional[int] = None) -> Dict:
    """The launch plan of one block on ``[bt, h, w, cin]`` slices.

    Keys: ``tile`` (TH, TW) output pixels a CUDA block owns, ``warpgroups``
    (consumer warpgroups of 64 rows each), ``b_stages`` (slots of the
    weight ring), ``halo`` (its conv1 input pixels, ``(TH-1)s+3`` x
    ``(TW-1)s+3``) and ``halo_rows``, ``smem_bytes``, ``tiles`` per slice,
    ``ctas`` (the grid: one block per tile of the ``bt`` slices),
    ``ctas_per_sm`` (by shared memory and the kernel's launch bounds),
    ``padded_share`` (the share of the
    tensor-core work that is padding: halo recompute, 64-row and 64/128
    column rounding, ragged tiles) and ``product_widths`` (conv1/conv2 and
    conv3/projection columns as multiplied).

    Picks the least padded work, weighted by ``ONE_WG_RATE`` where an SM
    would hold one consumer warpgroup only; then more weight slots. ``tile``,
    ``warpgroups`` and ``b_stages`` pin a choice; ``proj`` defaults to block
    0's (a stride or a change of width)."""
    if proj is None:
        proj = stride != 1 or cin != cout
    p = dict(_plan(h, w, cin, f, cout, stride, bool(proj),
                   None if tile is None else tuple(tile), warpgroups,
                   b_stages))
    p["ctas"] = bt * p["tiles"]
    return p


def kernel_plan_check(p: Dict, f: int, device) -> Dict[str, int]:
    """The kernel's own view of plan ``p`` on a CUDA ``device``: its shared
    memory (``smem_bytes``, to match the plan's) and the blocks an SM holds
    by the occupancy query (``ctas_per_sm``)."""
    lib = _kernel_lib()
    smem = lib.avtex_fused_block_smem(f, p["warpgroups"], p["b_stages"],
                                      p["halo_rows"])
    with torch.cuda.device(device):
        per_sm = lib.avtex_fused_block_ctas_per_sm(f, p["warpgroups"], smem)
    if per_sm < 0:
        raise RuntimeError(f"fused_stage occupancy query failed: CUDA error "
                           f"{-per_sm}")
    return {"smem_bytes": smem, "ctas_per_sm": per_sm}


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("fused_stage")
        fn = lib.avtex_fused_block
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 11 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.avtex_fused_block_smem.argtypes = [ctypes.c_int] * 4
        lib.avtex_fused_block_smem.restype = ctypes.c_int
        lib.avtex_fused_block_ctas_per_sm.argtypes = [ctypes.c_int] * 3
        lib.avtex_fused_block_ctas_per_sm.restype = ctypes.c_int
        _lib = lib
    return _lib


def pack_block(blk: BlockWeights, device) -> tuple:
    """The kernel's operands for one block on ``device``: bf16 matrices in
    ``[N, K]`` (K-contiguous) layout, w2 as ``[F, 9F]`` with k = tap * F +
    c, fp32 contiguous vectors; None for a missing projection."""
    def m(w):  # [K, N] -> [N, K]
        return w.t().to(device, BF16).contiguous()

    def v(a):
        return None if a is None else a.to(device, torch.float32).contiguous()

    f = blk.w2.shape[-1]
    w2 = blk.w2.permute(3, 0, 1, 2).reshape(f, 9 * f)
    return (m(blk.w1), v(blk.s1), v(blk.b1),
            w2.to(device, BF16).contiguous(), v(blk.s2), v(blk.b2),
            m(blk.w3), v(blk.s3), v(blk.b3),
            None if blk.wp is None else m(blk.wp), v(blk.sp), v(blk.bp))


def launch_block(x: torch.Tensor, packed: tuple, stride: int,
                 block_plan: Optional[Dict] = None) -> torch.Tensor:
    """The kernel launch: one bottleneck on CUDA bf16 ``x [BT, H, W, C_in]``
    (contiguous) with ``pack_block``'s operands, under ``block_plan``
    (default: ``plan`` of the shape). The launcher refuses a plan it
    cannot run (``RuntimeError``); nothing falls back."""
    if x.device.type != "cuda":
        raise ValueError(f"the fused_stage kernel needs a CUDA tensor; got "
                         f"{x.device}")
    if x.dtype != BF16:
        raise TypeError(f"the CUDA kernel takes bfloat16 x, got {x.dtype}")
    ops = [t for t in packed if t is not None]
    if any(t.device != x.device for t in ops):
        raise ValueError("all operands must be on one device")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes contiguous, 16-byte aligned x")
    bt, h, w, cin = x.shape
    f = packed[0].shape[0]
    cout = packed[6].shape[0]
    if packed[0].shape[1] != cin or (packed[9] is None and
                                     (stride != 1 or cin != cout)):
        raise ValueError(f"block weights do not fit x {tuple(x.shape)} at "
                         f"stride {stride}")
    if stride not in (1, 2) or (stride == 2 and (h % 2 or w % 2)):
        raise ValueError(f"stride {stride} on {h}x{w}: the kernel takes "
                         f"stride 1, or stride 2 on even H and W")
    if cin % 8 or f % 16 or f > 128 or cout % 16:
        raise ValueError(f"the CUDA kernel takes C_in % 8 == 0, F % 16 == 0, "
                         f"F <= 128 and C_out % 16 == 0; got C_in={cin}, "
                         f"F={f}, C_out={cout}")
    if block_plan is None:
        block_plan = plan(h, w, cin, f, cout, stride,
                          proj=packed[9] is not None)
    th, tw = block_plan["tile"]
    out = torch.empty((bt, h // stride, w // stride, cout), dtype=BF16,
                      device=x.device)
    ptrs = [None if t is None else t.data_ptr() for t in packed]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _kernel_lib().avtex_fused_block(
            x.data_ptr(), *ptrs, out.data_ptr(), bt, h, w, cin, f, cout,
            stride, th, tw, block_plan["warpgroups"], block_plan["b_stages"],
            stream)
    if rc != 0:
        raise RuntimeError(f"fused_stage kernel launch failed: CUDA error "
                           f"{rc} (x {tuple(x.shape)}, F={f}, C_out={cout}, "
                           f"stride {stride}, tile {th}x{tw}, "
                           f"{block_plan['warpgroups']} warpgroup(s), "
                           f"{block_plan['b_stages']} weight slots)")
    global launches
    launches += 1
    return out


def fused_stage(x: torch.Tensor, blocks: Sequence[BlockWeights],
                stride: int = 1) -> torch.Tensor:
    """Run a whole bottleneck stage on [BT, H, W, C_in] -> [BT, Ho, Wo, C_out].

    CUDA: one kernel launch per block on the current stream, without
    synchronising. CPU: the plain version.
    """
    if x.device.type == "cpu":
        return stage_reference(x, blocks, stride)
    _check_stage(x, blocks, stride)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.to(BF16).contiguous()
    for i, blk in enumerate(blocks):
        x = launch_block(x, pack_block(blk, x.device),
                         stride if i == 0 else 1)
    return x

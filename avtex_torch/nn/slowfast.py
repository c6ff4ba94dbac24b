"""SlowFast-R50 two-pathway video encoder (the port of avtex/nn/slowfast.py).

Same network as ``avtex``: SlowFast-8x8 geometry (alpha=4, fast width =
slow/8), lateral fast->slow fusions after the stem and res2/res3/res4 as
time-strided (7,1,1) convs + norm + ReLU, R50 bottlenecks [3,4,6,3] with
slow temporal kernels 1,1,3,3, and a head that concatenates the global
means of both pathways (2048 + 256 = 2304 features, fp32). Padding is
torch-explicit ``k//2`` on every conv.

Layout: ``forward(slow, fast)`` takes avtex's channels-last
``[B, T, H, W, C]`` clips. Inside, activations are NCDHW tensors in
``torch.channels_last_3d`` memory, so cuDNN's 3D convs run in their
channels-last path and the ``[M, K]`` operand of the 1x1 kernel is a free
``permute`` + ``view``.

Module and parameter names follow the flax tree (``Conv_k``, ``Affine_k``
/ ``GroupNorm_k``, ``fast_stem_kernel``, ``SFBottleneck_{2i}`` slow /
``SFBottleneck_{2i+1}`` fast) so ``avtex_torch.convert`` is a renaming.

Stems: with ``s2d_stem`` (avtex's field) and H, W multiples of 4, the
stems run through the space-to-depth form of the same arithmetic
(avtex_torch/ops/s2d_stem.py): in affine mode both whole stems (conv,
affine, ReLU, pool) in s2d space, in group mode the fast stem's conv only.
Otherwise both are one plain ``conv3d``. The parameters are the same
either way, so the flag can flip on any checkpoint.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avtex_torch.ops.fused_matmul import fused_conv1x1
from avtex_torch.ops.s2d_stem import fast_stem_s2d, fast_stem_s2d_pooled

from .resnet3d import make_norm, norm_prefix, run_block

ALPHA = 4          # fast/slow frame-rate ratio
BETA_INV = 8       # slow/fast channel ratio
FUSION_KERNEL = 7  # temporal kernel of the lateral fast->slow convs
FAST_FRAMES = 32
SLOW_FRAMES = FAST_FRAMES // ALPHA

# The shape rule for the 1x1 kernel, kept in this one place: a 1x1 conv
# goes to fused_conv1x1 when both its input and output channel counts are
# at least this many and both are multiples of 8 (the kernel's TMA rows of
# K and N are whole 16-byte units); other convs stay on cuDNN. avtex's
# TPU rule is 128 (it avoided lane padding); on an H100 the kernel beats
# the cuDNN conv + Affine + residual + ReLU chain at every 64-channel 1x1
# conv of SlowFast-R50 and the warm embed is faster with 64 (PERF.md,
# chip_smoke.py phases 3 and 5). The fast pathway's 32-channel 1x1 convs
# below that are not measured.
KERNEL_MIN_CHANNELS = 64

CL3D = torch.channels_last_3d
STEMS_RANGE = "slowfast_stems"


def _conv(cin: int, cout: int, kernel: Tuple[int, int, int],
          stride: Tuple[int, int, int] = (1, 1, 1)) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, kernel, stride,
                     padding=tuple(k // 2 for k in kernel), bias=False)


class SFBottleneck(nn.Module):
    """Bottleneck with the temporal kernel on the first 1x1 conv.

    ``fuse`` keeps avtex's semantics (``norm="affine"`` only): ``"all"``
    (or True) fuses conv1 (when its temporal kernel is 1), the projection
    shortcut and conv3 with their affine, residual and ReLU; ``"conv3"``
    fuses only conv3's epilogue; False runs every conv on cuDNN followed
    by separate elementwise ops. A fused conv goes to the CUDA kernel when
    it passes the shape rule (``kernel_eligible``), else it runs the same
    arithmetic as a cuDNN conv + elementwise epilogue.
    """

    expansion = 4

    def __init__(self, in_ch: int, features: int, t_kernel: int = 1,
                 spatial_stride: int = 1, norm: str = "group",
                 fuse: Union[bool, str] = "all"):
        super().__init__()
        self.in_ch, self.features = in_ch, features
        self.out_ch = features * self.expansion
        self.t_kernel, self.stride, self.norm = t_kernel, spatial_stride, norm
        self.fuse = bool(fuse) and norm == "affine"
        self.fuse_all = self.fuse and fuse in (True, "all")
        s = (1, spatial_stride, spatial_stride)
        self.need_proj = in_ch != self.out_ch or spatial_stride != 1
        p = norm_prefix(norm)
        self.Conv_0 = _conv(in_ch, features, (t_kernel, 1, 1))
        self.add_module(f"{p}_0", make_norm(norm, features))
        self.Conv_1 = _conv(features, features, (1, 3, 3), s)
        self.add_module(f"{p}_1", make_norm(norm, features))
        self.Conv_2 = _conv(features, self.out_ch, (1, 1, 1))
        self.add_module(f"{p}_2", make_norm(norm, self.out_ch))
        if self.need_proj:
            self.Conv_3 = _conv(in_ch, self.out_ch, (1, 1, 1), s)
            self.add_module(f"{p}_3", make_norm(norm, self.out_ch))

    def _norm(self, idx: int) -> nn.Module:
        return getattr(self, f"{norm_prefix(self.norm)}_{idx}")

    def _conv_norm(self, idx: int, z: torch.Tensor) -> torch.Tensor:
        return self._norm(idx)(getattr(self, f"Conv_{idx}")(z))

    def kernel_eligible(self, idx: int) -> bool:
        """Whether 1x1 conv ``idx`` passes the kernel's shape rule."""
        conv = getattr(self, f"Conv_{idx}")
        k, n = conv.in_channels, conv.out_channels
        return (min(k, n) >= KERNEL_MIN_CHANNELS and k % 8 == 0
                and n % 8 == 0)

    def _fused(self, idx: int, z: torch.Tensor, residual=None,
               relu: bool = True) -> torch.Tensor:
        """1x1 conv ``idx`` + affine (+ residual) (+ ReLU) on NCDHW ``z``."""
        conv, aff = getattr(self, f"Conv_{idx}"), self._norm(idx)
        if not self.kernel_eligible(idx):
            y = aff(conv(z))
            if residual is not None:
                y = y + residual
            return torch.relu(y) if relu else y
        _, sh, sw = conv.stride
        if sh != 1 or sw != 1:
            # The strided shortcut z[:, :, :, ::s, ::s] is not one [M, K]
            # row stride; the contiguous() below copies it once.
            z = z[:, :, :, ::sh, ::sw]
        b, c, t, h, w = z.shape
        # channels_last_3d NCDHW == contiguous [B, T, H, W, C] == [M, K]
        rows = z.contiguous(memory_format=CL3D).permute(0, 2, 3, 4, 1)
        res = None
        if residual is not None:
            res = residual.contiguous(memory_format=CL3D).permute(
                0, 2, 3, 4, 1).reshape(-1, residual.shape[1])
        out = fused_conv1x1(rows.reshape(-1, c),
                            conv.weight.view(conv.out_channels, c),
                            aff.scale, aff.bias, residual=res, relu=relu)
        return out.view(b, t, h, w, -1).permute(0, 4, 1, 2, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fuse_all and self.t_kernel == 1:
            y = self._fused(0, x)
        else:
            y = torch.relu(self._conv_norm(0, x))
        y = torch.relu(self._conv_norm(1, y))
        if self.fuse:
            r = x
            if self.need_proj:
                if self.fuse_all:
                    r = self._fused(3, x, relu=False)
                else:
                    r = self._conv_norm(3, x)
            return self._fused(2, y, residual=r)
        y = self._conv_norm(2, y)
        r = self._conv_norm(3, x) if self.need_proj else x
        return torch.relu(y + r)


class SlowFastR50(nn.Module):
    """Two-pathway encoder; ``forward(slow, fast) -> [B, 2304]`` fp32.

    ``dtype`` is the activation and conv-weight dtype; norm parameters
    stay fp32 as in avtex. ``fuse`` defaults to ``"all"`` for
    ``norm="affine"``, so the inference path launches the 1x1 kernel.
    ``s2d_stem`` runs the stems in space-to-depth form (module docstring).
    ``remat`` checkpoints each bottleneck (training memory; the stems and
    laterals are not checkpointed, as in avtex).
    """

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "group",
                 fuse: Union[bool, str] = "all", s2d_stem: bool = True,
                 remat: bool = False):
        super().__init__()
        self.layers, self.width, self.dtype, self.norm = (
            tuple(layers), width, dtype, norm)
        self.s2d_stem, self.remat = s2d_stem, remat
        w, wf = width, width // BETA_INV
        p = norm_prefix(norm)

        self.Conv_0 = nn.Conv3d(3, w, (1, 7, 7), (1, 2, 2),
                                padding=(0, 3, 3), bias=False)
        self.add_module(f"{p}_0", make_norm(norm, w))
        self.fast_stem_kernel = nn.Parameter(
            torch.empty(wf, 3, 5, 7, 7))
        # the init nn.Conv3d gives its weight, not uninitialised memory
        nn.init.kaiming_uniform_(self.fast_stem_kernel, a=5 ** 0.5)
        self.add_module(f"{p}_1", make_norm(norm, wf))
        self._add_lateral(wf, 2 * wf, 2)

        slow_ch, fast_ch = w + 2 * wf, wf
        block_idx = 0
        for i, n_blocks in enumerate(self.layers):
            feats = w * (2 ** i)
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"SFBottleneck_{block_idx}", SFBottleneck(
                    slow_ch, feats, (1, 1, 3, 3)[i], stride, norm, fuse))
                self.add_module(f"SFBottleneck_{block_idx + 1}", SFBottleneck(
                    fast_ch, feats // BETA_INV, 3, stride, norm, fuse))
                slow_ch = feats * SFBottleneck.expansion
                fast_ch = feats // BETA_INV * SFBottleneck.expansion
                block_idx += 2
            if i != len(self.layers) - 1:
                self._add_lateral(fast_ch, 2 * fast_ch, 3 + i)
                slow_ch += 2 * fast_ch
        self.feat_dim = slow_ch + fast_ch

        # Conv weights in the compute dtype; norm parameters stay fp32.
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                m.weight.data = m.weight.data.to(dtype)
        self.fast_stem_kernel.data = self.fast_stem_kernel.data.to(dtype)

    def _add_lateral(self, cin: int, cout: int, norm_idx: int) -> None:
        self.add_module(f"Conv_{norm_idx - 1}", _conv(
            cin, cout, (FUSION_KERNEL, 1, 1), (ALPHA, 1, 1)))
        self.add_module(f"{norm_prefix(self.norm)}_{norm_idx}",
                        make_norm(self.norm, cout))

    def _named_norm(self, idx: int) -> nn.Module:
        return getattr(self, f"{norm_prefix(self.norm)}_{idx}")

    def _lateral(self, fast: torch.Tensor, norm_idx: int) -> torch.Tensor:
        y = getattr(self, f"Conv_{norm_idx - 1}")(fast)
        return torch.relu(self._named_norm(norm_idx)(y))

    def _stems(self, slow: torch.Tensor, fast: torch.Tensor):
        """Both stems on channels-last clips -> pooled NCDHW activations
        in channels_last_3d memory."""
        slow, fast = slow.to(self.dtype), fast.to(self.dtype)
        h, w = fast.shape[2:4]
        use_s2d = self.s2d_stem and h % 4 == 0 and w % 4 == 0
        if use_s2d and self.norm == "affine":
            a0, a1 = self._named_norm(0), self._named_norm(1)
            slow = fast_stem_s2d_pooled(slow, self.Conv_0.weight, a0.scale,
                                        a0.bias)
            fast = fast_stem_s2d_pooled(fast, self.fast_stem_kernel,
                                        a1.scale, a1.bias)
            return slow.permute(0, 4, 1, 2, 3), fast.permute(0, 4, 1, 2, 3)
        # [B, T, H, W, C] -> NCDHW views in channels_last_3d memory
        slow = slow.permute(0, 4, 1, 2, 3).contiguous(memory_format=CL3D)
        slow = torch.relu(self._named_norm(0)(self.Conv_0(slow)))
        if use_s2d:
            fast = fast_stem_s2d(fast, self.fast_stem_kernel).permute(
                0, 4, 1, 2, 3)
        else:
            fast = fast.permute(0, 4, 1, 2, 3).contiguous(memory_format=CL3D)
            fast = F.conv3d(fast, self.fast_stem_kernel, stride=(1, 2, 2),
                            padding=(2, 3, 3))
        fast = torch.relu(self._named_norm(1)(fast))
        slow = F.max_pool3d(slow, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        fast = F.max_pool3d(fast, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        return slow, fast

    def forward(self, slow: torch.Tensor, fast: torch.Tensor) -> torch.Tensor:
        # a named range, so a profile can attribute the stems' device time
        with torch.profiler.record_function(STEMS_RANGE):
            slow, fast = self._stems(slow, fast)
        slow = torch.cat([slow, self._lateral(fast, 2)], dim=1)

        block_idx = 0
        for i, n_blocks in enumerate(self.layers):
            for _ in range(n_blocks):
                slow = run_block(getattr(self, f"SFBottleneck_{block_idx}"),
                                 slow, self.remat)
                fast = run_block(
                    getattr(self, f"SFBottleneck_{block_idx + 1}"), fast,
                    self.remat)
                block_idx += 2
            if i != len(self.layers) - 1:
                slow = torch.cat([slow, self._lateral(fast, 3 + i)], dim=1)

        return torch.cat([slow.float().mean(dim=(2, 3, 4)),
                          fast.float().mean(dim=(2, 3, 4))], dim=-1)


def slowfast_pathways(frames: torch.Tensor, fast_frames: int = FAST_FRAMES,
                      alpha: int = ALPHA
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniformly sample a window [.., T, H, W, C] into (slow, fast) clips:
    ``fast_frames`` evenly spaced frames, and every ``alpha``-th of those
    (starting at alpha//2) for the slow pathway."""
    t_axis = frames.ndim - 4
    t = frames.shape[t_axis]
    idx = np.linspace(0, t - 1, fast_frames).round().astype(np.int64)
    fast = frames.index_select(t_axis, torch.from_numpy(idx).to(frames.device))
    slow = fast.index_select(t_axis, torch.arange(
        alpha // 2, fast_frames, alpha, device=frames.device))
    return slow, fast

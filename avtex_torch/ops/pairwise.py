"""All-pairs L2 distance between frames (Hopper CUDA kernel).

``pairwise_l2(feats, normalize=False)`` returns the ``[N, N]`` fp32 matrix
``D[i, j] = sqrt(max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0))`` over the rows of
``feats`` reshaped to ``[N, F]``, with exact zeros on the diagonal. With
``normalize`` each row is first divided by ``|x| + 1e-12``. This is the
classic baseline's D1 (``avtex/classic/d1.py::pairwise_l2``).

Kernel: ``avtex_torch/csrc/pairwise_l2.cu``. It replaces the TPU kernel
``avtex/ops/pairwise.py::pairwise_l2_pallas`` (``pallas_call`` at line 74).
The wrapper does what avtex does outside its ``pallas_call``: the reshape,
the optional normalize and ``sq = |x|^2``, in plain torch (on the card one
``vector_norm`` read of the rows; the plain version sums ``x * x``); the
kernels do the Gram product in fp32 FMA, split along F into ``S`` ranges
whose partial tiles go to a workspace (``torch.empty``, ``S x tiles`` fp32
128x128 tiles), then sum the partials in split order with the clamp, the
diagonal and the sqrt fused in. ``_split_plan`` picks ``S`` so that the
grid fills whole waves of the card. It is bound by operations (N(N+1) F).

Dispatch, one path per device: a CUDA tensor launches the kernel at every
size or raises (not float32, not contiguous, not 4-byte aligned, operands
on two devices, a launch error); there is no fallback. A CPU tensor runs
``pairwise_l2_reference``, the same Gram form in plain torch.

``launches`` counts the calls that launched the kernels (one launch pair
each).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build

BK = 512  # feature block of the plain version's fp32 accumulation
TILE = 128  # the kernel's output tile (rows and columns)
SLAB = 16  # the kernel's k slab; splits hold whole slabs
MIN_SPLIT_SLABS = 32  # a split's work must outweigh its 64 KB partial
FULL_WAVES = 4  # with this many waves of tiles alone, no split
WORKSPACE_CAP = 256 << 20  # bytes of partial tiles a split plan may add
launches = 0
_lib = None
_blocks_per_sm = None


def _rows(feats: torch.Tensor, normalize: bool) -> torch.Tensor:
    x = feats.reshape(feats.shape[0], -1)
    if normalize:
        x = x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-12)
    return x


def _sq(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(dim=1)


def pairwise_l2_reference(feats: torch.Tensor,
                          normalize: bool = False) -> torch.Tensor:
    """Plain torch version: fp32 Gram form, clamp, zero diagonal, sqrt.

    The Gram product accumulates over ``BK``-wide feature blocks in fp32,
    as avtex's Pallas kernel does (its BK = 512): one fp32 cuBLAS product
    over F = 150528 RGB features drifts by ~1e-4 (|x_i|^2 + |x_j|^2) on
    an H100 (chip_smoke.py phase 6), more than the distance between two
    similar frames; 512-wide blocks keep it near 2e-6 there. On a card,
    call it with TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``, the default).
    """
    x = _rows(feats, normalize).float()
    n, f = x.shape
    gram = torch.zeros((n, n), dtype=torch.float32, device=x.device)
    for k in range(0, f, BK):
        xk = x[:, k:k + BK]
        gram.addmm_(xk, xk.t())
    sq = _sq(x)
    d2 = sq[:, None] + sq[None, :] - 2.0 * gram
    d2 = d2.clamp_min(0.0)
    d2.fill_diagonal_(0.0)  # exact zeros (Gram form leaves residue there)
    return d2.sqrt()


def _split_plan(n: int, f: int, sms: int, blocks_per_sm: int) -> int:
    """``S``, the number of feature splits for ``n`` rows of ``f`` features
    on a card of ``sms`` SMs holding ``blocks_per_sm`` blocks each. The
    kernel gives split ``s`` the 16-wide slabs ``[s*slabs//S,
    (s+1)*slabs//S)`` of the ``ceil(f / 16)``.

    The grid is ``tiles * S`` blocks. No split when the tiles alone fill
    ``FULL_WAVES`` waves (which also bounds the workspace at large N);
    otherwise the ``S`` up to ``MIN_SPLIT_SLABS``-slab splits and the
    ``WORKSPACE_CAP`` whose last wave is fullest, the smallest on a tie,
    so a whole number of waves where one exists.
    """
    t = -(-n // TILE)
    tiles = t * (t + 1) // 2
    wave = sms * blocks_per_sm
    if tiles >= FULL_WAVES * wave:
        return 1
    slabs = -(-f // SLAB)
    s_max = max(1, min(slabs // MIN_SPLIT_SLABS,
                       WORKSPACE_CAP // (tiles * TILE * TILE * 4)))

    def fill(s):
        blocks = tiles * s
        return blocks / (-(-blocks // wave) * wave)
    return max(range(1, s_max + 1), key=lambda s: (fill(s), -s))


def plan(n: int, f: int, device) -> Dict[str, int]:
    """The launch plan of one call on a CUDA ``device``: ``splits``,
    ``tiles``, ``blocks`` (Gram kernel grid), ``sms``, ``blocks_per_sm``
    and ``workspace_bytes``."""
    global _blocks_per_sm
    if _blocks_per_sm is None:
        with torch.cuda.device(device):
            got = _kernel_lib().avtex_pairwise_l2_blocks_per_sm()
        if got < 1:
            raise RuntimeError(f"pairwise_l2 occupancy query failed: "
                               f"CUDA error {-got}")
        _blocks_per_sm = got
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = _split_plan(n, f, sms, _blocks_per_sm)
    t = -(-n // TILE)
    tiles = t * (t + 1) // 2
    return {"splits": splits, "tiles": tiles, "blocks": tiles * splits,
            "sms": sms, "blocks_per_sm": _blocks_per_sm,
            "workspace_bytes": splits * tiles * TILE * TILE * 4}


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("pairwise_l2")
        fn = lib.avtex_pairwise_l2
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                               ctypes.c_longlong,
                                               ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.avtex_pairwise_l2_blocks_per_sm.argtypes = []
        lib.avtex_pairwise_l2_blocks_per_sm.restype = ctypes.c_int
        _lib = lib
    return _lib


def pairwise_l2(feats: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """[N, N] pairwise L2 distances between the rows of ``feats`` [N, ...].

    CUDA: float32 rows, launched on the current stream without
    synchronising. CPU: the plain version.
    """
    if feats.ndim < 1 or feats.shape[0] == 0:
        raise ValueError(f"need at least one row; got {tuple(feats.shape)}")
    if feats.device.type == "cpu":
        return pairwise_l2_reference(feats, normalize)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if feats.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 rows, got "
                        f"{feats.dtype}")
    if not feats.is_contiguous():
        raise ValueError("the CUDA kernel takes contiguous rows")
    x = _rows(feats, normalize)
    # |x|^2 in one read of x: (x * x).sum(1) would write and re-read an
    # [N, F] temporary (~1 ms at the classic path's 1.08 GB of rows)
    return pairwise_l2_gram(x, torch.linalg.vector_norm(x, dim=1).square())


def pairwise_l2_gram(x: torch.Tensor, sq: torch.Tensor) -> torch.Tensor:
    """The kernel launch: D from CUDA rows ``x`` [N, F] and their squared
    norms ``sq`` [N], both float32 and contiguous, on one device."""
    if x.ndim != 2 or x.shape[0] == 0 or sq.shape != (x.shape[0],):
        raise ValueError(f"x must be [N >= 1, F] and sq [N]; got "
                         f"{tuple(x.shape)} and {tuple(sq.shape)}")
    if x.device.type != "cuda" or sq.device != x.device:
        raise ValueError(f"x and sq must lie on one CUDA device; got "
                         f"{x.device} and {sq.device}")
    if x.dtype != torch.float32 or sq.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 x and sq; got "
                        f"{x.dtype} and {sq.dtype}")
    if not (x.is_contiguous() and sq.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous x and sq")
    if x.data_ptr() % 4 or sq.data_ptr() % 4:
        raise ValueError("the CUDA kernel takes 4-byte aligned x and sq")
    n, f = x.shape
    p = plan(n, f, x.device)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    ws = torch.empty((p["splits"], p["tiles"], TILE, TILE),
                     dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _kernel_lib().avtex_pairwise_l2(
            x.data_ptr(), sq.data_ptr(), out.data_ptr(), ws.data_ptr(), n, f,
            p["splits"], stream)
    if rc != 0:
        raise RuntimeError(f"pairwise_l2 kernel launch failed: CUDA error "
                           f"{rc} (N={n}, F={f}, S={p['splits']})")
    global launches
    launches += 1
    return out

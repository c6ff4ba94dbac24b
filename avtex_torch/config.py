"""Dataclass configs (the port's own copy of ``avtex/config.py``):
``Config`` for contrastive synthesis, ``ClassicConfig`` for the classic
baseline.

Mirrors the reference's argparse surface so every flag (-m, -w, -stride,
-temp, -th, -alpha, -e, ...) has a field with the same default. The
derived-geometry rule is preserved: ``window = ceil(fps/2)`` and
``stride = ceil(fps/5)`` silently override -w/-stride.

``compute_dtype`` selects the encoder's activation dtype in the port
("bfloat16" on the GPU, "float32" for CPU parity runs).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Sequence


@dataclasses.dataclass
class Config:
    """Experiment configuration. Field names follow the reference flags."""

    # --- model / encoder ------------------------------------------------- #
    enc_arch: str = "resnet18"          # -ea
    model_type: int = 1                 # -m: (1) video (2) audio+video
    emb_dim: int = 128
    temp: float = 0.1                   # -temp: softmax temperature
    threshold: float = 0.0              # -th: survivor threshold
    l2: bool = True                     # -l2
    img_size: int = 224                 # -size
    dropout: float = 0.5

    # --- data ------------------------------------------------------------ #
    vdata: Optional[str] = None         # -vdata
    adata: Optional[str] = None         # -adata
    dadata: str = "audio/target"        # -dadata
    video_list: Optional[List[str]] = None  # -vl
    fps: float = 30.0
    fps_override: Optional[float] = None  # -fps
    subsample_rate: int = 1             # -subsample
    window: int = 20                    # -w  (derived: ceil(fps/2))
    stride: int = 4                     # -stride (derived: ceil(fps/5))
    train_stride: Optional[int] = None  # -train_stride
    n_negs: int = 20                    # -negs

    # --- synthesis ------------------------------------------------------- #
    new_video_length: int = 30          # -nvl: seconds
    alpha: float = 0.5                  # -alpha
    interpolation: bool = True          # -nintp stores False
    augment: bool = True                # -noaug stores False
    SF: int = 5                         # -SF: interpolation factor at jumps
    frames_bar: bool = False            # -fb
    norm: str = "group"                 # -norm: "group" | "affine"
    vcam: bool = False                  # -vcam
    driving_audio: Optional[List[str]] = None  # -da
    da_feats: str = "VGG"               # -daf
    daf_resume: Optional[List[str]] = None     # -daf_resume
    seed: int = 0
    start_segment: int = 10             # synthesis starts at segment 10

    # --- training -------------------------------------------------------- #
    epochs: int = 60
    start_epoch: Optional[int] = None
    batch_size: int = 32                # -bs
    mini_batchsize: int = 150           # -mbs: embed batch size
    lr: float = 1e-2
    lr_steps: int = 30
    momentum: float = 0.9
    weight_decay: float = 1e-4
    early_stop_loss: float = 0.07
    workers: int = 0                    # -j

    # --- bookkeeping ------------------------------------------------------ #
    print_freq: int = 5
    log_freq: int = 10
    val_freq: int = 5
    resume: str = ""
    evaluate: bool = False              # -e
    allow_random_init: bool = False     # -allow_random_init
    visualize_evaluate: bool = False    # -ve
    logdir: str = "./logs"
    logname: str = "exp"
    results_folder: str = "results"
    ckpt: str = "./ckpt"

    # --- device ----------------------------------------------------------- #
    mesh_shape: Optional[Sequence[int]] = None
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # ---------------------------------------------------------------------- #

    def derive_geometry(self, fps: float) -> "Config":
        """Apply the fps -> (window, stride) rule; returns a new Config.

        An explicit -fps flag (``fps_override``) beats the container fps.
        """
        if self.fps_override is not None:
            fps = self.fps_override
        stride = math.ceil(fps / 5)
        return dataclasses.replace(
            self,
            fps=fps,
            window=math.ceil(fps / 2),
            stride=stride,
            train_stride=(self.train_stride if self.train_stride is not None
                          else stride),
        )

    def train_logname(self, video_name: str) -> str:
        """Experiment-identity string of a training run (reference:
        main.py:398-415); names its checkpoints."""
        vd = os.path.split(self.vdata)[-1] if self.vdata else "none"
        return (
            f"{self.logname}_model_{self.model_type}_vd_{vd}_vn_{video_name}"
            f"_bs_{self.batch_size}_negs_{self.n_negs}_w_{self.window}"
            f"_stride_{self.stride}_temp_{self.temp}_th_{self.threshold}"
            f"_enca_{self.enc_arch}_subr_{self.subsample_rate}_eval_False"
        )

    def default_ckpt_path(self, video_name: str) -> str:
        """The best checkpoint a synthesis run loads when -resume is empty
        (reference: main.py:520-534): training's name with ``exp``,
        temp 0.1 and threshold 0.0 fixed, as the reference derives it."""
        vd = os.path.split(self.vdata)[-1] if self.vdata else "none"
        return os.path.join(
            self.ckpt,
            f"exp_model_{self.model_type}_vd_{vd}_vn_{video_name}"
            f"_bs_{self.batch_size}_negs_{self.n_negs}_w_{self.window}"
            f"_stride_{self.stride}_temp_0.1_th_0.0_enca_{self.enc_arch}"
            f"_subr_{self.subsample_rate}_eval_False_best",
        )

    def eval_logname(self, video_name: str) -> str:
        """Experiment-identity string for synthesis outputs."""
        vd = os.path.split(self.vdata)[-1] if self.vdata else "none"
        name = (
            f"{self.logname}_model_{self.model_type}_vd_{vd}_vn_{video_name}"
            f"_bs_{self.batch_size}_w_{self.window}"
            f"_stride_{self.stride}_temp_{self.temp}_th_{self.threshold}"
            f"_enca_{self.enc_arch}_subr_{self.subsample_rate}_eval_True"
        )
        if self.driving_audio is not None:
            name += f"alpha_{self.alpha}_daf_{self.da_feats}"
        return name


@dataclasses.dataclass
class ClassicConfig:
    """Config for the classic Schödl baseline (the port's copy of
    ``avtex/config.py::ClassicConfig``; field names and defaults follow
    the reference's classic_main flags)."""

    model_type: int = 1                 # -m: (1) Classic (2) Classic+ (3) Classic++
    vdata: Optional[str] = None
    adata: Optional[str] = None
    video_list: Optional[List[str]] = None
    feats: str = "RGB"                  # -f: RGB | ResNet | ResNet_VGGish
    slow: bool = False                  # -s: kept for flag parity
    fps: float = 30.0
    sr: int = 22050
    filter_size: int = 40               # -fs: diagonal binomial filter size
    batch_size: int = 64                # -bs: tile size in slow mode
    stride: int = 4
    new_video_length: int = 30          # -nvl (seconds)
    interpolation: bool = True          # -nintp
    SF: int = 3
    sigma: float = 0.5
    threshold: float = 0.08             # -t
    sigmas: Sequence[float] = (4.45, 4.5, 4.52, 4.55, 4.58)  # the sweep
    q_alpha: float = 0.997              # value-iteration discount
    q_p: float = 0.7                    # future-cost exponent
    q_eps: float = 1e-2                 # convergence epsilon
    start_frame: int = 100              # sampler seed frame
    seed: int = 0
    results_folder: str = "results_classic"
    logdir: str = "./logs"
    logname: str = "exp_classic"

"""Host-side frame/audio assembly for synthesized textures (the port of
avtex/synth/stitcher.py and the numpy paths of avtex/native/stitch.py).

``stitch_texture`` gathers frames and crossfades jumps through the C++
host runtime (``avtex_torch.native.stitch``), as avtex does whenever its
library is built; ``stitch_frames`` and ``crossfade`` here are their numpy
plain versions, byte-identical.

- the first chosen segment contributes its full W frames, every later one
  its last S frames;
- the interpolated texture runs at fps*(SF+1)/2: each frame is followed
  by (SF-1)/2 held copies, except at jumps, where the previous frame's
  copies are replaced by SF-1 interpolated frames (``interp_fn``, default
  the native linear crossfade) and the first new frame gets no copies;
- source-audio slices follow the emitted frame ids.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from avtex_torch.native import stitch as native_stitch


def stitch_frames(video: np.ndarray, frame_ids: np.ndarray,
                  frames_bar: bool = False,
                  total_input_frames: Optional[int] = None) -> np.ndarray:
    """Gather ``video[frame_ids]`` (+ optional red position bar in rows
    [H-25, H-10) with a 6-px marker at column ``id * W / total``)."""
    video = np.ascontiguousarray(video, dtype=np.uint8)
    frame_ids = np.ascontiguousarray(frame_ids, dtype=np.int64)
    t, h, w, _ = video.shape
    total = total_input_frames if total_input_frames is not None else t
    out = video[frame_ids]
    if frames_bar and h > 25:
        for i, fid in enumerate(frame_ids):
            col = int(fid * w / total) if total else 0
            out[i, h - 25:h - 10, :, :] = 0
            out[i, h - 25:h - 10, max(0, col - 3):min(w, col + 3)] = [255, 0, 0]
    return out


def crossfade(frame0: np.ndarray, frame1: np.ndarray, n_mid: int
              ) -> np.ndarray:
    """``n_mid`` linear blends between two uint8 frames, rounded half up."""
    f0 = np.asarray(frame0, dtype=np.uint8).astype(np.float32)
    f1 = np.asarray(frame1, dtype=np.uint8).astype(np.float32)
    t = (np.arange(1, n_mid + 1, dtype=np.float32)
         / (n_mid + 1))[:, None, None, None]
    return (f0[None] + t * (f1[None] - f0[None]) + 0.5).astype(np.uint8)


def walk_frame_ids(indices: Sequence[int], window: int, stride: int
                   ) -> Tuple[np.ndarray, List[int]]:
    """Chosen segment ids -> emitted frame ids + jump positions
    (``jump_at[k]`` indexes the first frame emitted by the k-th jump)."""
    out: List[int] = []
    jump_at: List[int] = []
    prev = -1
    for q_id in indices:
        q_id = int(q_id)
        if prev == -1:
            ids = range(q_id * stride, q_id * stride + window)
        else:
            ids = range(q_id * stride + window - stride, q_id * stride + window)
            if q_id != prev + 1:
                jump_at.append(len(out))
        out.extend(ids)
        prev = q_id
    return np.asarray(out, dtype=np.int64), jump_at


def expand_subsample(frame_ids: np.ndarray, subsample_rate: int) -> np.ndarray:
    """Emitted (subsampled) ids -> original-video ids."""
    if subsample_rate == 1:
        return frame_ids
    return (frame_ids[:, None] * subsample_rate
            + np.arange(subsample_rate)[None, :]).reshape(-1)


def stitch_texture(video: np.ndarray, indices: Sequence[int], window: int,
                   stride: int, *, sf: int = 5, subsample_rate: int = 1,
                   interpolate: bool = True,
                   interp_fn: Optional[Callable[[np.ndarray, np.ndarray, int],
                                                np.ndarray]] = None,
                   frames_bar: bool = False,
                   source_audio: Optional[np.ndarray] = None,
                   audio_sample_rate: int = 22050,
                   fps: float = 30.0) -> dict:
    """Assemble output frames (+audio) from a walk.

    ``video`` is the decoded uint8 [T, H, W, 3] (pre-subsample);
    ``interp_fn(frame0, frame1, n_mid) -> [n_mid, H, W, 3]`` defaults to
    the native crossfade. Returns {"frames", "frames_intp" (None unless
    interpolate), "frame_ids", "audio" (None without source audio),
    "jump_count"}.
    """
    frame_ids_sub, jump_at = walk_frame_ids(indices, window, stride)
    frame_ids = expand_subsample(frame_ids_sub, subsample_rate)
    frames = native_stitch.stitch_frames(video, frame_ids,
                                         frames_bar=frames_bar,
                                         total_input_frames=len(video))

    frames_intp = None
    if interpolate:
        if interp_fn is None:
            interp_fn = native_stitch.crossfade
        hold = (sf - 1) // 2
        jumps = set(jump_at)
        seq: List[np.ndarray] = []
        for k, fid in enumerate(frame_ids_sub):
            at_jump = k in jumps and k > 0
            if at_jump:
                # frame0: the last original of the previous id; frame1: the
                # first original of the jumped-to id.
                if hold:
                    del seq[-hold:]
                prev_frame = video[frame_ids[k * subsample_rate - 1]]
                next_frame = video[int(fid) * subsample_rate]
                seq.extend(interp_fn(prev_frame, next_frame, sf - 1))
            for s in range(subsample_rate):
                f = frames[k * subsample_rate + s]
                seq.append(f)
                if not (at_jump and s == 0):
                    seq.extend([f] * hold)
        frames_intp = np.stack(seq) if seq else None

    audio = None
    if source_audio is not None:
        apf = int(audio_sample_rate * subsample_rate / fps)
        chunks = [source_audio[i * apf:(i + 1) * apf] for i in frame_ids_sub]
        audio = np.concatenate(chunks) if chunks else None

    return {
        "frames": frames,
        "frames_intp": frames_intp,
        "frame_ids": frame_ids,
        "audio": audio,
        "jump_count": len(jump_at),
    }

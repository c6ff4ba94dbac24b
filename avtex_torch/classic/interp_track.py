"""Classic-baseline interpolated output track and position bars (the port
of avtex/classic/interp_track.py, numpy, bit-exact).

The reference sampler's ``new_frames_intp`` for model_type=1, quirks
included:

- the track opens with the start frame plus (SF-1)/2 held copies;
- every non-jump step appends the chosen frame with a red 6-px marker at
  column ``prev_idx * W / total`` (the PREVIOUS index) plus (SF-1)/2 held
  copies;
- at a jump the held copies of the previous frame are removed and SF-1
  interpolated frames are appended with a BLANK bar; the jumped-to frame
  itself is not appended (only its successors are);
- the initial bar ``bar[:, n-3:n+3]`` with n=0 is the empty slice in numpy,
  so the opening frame carries a blank bar. Raw python slicing keeps the
  edges bit for bit.

The main track's bar (``burn_position_bars``) has an 8-px marker and
floor division. Modes 2/3 build no interpolated track.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

BAR_RED = (255, 0, 0)


def _with_bar(frame: np.ndarray, marker_col: Optional[int]) -> np.ndarray:
    """Burn the 15-row bar into rows [-25, -10); red 6-px marker at
    ``marker_col`` (None = blank bar, used on interpolated frames)."""
    arr = np.array(frame, dtype=np.uint8)
    bar = np.zeros((15, arr.shape[1], 3), dtype=np.uint8)
    if marker_col is not None:
        # raw slice, reproducing the reference's n-3:n+3 (empty when n=0)
        bar[:, marker_col - 3: marker_col + 3, :] = BAR_RED
    arr[-25:-10, :, :] = bar
    return arr


def classic_interp_track(frames: np.ndarray, walk: np.ndarray, sf: int,
                         interp_fn: Callable[[np.ndarray, np.ndarray, int],
                                             np.ndarray],
                         total_frames: Optional[int] = None) -> np.ndarray:
    """Build the interpolated track for a classic mode-1 walk.

    Args:
      frames: source video uint8 [T, H, W, 3].
      walk: frame-index walk, walk[0] the start frame.
      sf: SuperSloMo factor; (SF-1)/2 held copies, SF-1 mids per jump.
      interp_fn: (frame0, frame1, n_mid) -> [n_mid, H, W, 3] uint8.
      total_frames: denominator for the bar position (default len(frames)).

    Returns uint8 [N, H, W, 3]; plays at fps*(SF+1)/2.
    """
    total = total_frames if total_frames is not None else len(frames)
    width = frames.shape[-2]
    hold = (sf - 1) // 2

    seq: List[np.ndarray] = []
    start = int(walk[0])
    first = _with_bar(frames[start], 0)  # n=0 -> blank bar
    seq.append(first)
    seq.extend([first] * hold)

    cur = start
    for nxt in np.asarray(walk[1:], dtype=np.int64):
        nxt = int(nxt)
        if nxt != cur + 1:  # jump: mids replace the held copies
            if hold:
                del seq[-hold:]
            for mid in interp_fn(frames[cur], frames[nxt], sf - 1):
                seq.append(_with_bar(mid, None))
        else:  # bar position from the PREVIOUS index
            marker = int(cur * width / total)
            f = _with_bar(frames[nxt], marker)
            seq.append(f)
            seq.extend([f] * hold)
        cur = nxt
    return np.stack(seq)


def burn_position_bars(tex_frames: np.ndarray, frame_ids: np.ndarray,
                       total_frames: int) -> np.ndarray:
    """Burn the main track's red position bar into every output frame
    (unconditional, 8-px marker, floor division)."""
    out = np.array(tex_frames, dtype=np.uint8)
    width = out.shape[-2]
    for k, fid in enumerate(np.asarray(frame_ids, dtype=np.int64)):
        bar = np.zeros((15, width, 3), dtype=np.uint8)
        n = int(fid * width // total_frames)
        bar[:, n - 4: n + 4, :] = BAR_RED
        out[k, -25:-10, :, :] = bar
    return out

"""Host-side media I/O: video decode/encode (OpenCV, imported at use),
wav (scipy) and AVI muxing."""

from .audio_io import read_wav, write_wav
from .mux import mux_audio_video, save_texture_outputs
from .video import read_video, video_fps, write_frames_png, write_video

__all__ = ["read_video", "video_fps", "write_video", "write_frames_png",
           "read_wav",
           "write_wav", "mux_audio_video", "save_texture_outputs"]

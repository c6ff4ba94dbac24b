"""Audio-frontend constants (VGGish feature semantics), the port's own
copy of avtex/audio/params.py.

Values match the reference's modified VGGish pipeline
(reference: contrastive_video_textures/utils/vggish_params.py:21-36):
16 kHz, 25 ms / 10 ms STFT, 64 mel bands over 125-7500 Hz, log offset 0.01,
and — the reference's modification — 1.0 s example windows with 0.1 s hop
(overlapping; one example per video segment).
"""

SAMPLE_RATE = 16000
STFT_WINDOW_SECONDS = 0.025     # 400 samples @ 16 kHz
STFT_HOP_SECONDS = 0.010        # 160 samples @ 16 kHz
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
EXAMPLE_WINDOW_SECONDS = 1.0    # 100 mel frames per example
EXAMPLE_HOP_SECONDS = 0.1       # 10 mel frames between examples

MEL_BREAK_FREQUENCY_HERTZ = 700.0
MEL_HIGH_FREQUENCY_Q = 1127.0

WINDOW_SAMPLES = int(round(SAMPLE_RATE * STFT_WINDOW_SECONDS))   # 400
HOP_SAMPLES = int(round(SAMPLE_RATE * STFT_HOP_SECONDS))         # 160
FFT_LENGTH = 512  # 2 ** ceil(log2(WINDOW_SAMPLES))
EXAMPLE_WINDOW_FRAMES = int(round(EXAMPLE_WINDOW_SECONDS / STFT_HOP_SECONDS))  # 100
EXAMPLE_HOP_FRAMES = int(round(EXAMPLE_HOP_SECONDS / STFT_HOP_SECONDS))        # 10

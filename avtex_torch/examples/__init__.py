"""The port's library examples (the counterparts of avtex's examples/).

Each module generates a tiny procedural clip, so no data is needed, and
runs as ``python -m avtex_torch.examples.<name>`` on the GPU, or with
``--device cpu`` on the CPU (``sharded_embed`` under ``torchrun`` for
more than one process). Each has a ``main(device=None, out_dir=None)``
that returns what it built and writes files only when given ``out_dir``.
They feed decoded frames to the port's frame entry points, so none needs
OpenCV: where avtex's example writes an mp4, the port's writes PNG frames
(``write_frames_png``) and, where there is audio, a wav beside them.

- ``quickstart``: train a contrastive model on one video, synthesize a
  texture.
- ``serve``: ``TextureServer`` warm serving, embed once, many requests.
- ``classic``: the classic Schödl sweep and the one-call transition
  matrix.
- ``sharded_embed``: the segment-sharded embed over a ``make_mesh`` mesh.
- ``audio_driven``: audio+video towers (``model_type=2``), synthesis
  driven by another wav.
"""

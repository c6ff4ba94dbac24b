"""The plain fp32 reference that decides ``correct``.

``<config>.py`` holds one configuration's encoder, plain PyTorch with the
program's parameter names, so that one dict of weights loads into both;
``common.py`` the shared plain arithmetic; ``towers.py`` the two towers,
the table rows of a segment and the reference's training steps. Nothing
here imports the program or JAX.
"""

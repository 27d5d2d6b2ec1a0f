"""Measurement tools of the port, run on the card as modules:

    python -m dynam3d_torch.tools.bench_int4_stream   # kernel I: ring depth x tile width
    python -m dynam3d_torch.tools.bench_int4_unpack   # kernel J: the four block bodies
"""

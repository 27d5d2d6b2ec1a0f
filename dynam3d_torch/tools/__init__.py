"""Tools of the port, run as modules:

    python -m dynam3d_torch.tools.bench_int4_stream   # kernel I: ring depth x tile width
    python -m dynam3d_torch.tools.bench_int4_unpack   # kernel J: the four block bodies
    python -m dynam3d_torch.tools.eval_soak --out DIR # full-length int4 eval episodes
    python -m dynam3d_torch.tools.record_episodes --out DIR
    python -m dynam3d_torch.tools.make_golden_fixtures --out DIR
"""

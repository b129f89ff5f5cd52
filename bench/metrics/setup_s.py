"""End-to-end metric `setup_s`: seconds from the start of the run's
process (the first line of ``run.py``) to the start of the window:
imports, the kernels' build or load, the weights drawn, the warm-up."""


def read(ctx):
    return ctx.setup_s

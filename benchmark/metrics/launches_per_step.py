"""Device operations launched a train step: the kernels, copies and sets
of the stretch traced with the CPU ops, each one launch by the host,
from every thread (autograd launches the backward from a worker thread
of its own), over the program's ``train.step`` spans. In that stretch
the host runs the loader's batches and the steps alone. None where the
program has no such spans."""

from benchmark import spans


def read(ctx):
    t = ctx.attributed
    if t is None:
        return None
    n_steps = sum(1 for _, _, name in t.host if name == spans.STEP)
    if not n_steps:
        return None
    return len(t.device) / n_steps

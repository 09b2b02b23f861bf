"""setup_s: seconds from the run's start to the window's start: the
node agent, the placement, the pods' start, weights and inputs from the
seed, the warm-up of every shape (host clock)."""


def read(ctx):
    return ctx.setup_s

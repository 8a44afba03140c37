"""Mean of the engine's queue length after every step of the window."""


def read(run):
    t1 = run.t0 + run.seconds
    qs = [q for _, end, q in run.steps if end < t1]
    return sum(qs) / len(qs) if qs else None

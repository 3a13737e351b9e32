"""TPU007 true positives in the port's idiom: a compiled function made
per call — inside a loop, invoked where it is made, bound and called in
an uncached function, or compiled by a decorator on a nested def."""

import torch


def run_all(fns, x):
    outs = []
    for f in fns:
        g = torch.compile(f)  # EXPECT: TPU007
        outs.append(g(x))  # EXPECT: TPU007
    return outs


def once(f, x):
    return torch.compile(f)(x)  # EXPECT: TPU007


def twice(f, x):
    g = torch.jit.script(f)
    return g(x) + g(x)  # EXPECT: TPU007 # EXPECT: TPU007


def nested(x):
    @torch.compile
    def inner(y):  # EXPECT: TPU007
        return y * 2.0

    return inner(x)

"""TPU001 true positives in the port's idiom: host syncs, nonlocal
mutation and branches on a tensor's value inside functions that
torch.compile or TorchScript compiles."""

import functools

import numpy as np
import torch

_STATS = {"calls": 0}


@torch.compile
def normalize(x):
    top = x.max().item()  # EXPECT: TPU001
    return x / top


@torch.compile(mode="reduce-overhead")
def clip(x, limit):
    if x.sum() > limit:  # EXPECT: TPU001
        return x.clamp(max=limit)
    return x


@torch.jit.script
def as_list(x):
    return x.tolist()  # EXPECT: TPU001


@functools.partial(torch.compile, fullgraph=True)
def host_copy(x):
    return np.asarray(x)  # EXPECT: TPU001


def _count(x):
    _STATS["calls"] = _STATS["calls"] + 1  # EXPECT: TPU001
    torch.cuda.synchronize()  # EXPECT: TPU001
    while x.abs().max() > 1.0:  # EXPECT: TPU001
        x = x / 2
    return float(x.sum())  # EXPECT: TPU001


counted = torch.compile(_count)


def _traced(x):
    return x.cpu() + x.numpy()  # EXPECT: TPU001 # EXPECT: TPU001


traced = torch.jit.trace(_traced, (torch.ones(2),))

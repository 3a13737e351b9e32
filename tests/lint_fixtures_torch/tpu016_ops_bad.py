"""TPU016 true positives (ops scope): a loader reached by no device
guard, a guard whose CPU side runs no plain version, a guarded launch
that no function raises for other devices, and a load at module scope."""
# tpulint: ops-module

import functools

from opensearch_tpu_torch.ops import cuda_lib


@functools.lru_cache(maxsize=None)
def _library():  # EXPECT: TPU016
    return cuda_lib.load("scale")


def scale_unguarded(x):  # EXPECT: TPU016
    # launches with no device guard at all: a CPU tensor reaches ctypes
    _library().scale_launch(x.data_ptr(), x.numel())
    return x


def _other_library():  # EXPECT: TPU016
    return cuda_lib.load("other")


def other(x):  # EXPECT: TPU016
    # guarded, but its CPU side raises instead of running a plain version
    if x.device.type != "cuda":
        raise ValueError("the card only")
    _other_library().other_launch(x.data_ptr())
    return x


def _third_library():  # EXPECT: TPU016
    return cuda_lib.load("third")


def plain_third(x):
    return x


def third(x):  # EXPECT: TPU016
    # a CPU branch, but any other device falls through to the launch
    if x.device.type == "cpu":
        return plain_third(x)
    _third_library().third_launch(x.data_ptr())
    return x


_EAGER = cuda_lib.load("eager")  # EXPECT: TPU016

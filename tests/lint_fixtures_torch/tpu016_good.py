"""TPU016 false-positive guards: the port's kernel-module shape — an
ops-scoped module whose loader and launches are reachable (here through
module-internal helpers) from a wrapper carrying the device guard, whose
CPU branch runs the plain version and which raises for any other device,
itself or through a check it calls."""
# tpulint: ops-module

import functools

from opensearch_tpu_torch.ops import cuda_lib


@functools.lru_cache(maxsize=None)
def _library():
    return cuda_lib.load("scale")


def _scale_library():
    return _library()


def plain_scale(x):
    return x * 2.0


def _launch(x):
    out = x.clone()
    _scale_library().scale_launch(out.data_ptr(), out.numel())
    return out


def scale(x):
    if x.device.type == "cpu":
        return plain_scale(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device [{x.device}]")
    return _launch(x)


def _check(x):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device [{x.device}]")


def _stage(x):
    if x.is_cuda:
        return _launch(x)
    return plain_scale(x)


def scale_auto(x):
    _check(x)
    return _stage(x)

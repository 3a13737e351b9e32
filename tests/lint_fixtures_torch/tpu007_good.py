"""TPU007 false-positive guards: compiled once per process — a module
binding, a module-level decorator, or an lru_cache'd factory."""

import functools

import torch


def _double(x):
    return x * 2.0


double = torch.compile(_double)


@torch.compile
def triple(x):
    return x * 3.0


@functools.lru_cache(maxsize=None)
def compiled_for(mode: str):
    g = torch.compile(_double, mode=mode)
    return g


@functools.lru_cache(maxsize=None)
def scaled(k: float):
    @torch.compile
    def inner(x):
        return x * k

    return inner


def serve(x):
    return double(x) + triple(x) + compiled_for("default")(x)

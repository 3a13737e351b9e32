"""TPU014 false-positive guards: uploads whose function accounts them
with the residency ledger (register / record_transient), host-side
tensors and casts, and a line suppression with its reason."""
# tpulint: device-module

import torch

from opensearch_tpu_torch.telemetry.device_ledger import default_ledger


def publish_column(host_array, device, field):
    dev = torch.from_numpy(host_array).to(device)
    default_ledger.register("column", dev.nbytes, field=field)
    return dev


def padded_batch(rows, device):
    q = torch.as_tensor(rows, dtype=torch.float32, device=device)
    default_ledger.record_transient("query_batch", q.nbytes)
    return q


def nested_put(arrays, device):
    put = lambda a: torch.from_numpy(a).to(device)
    out = [put(a) for a in arrays]
    default_ledger.register("column", sum(t.nbytes for t in out))
    return out


def host_only(a):
    t = torch.from_numpy(a).to(torch.float32)  # a cast, not an upload
    u = torch.tensor(a, device="cpu")
    return t, u.to(t.dtype)


def scalar(x, device):
    return torch.tensor(  # tpulint: disable=TPU014 - per-launch scalar
        x, dtype=torch.float32, device=device)

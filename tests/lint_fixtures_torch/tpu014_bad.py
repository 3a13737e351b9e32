"""TPU014 true positives in the port's idiom: host-to-card uploads in a
device-serving module with no residency-ledger accounting in the
enclosing function."""
# tpulint: device-module

import numpy as np
import torch


def publish_column(host_array, device):
    return torch.from_numpy(host_array).to(device)  # EXPECT: TPU014


def publish_many(arrays, device):
    put = lambda a: torch.as_tensor(a, device=device)  # EXPECT: TPU014
    return [put(a) for a in arrays]


class SlabCache:
    def upload(self, slab):
        self.slab = torch.tensor(slab, dtype=torch.float32,  # EXPECT: TPU014
                                 device="cuda")
        return self.slab

    def to_card(self, t):
        return t.cuda()  # EXPECT: TPU014

    def keyed(self, a, dev):
        return torch.from_numpy(np.ascontiguousarray(a)).to(  # EXPECT: TPU014
            device=dev)

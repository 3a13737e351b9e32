"""TPU016 true positives in the port's idiom (outside ops/): serving code
that loads a kernel library itself, past the device dispatch."""

from opensearch_tpu_torch.ops import cuda_lib
from opensearch_tpu_torch.ops.cuda_lib import load


def serve_scores(x):
    lib = cuda_lib.load("double")  # EXPECT: TPU016
    lib.double_launch(x.data_ptr(), x.numel())
    return x


def serve_other(x):
    return load("other")  # EXPECT: TPU016

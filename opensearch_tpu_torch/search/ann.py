"""Live-tunable kNN serving configuration: the exact path's kernel policy
and scan precision.

Counterpart of opensearch_tpu/search/ann.py, with the same settings and
values for the exact path:

  search.knn.kernel                  "auto" | "pallas" | "xla"
  search.knn.score_precision         "fp32" | "bf16" | "int8"

In the port "pallas" means the hand-written kernel and "xla" the plain
PyTorch version; both are explicit requests. "auto" resolves to "pallas":
the kernel's wrapper then picks by the tensor's device (the kernel on a
CUDA tensor, its plain version on a CPU tensor). The ANN settings
(search.knn.ann.*) come with the IVF-PQ slice.

The config object is PROCESS-wide: the serving sites are module-level code
with no node handle, and one process serves one device.
"""

from __future__ import annotations

from opensearch_tpu_torch.common.settings import Property, Setting, Settings

KERNEL_POLICIES = ("auto", "pallas", "xla")


def _validate_exact_kernel(v: str) -> None:
    if v not in KERNEL_POLICIES:
        raise ValueError(
            f"unknown [search.knn.kernel] value [{v}] "
            f"(choose from {list(KERNEL_POLICIES)})"
        )


def _validate_score_precision(v: str) -> None:
    from opensearch_tpu_torch.ops.knn_fused import SCORE_PRECISIONS

    if v not in SCORE_PRECISIONS:
        raise ValueError(
            f"unknown [search.knn.score_precision] value [{v}] "
            f"(choose from {list(SCORE_PRECISIONS)})"
        )


EXACT_KERNEL_SETTING: Setting[str] = Setting(
    "search.knn.kernel", "auto", str,
    Property.NODE_SCOPE, Property.DYNAMIC,
    validator=_validate_exact_kernel,
)
SCORE_PRECISION_SETTING: Setting[str] = Setting(
    "search.knn.score_precision", "fp32", str,
    Property.NODE_SCOPE, Property.DYNAMIC,
    validator=_validate_score_precision,
)


def resolve_kernel(policy: str) -> str:
    """The EFFECTIVE scan for this dispatch: "pallas" or "xla". "auto" is
    the hand-written kernel's wrapper, which never falls back to the plain
    version for a CUDA tensor."""
    _validate_exact_kernel(policy)
    return "pallas" if policy == "auto" else policy


class AnnServingConfig:
    """Process-wide kNN serving knobs. Fields are plain atomic assignments
    read racily by design: a dispatch that read the old values completes
    under the old policy."""

    def __init__(self) -> None:
        self.exact_kernel: str = EXACT_KERNEL_SETTING.default(Settings.EMPTY)
        self.score_precision: str = SCORE_PRECISION_SETTING.default(
            Settings.EMPTY)

    def configure(self, *, exact_kernel: str | None = None,
                  score_precision: str | None = None) -> None:
        if exact_kernel is not None:
            _validate_exact_kernel(exact_kernel)
            self.exact_kernel = exact_kernel
        if score_precision is not None:
            _validate_score_precision(score_precision)
            self.score_precision = score_precision


default_config = AnnServingConfig()

"""Live-tunable kNN serving configuration: the ANN (IVF-PQ) knobs, and the
kernel policy and scan precision of both paths.

Counterpart of opensearch_tpu/search/ann.py, with the same settings and
values:

  search.knn.ann.adc_precision       "fp32" | "bf16" | "int8"
  search.knn.ann.rescore_multiplier  exact-rescore pool = multiplier * k
  search.knn.ann.kernel              "auto" | "pallas" | "xla" (ANN scan)
  search.knn.kernel                  "auto" | "pallas" | "xla" (EXACT path)
  search.knn.score_precision         "fp32" | "bf16" | "int8" (EXACT scan)

In the port "pallas" means the hand-written kernel (K2 for the ANN scan,
K1 for the exact scan) and "xla" the plain PyTorch version: for the ANN
scan, "xla" is the monolithic ops/ivfpq.search lowering, as in the
reference. "auto" resolves to "pallas": the kernel's wrapper then picks by
the tensor's device (the kernel on a CUDA tensor, its plain version on a
CPU tensor). The reference resolves "auto" per platform instead; the
port never falls back to the plain version because a card is missing.

Reduced-precision ADC only ranks candidates; the ANN pipeline always ends
in an exact fp32 rescore over the widened pool.

``bucket_nprobe`` is the serving tier's nprobe shape policy: the next
power of two, clamped to nlist (extra probes only add recall).

The config object is PROCESS-wide: the serving sites are module-level code
with no node handle, and one process serves one device.
"""

from __future__ import annotations

from opensearch_tpu_torch.common.settings import Property, Setting, Settings

KERNEL_POLICIES = ("auto", "pallas", "xla")


def _validate_precision(v: str) -> None:
    from opensearch_tpu_torch.ops.ivfpq import ADC_PRECISIONS

    if v not in ADC_PRECISIONS:
        raise ValueError(
            f"unknown [search.knn.ann.adc_precision] value [{v}] "
            f"(choose from {list(ADC_PRECISIONS)})"
        )


def _validate_policy(setting: str, v: str) -> None:
    """The one validator of both kernel-policy settings (they take the
    same values); `setting` names the key in the error."""
    if v not in KERNEL_POLICIES:
        raise ValueError(
            f"unknown [{setting}] value [{v}] "
            f"(choose from {list(KERNEL_POLICIES)})"
        )


def _validate_score_precision(v: str) -> None:
    from opensearch_tpu_torch.ops.knn_fused import SCORE_PRECISIONS

    if v not in SCORE_PRECISIONS:
        raise ValueError(
            f"unknown [search.knn.score_precision] value [{v}] "
            f"(choose from {list(SCORE_PRECISIONS)})"
        )


ADC_PRECISION_SETTING: Setting[str] = Setting(
    "search.knn.ann.adc_precision", "fp32", str,
    Property.NODE_SCOPE, Property.DYNAMIC,
    validator=_validate_precision,
)
RESCORE_MULTIPLIER_SETTING = Setting.int_setting(
    "search.knn.ann.rescore_multiplier", 4,
    Property.NODE_SCOPE, Property.DYNAMIC, min_value=1, max_value=256,
)
KERNEL_SETTING: Setting[str] = Setting(
    "search.knn.ann.kernel", "auto", str,
    Property.NODE_SCOPE, Property.DYNAMIC,
    validator=lambda v: _validate_policy("search.knn.ann.kernel", v),
)
EXACT_KERNEL_SETTING: Setting[str] = Setting(
    "search.knn.kernel", "auto", str,
    Property.NODE_SCOPE, Property.DYNAMIC,
    validator=lambda v: _validate_policy("search.knn.kernel", v),
)
SCORE_PRECISION_SETTING: Setting[str] = Setting(
    "search.knn.score_precision", "fp32", str,
    Property.NODE_SCOPE, Property.DYNAMIC,
    validator=_validate_score_precision,
)

# the keys `PUT /_cluster/settings` validates and applies
# (cluster/cluster_settings.py; AnnServingConfig.apply_settings)
ANN_SETTINGS = (ADC_PRECISION_SETTING, RESCORE_MULTIPLIER_SETTING,
                KERNEL_SETTING, EXACT_KERNEL_SETTING,
                SCORE_PRECISION_SETTING)


def resolve_kernel(policy: str) -> str:
    """The EFFECTIVE scan for this dispatch, on either path: "pallas" or
    "xla". "auto" is the hand-written kernel's wrapper, which never falls
    back to the plain version for a CUDA tensor."""
    _validate_policy("search.knn.kernel", policy)
    return "pallas" if policy == "auto" else policy


def bucket_nprobe(nprobe: int, nlist: int) -> int:
    """Power-of-two ceiling, clamped to [1, nlist] (more probes never lose
    recall)."""
    nprobe = max(1, int(nprobe))
    return min(1 << (nprobe - 1).bit_length(), max(1, int(nlist)))


class AnnServingConfig:
    """Process-wide kNN serving knobs. Fields are plain atomic assignments
    read racily by design: a dispatch that read the old values completes
    under the old policy."""

    def __init__(self) -> None:
        self.adc_precision: str = ADC_PRECISION_SETTING.default(
            Settings.EMPTY)
        self.rescore_multiplier: int = RESCORE_MULTIPLIER_SETTING.default(
            Settings.EMPTY)
        self.kernel: str = KERNEL_SETTING.default(Settings.EMPTY)
        self.exact_kernel: str = EXACT_KERNEL_SETTING.default(Settings.EMPTY)
        self.score_precision: str = SCORE_PRECISION_SETTING.default(
            Settings.EMPTY)

    def configure(self, *, adc_precision: str | None = None,
                  rescore_multiplier: int | None = None,
                  kernel: str | None = None,
                  exact_kernel: str | None = None,
                  score_precision: str | None = None) -> None:
        if adc_precision is not None:
            _validate_precision(adc_precision)
            self.adc_precision = adc_precision
        if rescore_multiplier is not None:
            self.rescore_multiplier = max(1, int(rescore_multiplier))
        if kernel is not None:
            _validate_policy(KERNEL_SETTING.key, kernel)
            self.kernel = kernel
        if exact_kernel is not None:
            _validate_policy(EXACT_KERNEL_SETTING.key, exact_kernel)
            self.exact_kernel = exact_kernel
        if score_precision is not None:
            _validate_score_precision(score_precision)
            self.score_precision = score_precision

    def apply_settings(self, flat: dict) -> None:
        """Pick this config's keys out of a flat effective-settings map
        (the cluster-settings update consumer; absent keys -> defaults)."""
        s = Settings.from_flat({
            st.key: flat[st.key] for st in ANN_SETTINGS if st.key in flat
        })
        self.configure(
            adc_precision=ADC_PRECISION_SETTING.get(s),
            rescore_multiplier=RESCORE_MULTIPLIER_SETTING.get(s),
            kernel=KERNEL_SETTING.get(s),
            exact_kernel=EXACT_KERNEL_SETTING.get(s),
            score_precision=SCORE_PRECISION_SETTING.get(s),
        )

    def snapshot(self) -> dict:
        from opensearch_tpu_torch.index.device import ann_build_stats

        return {
            "adc_precision": self.adc_precision,
            "rescore_multiplier": self.rescore_multiplier,
            "kernel": self.kernel,
            "exact_kernel": self.exact_kernel,
            "score_precision": self.score_precision,
            # IVF-PQ structures this process built at refresh, and their cost
            "index_builds": ann_build_stats(),
        }


default_config = AnnServingConfig()

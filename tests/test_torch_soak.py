"""The chaos soak (testing/soak.py) of the port against the reference's.

Each tier-1 case of tests/test_soak.py runs twice under its own seeds: as
the reference wrote it, and as the port's copy (the import-rewriting
harness of tests/test_torch_cluster_data.py: every ``opensearch_tpu``
import rewritten to ``opensearch_tpu_torch`` and every ``run_soak(...)``
given ``device="cpu"``). Both runs must pass the reference's own
assertions, and their observations must be equal (``run_both``'s
:class:`Recorder`: every sim step's cluster view, every message the sim
carries, every client response, kNN scores to rtol 1e-6). On top, every
event-log digest either run computes (each cycle's, a failure's and the
final one) must be equal, in order: the two packages replay one seed to
the same bytes. No digest differs so far; where one does, the assertion
names the first event of the log that differs.

The reference's tests count kernel launches by roofline family. The port
records the same families under the same names, so the port's copy of
each case reads them unchanged; on the card each family's launches are
its hand-written kernel's:

- ``knn_fused_pallas[...]``: K1 on the per-shard route
  (``ops/knn_fused.py``; on the card ``knn_fused.launches``);
- ``mesh_knn_fused[...]``: K1 in the stacked serving step
  (``search/distributed_serving.py``; on the card ``knn_fused.launches``);
- ``ivfpq_adc_pallas[...]``: K2, the IVF-PQ ADC scan (``ops/adc_scan.py``;
  on the card ``adc_scan.launches``);
- ``distributed_serving.stats["distributed_searches"]``: the port's
  ``search/distributed_serving.stats`` counter of the same name.

On a CPU tensor each wrapper runs its kernel's plain version and counts
no launch (``chip_smoke.py --phases soak`` counts them on the card).

The reference's file takes about 90 s on one worker, so the port's cases
are split: the ones here, and the fault kinds, the throughput ratchet and
the acceptance runs in tests/test_torch_soak_faults.py.
"""

from __future__ import annotations

import importlib
from pathlib import Path

import pytest

pytest.importorskip("jax")

from test_torch_cluster_data import cases, run_both

REFERENCE = "test_soak"
PACKAGES = ("opensearch_tpu", "opensearch_tpu_torch")
# the cases in tests/test_torch_soak_faults.py
FAULT_CASES = (
    "test_soak_single_fault_kind_degrades_gracefully",
    "test_soak_throughput_ratchet_against_repo_baseline",
    "test_soak_throughput_floor_violation_fails_with_seed",
    "test_floors_from_report_takes_cycle_minimum",
    "test_chaos_soak_five_cycles",
    "test_chaos_soak_topology_with_snapshots_acceptance",
)


def _marks(case) -> list:
    """The reference case's own ``slow`` / ``chaos`` marks."""
    _cls, fname, _params = case.values[0]
    fn = getattr(importlib.import_module(REFERENCE), fname)
    return [m for m in getattr(fn, "pytestmark", [])
            if m.name in ("slow", "chaos")]


def reference_cases(names=None, skip=()) -> list:
    out = []
    for case in cases(importlib.import_module(REFERENCE), skip=skip):
        if names is not None and case.values[0][1] not in names:
            continue
        out.append(pytest.param(*case.values, id=case.id,
                                marks=_marks(case)))
    return out


class Digests:
    """Every event-log digest a package's soak computes, with the event
    log it hashed."""

    def __init__(self, package: str):
        self.package = package
        self.logs: list[tuple[str, list[str]]] = []
        self._mp = pytest.MonkeyPatch()

    def __enter__(self):
        soak = importlib.import_module(f"{self.package}.testing.soak")
        digest = soak.SoakHarness.digest
        logs = self.logs

        def recorded(harness, __digest=digest):
            out = __digest(harness)
            logs.append((out, list(harness._events)))
            return out

        self._mp.setattr(soak.SoakHarness, "digest", recorded)
        return self

    def __exit__(self, *exc):
        self._mp.undo()
        return False


def first_difference(ref: list[str], port: list[str]) -> str:
    for i, (a, b) in enumerate(zip(ref, port)):
        if a != b:
            return f"event {i}: reference {a!r}, port {b!r}"
    return (f"event {min(len(ref), len(port))}: the reference's log has "
            f"{len(ref)} events, the port's {len(port)}")


def run_both_soak(case, tmp_path: Path) -> None:
    """``run_both`` of one reference soak case, then the digests' check."""
    digests = {p: Digests(p) for p in PACKAGES}
    with digests["opensearch_tpu"], digests["opensearch_tpu_torch"]:
        run_both(REFERENCE, case, tmp_path)
    ref, port = (digests[p].logs for p in PACKAGES)
    assert ref, "the case computed no digest"
    assert len(ref) == len(port), (len(ref), len(port))
    for i, ((d_ref, log_ref), (d_port, log_port)) in enumerate(
            zip(ref, port)):
        assert d_ref == d_port, (
            f"digest {i} differs: {d_ref} vs {d_port}; first at "
            f"{first_difference(log_ref, log_port)}")


@pytest.mark.parametrize("case", reference_cases(skip=FAULT_CASES))
def test_reference_case(case, tmp_path):
    run_both_soak(case, tmp_path)


def test_cases_cover_the_reference():
    """The two files hold every case of the reference's, its 21 tier-1
    cases and its 3 slow ones (one parametrized over two seeds)."""
    from test_torch_soak_faults import CASES as fault_cases

    here = reference_cases(skip=FAULT_CASES)
    every = reference_cases()
    assert len(here) + len(fault_cases) == len(every) == 24
    tier1 = [c for c in every if not c.marks]
    assert len(tier1) == 21


def test_soak_runs_on_the_card_unless_asked(tmp_path):
    """``run_soak`` and its harness default to ``device="cuda"``: without
    a card the soak raises before it serves anything; asked for the CPU,
    every node (the joiner of a topology cycle too) puts its shards
    there."""
    import torch

    from opensearch_tpu_torch.testing import soak

    assert soak.SoakConfig(seed=1).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(Exception, match="(?i)cuda"):
            soak.run_soak(3, tmp_path / "cuda", cycles=1, ops_per_cycle=4)
    devices = set()
    close = soak.SoakHarness.close

    def closing(harness):
        for node in harness.nodes.values():
            devices.add(str(node.device))
            devices.update(str(sh.engine.device)
                           for sh in node.local_shards.values())
        close(harness)

    mp = pytest.MonkeyPatch()
    mp.setattr(soak.SoakHarness, "close", closing)
    try:
        report = soak.run_soak(7, tmp_path / "cpu", cycles=1,
                               ops_per_cycle=14, topology_cycle=0,
                               device="cpu")
    finally:
        mp.undo()
    assert "join_started" in [m["event"] for m in report.topology]
    assert devices == {"cpu"}

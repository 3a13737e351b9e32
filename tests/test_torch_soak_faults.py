"""The chaos soak of the port against the reference's, second half: the
fault kinds one at a time, the throughput ratchet against the repo's
``soak_baseline.json``, the floors' rule and the two slow acceptance
runs (marked ``slow`` and ``chaos``, as the reference marks them). Each
case runs on both packages as tests/test_torch_soak.py says; then the
soak's command line on the port.

The ratchet reads the committed ``soak_baseline.json``, read-only. The
soak's rates are in the sim's virtual time, and the port replays the
reference's event log byte for byte, so each cycle's per-class rates, and
the floors a run records, are the reference's
(:func:`test_port_rates_are_the_references`): the reference's floors hold
for the port, and the port keeps no baseline file of its own.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

from test_torch_soak import FAULT_CASES, reference_cases, run_both_soak

CASES = reference_cases(names=FAULT_CASES)
REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, tmp_path):
    run_both_soak(case, tmp_path)


def test_port_rates_are_the_references(tmp_path):
    """The tier-1 subset's per-cycle rates, and the floors they record,
    equal the reference's exactly; both clear the committed floors."""
    from opensearch_tpu.testing import soak as ref_soak
    from opensearch_tpu_torch.testing import soak as port_soak

    floors = port_soak.load_baseline(REPO / "soak_baseline.json")
    assert floors == ref_soak.load_baseline(REPO / "soak_baseline.json")
    kw = dict(cycles=2, ops_per_cycle=18, throughput_floors=floors)
    ref = ref_soak.run_soak(7, tmp_path / "ref", **kw)
    port = port_soak.run_soak(7, tmp_path / "port", device="cpu", **kw)
    assert port.throughput == ref.throughput
    assert port_soak.floors_from_report(port) == \
        ref_soak.floors_from_report(ref)
    for rates in port.throughput.values():
        for cls, floor in floors.items():
            assert rates[cls] >= floor * port_soak.ThroughputFloor.FACTOR


def _cli(tmp_path, *args) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "opensearch_tpu_torch.testing.soak", *args],
        capture_output=True, text=True, cwd=str(REPO), timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "TMPDIR": str(tmp_path), "PYTHONPATH": str(REPO)})


def test_cli_runs_on_the_cpu_when_asked(tmp_path):
    record = tmp_path / "floors.json"
    proc = _cli(tmp_path, "--seed", "7", "--cycles", "1", "--ops", "10",
                "--device", "cpu", "--record-baseline", str(record))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert report["seed"] == 7 and report["cycles_completed"] == 1
    assert report["ops_completed"] == report["ops_issued"]
    assert json.loads(record.read_text())["floors"]


def test_cli_defaults_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    proc = _cli(tmp_path, "--cycles", "1", "--ops", "4")
    assert proc.returncode != 0
    assert "cuda" in (proc.stdout + proc.stderr).lower()

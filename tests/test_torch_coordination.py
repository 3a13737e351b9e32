"""The election and publication core over the deterministic sim: the
port's Coordinator against the reference's.

Every case of tests/test_coordination.py runs twice on its seed, as the
reference wrote it and as the port's copy
(:func:`test_torch_cluster_data.port_module`), through
:func:`test_torch_cluster_data.run_both`: both runs pass the reference's
assertions, and after each step of the sim's queue every coordinator's
mode, leader, term, applied version and committed voting configuration
are equal, as is every message the transport carries.
"""

from __future__ import annotations

import importlib

import pytest

pytest.importorskip("jax")

from test_torch_cluster_data import cases, run_both

REFERENCE = "test_coordination"


@pytest.mark.parametrize("case", cases(importlib.import_module(REFERENCE)))
def test_reference_case(case, tmp_path):
    run_both(REFERENCE, case, tmp_path)

"""tpulint for the port: AST + dataflow invariant checker for
``opensearch_tpu_torch/``, the reference linter's rules with four of them
rewritten for PyTorch and CUDA.

Nineteen project-specific rules guard the invariants that ordinary
linters cannot see:

- TPU001 jit-purity        — no host syncs (.item/.tolist/.cpu/.numpy,
                             synchronize) / nonlocal mutation /
                             data-dependent control flow inside
                             torch.compile / torch.jit functions
- TPU002 blocking-in-async — no time.sleep / blocking IO / untimed
                             Lock.acquire inside ``async def`` bodies
- TPU003 lock-discipline   — attributes written under ``with self._lock``
                             must not be touched lock-free elsewhere in
                             the class; lock pairs acquire in one order
- TPU004 determinism       — modules that run under testing/sim.py must
                             use the injected clock / seeded RNG, never
                             time.time() / random.* / datetime.now()
- TPU005 exception-hygiene — ``except Exception`` bodies must log,
                             re-raise, or record the error
- TPU006 injectable-ids    — no uuid4/os.urandom/secrets.* in sim-run
                             modules; entropy comes from randutil/the
                             scheduler's seeded Random
- TPU007 retracing-risk    — no torch.compile / torch.jit function
                             made per call
- TPU008 callback-leak     — path-sensitive must-call-exactly-once over
                             the per-function CFG (lint/cfg.py): no path
                             through a listener handler may drop both
                             on_response/on_failure or invoke both
- TPU009 unbounded-growth  — long-lived transport/queue attributes must
                             have a size bound, shed, or eviction
- TPU010 lock-order        — TPU003's inversion detection propagated
                             across method boundaries via acquired-locks
                             call summaries
- TPU011 data-worker-block — untimed waits / blocking IO inside callables
                             offloaded to the serial data worker
- TPU012 span-leak         — path-sensitive begin_span/end_span pairing
                             over the per-function CFG: every non-raising
                             path must end a manually opened span or hand
                             it off (closure, store, return, argument)
- TPU013 metric-hygiene    — metric names are registered constants
- TPU014 naked-device-put  — host-to-card uploads in serving modules go
                             through the device-residency ledger
- TPU015 unmodeled-kernel  — profiled kernels name a roofline cost model
- TPU016 naked-pallas-call — cuda_lib.load only under ops/, behind
                             wrappers carrying the device guard whose
                             CPU branch runs the plain version
- TPU017 untracked-structure-read — roofline.record_launch sites record
                             a ledger heat touch
- TPU018 cross-pool-shared-state — no racy attribute shared across
                             thread roles
- TPU019 atomicity         — no check-then-act / read-modify-write across
                             a lock release on shared state

Run with ``python -m opensearch_tpu_torch.lint [paths]`` (default: the
package); violations already present in the port's baseline,
``opensearch_tpu_torch/lint_baseline.json`` (empty), are tolerated
(ratchet), new ones fail.
``--fix`` applies mechanical rewrites (wallclock -> timeutil, entropy ->
randutil, swallowed ``except: pass`` -> logged); ``--changed`` lints only
files differing from git HEAD; ``--jobs N`` parses in parallel. Suppress
a line with ``# tpulint: disable=TPU00N``.
"""

from opensearch_tpu_torch.lint.core import (  # noqa: F401
    Checker,
    FileContext,
    Violation,
    lint_paths,
    lint_source,
)
from opensearch_tpu_torch.lint.rules import ALL_CHECKERS, RULES  # noqa: F401

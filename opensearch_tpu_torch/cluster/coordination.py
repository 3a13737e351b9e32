"""Coordination safety core: term/vote/quorum rules. Pure logic, no IO.

Reimplements the safety-critical semantics of the reference's
CoordinationState (server/src/main/java/org/opensearch/cluster/coordination/
CoordinationState.java:64 — handleStartJoin:213, handleJoin:264, publish
request/response/commit quorum logic). SURVEY.md §7 ranks "replicated
control-plane correctness" among the hard parts and says to keep these rules
exactly: a node only votes once per term, a candidate must not be behind the
voter's accepted state, election and publication both require quorums in
BOTH the last-committed and last-accepted voting configurations, and a
commit only applies to the exact (term, version) last accepted.

Everything here is synchronous and deterministic — the Coordinator FSM
(coordinator.py) drives it over a transport; the simulation harness
(testing/sim.py) model-checks it under partitions and message loss.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from opensearch_tpu_torch.cluster.state import ClusterState, VotingConfiguration


class CoordinationError(Exception):
    """A rejected coordination message (the reference's
    CoordinationStateRejectedException)."""


@dataclass(frozen=True)
class StartJoinRequest:
    source_id: str      # the candidate asking for votes
    term: int


@dataclass(frozen=True)
class Join:
    voter_id: str
    candidate_id: str
    term: int
    last_accepted_term: int
    last_accepted_version: int


@dataclass(frozen=True)
class PublishRequest:
    state: ClusterState


@dataclass(frozen=True)
class PublishResponse:
    term: int
    version: int


@dataclass(frozen=True)
class ApplyCommitRequest:
    term: int
    version: int


class PersistedState:
    """What must survive restart (gateway/PersistedClusterStateService:137
    analog). With a `store` attached, every term bump and state acceptance
    is WRITE-AHEAD persisted (disk first, then memory) — a node that
    crashes mid-vote can never double-vote in its old term, and a
    full-cluster restart recovers the last accepted metadata. Without a
    store (sim tests) it is memory-only."""

    def __init__(self, current_term: int = 0,
                 accepted_state: ClusterState | None = None,
                 store=None):
        self._term = current_term
        self._accepted = accepted_state or ClusterState()
        self.store = store

    @property
    def current_term(self) -> int:
        return self._term

    @current_term.setter
    def current_term(self, term: int) -> None:
        if self.store is not None:
            self.store.save(term, self._accepted)
        self._term = term

    @property
    def accepted_state(self) -> ClusterState:
        return self._accepted

    @accepted_state.setter
    def accepted_state(self, state: ClusterState) -> None:
        if self.store is not None:
            self.store.save(self._term, state)
        self._accepted = state

    @property
    def last_accepted_term(self) -> int:
        return self._accepted.term

    @property
    def last_accepted_version(self) -> int:
        return self._accepted.version


class CoordinationState:
    def __init__(self, node_id: str, persisted: PersistedState | None = None):
        self.node_id = node_id
        self.persisted = persisted or PersistedState()
        self.join_votes: set[str] = set()
        self.publish_votes: set[str] = set()
        self.election_won = False
        self.started_join_since_last_reboot = False
        self.last_published_version = 0
        self.last_published_config = self.persisted.accepted_state.last_accepted_config
        self.last_committed_version = 0

    # -- accessors ---------------------------------------------------------

    @property
    def current_term(self) -> int:
        return self.persisted.current_term

    @property
    def last_accepted_state(self) -> ClusterState:
        return self.persisted.accepted_state

    def committed_config(self) -> VotingConfiguration:
        return self.persisted.accepted_state.last_committed_config

    def accepted_config(self) -> VotingConfiguration:
        return self.persisted.accepted_state.last_accepted_config

    def is_electable(self) -> bool:
        return True

    # -- elections ---------------------------------------------------------

    def handle_start_join(self, request: StartJoinRequest) -> Join:
        """A candidate asked us to vote in `request.term`
        (CoordinationState.handleStartJoin:213): grant at most one vote per
        term, bumping our term — which also deposes us if we were leader."""
        if request.term <= self.current_term:
            raise CoordinationError(
                f"incoming term {request.term} not greater than current term "
                f"{self.current_term}"
            )
        self.persisted.current_term = request.term
        self.join_votes = set()
        self.publish_votes = set()
        self.election_won = False
        self.started_join_since_last_reboot = True
        self.last_published_version = 0
        return Join(
            voter_id=self.node_id,
            candidate_id=request.source_id,
            term=request.term,
            last_accepted_term=self.persisted.last_accepted_term,
            last_accepted_version=self.persisted.last_accepted_version,
        )

    def handle_join(self, join: Join) -> bool:
        """A voter's join arrived (CoordinationState.handleJoin:264). Safety:
        reject joins for other terms, and reject voters whose accepted state
        is AHEAD of ours — a stale candidate must not win. Returns True if
        this join made us win the election."""
        if join.term != self.current_term:
            raise CoordinationError(
                f"incoming term {join.term} does not match current term "
                f"{self.current_term}"
            )
        if not self.started_join_since_last_reboot:
            raise CoordinationError("ignored join as term was not incremented yet after reboot")
        last_accepted_term = self.persisted.last_accepted_term
        if join.last_accepted_term > last_accepted_term:
            raise CoordinationError(
                f"incoming last accepted term {join.last_accepted_term} of "
                f"join higher than current last accepted term {last_accepted_term}"
            )
        if (
            join.last_accepted_term == last_accepted_term
            and join.last_accepted_version > self.persisted.last_accepted_version
        ):
            raise CoordinationError(
                f"incoming last accepted version {join.last_accepted_version} "
                f"higher than current last accepted version "
                f"{self.persisted.last_accepted_version} in term {last_accepted_term}"
            )
        prev_won = self.election_won
        self.join_votes.add(join.voter_id)
        self.election_won = self.committed_config().has_quorum(
            self.join_votes
        ) and self.accepted_config().has_quorum(self.join_votes)
        return self.election_won and not prev_won

    # -- publication (leader side) ------------------------------------------

    def handle_client_value(self, state: ClusterState) -> PublishRequest:
        """Leader publishes a newly computed state
        (CoordinationState.handleClientValue)."""
        if not self.election_won:
            raise CoordinationError("only the leader can publish")
        if state.term != self.current_term:
            raise CoordinationError(
                f"cannot publish state with term {state.term} != current "
                f"term {self.current_term}"
            )
        if state.version <= self.last_published_version:
            raise CoordinationError(
                f"cannot publish version {state.version} <= last published "
                f"{self.last_published_version}"
            )
        # reconfiguration safety (CoordinationState.handleClientValue): a new
        # voting config may only be published once the previous one is
        # committed, AND our join votes must reach quorum in the NEW config —
        # otherwise a disjoint quorum could elect a second leader
        if state.last_accepted_config != self.accepted_config():
            if self.accepted_config() != self.committed_config():
                raise CoordinationError(
                    "only allow reconfiguration while not already reconfiguring"
                )
            if not state.last_accepted_config.has_quorum(self.join_votes):
                raise CoordinationError(
                    "only allow reconfiguration if joinVotes have quorum for new config"
                )
        self.last_published_version = state.version
        self.last_published_config = state.last_accepted_config
        self.publish_votes = set()
        return PublishRequest(state=state)

    def handle_publish_response(
        self, voter_id: str, response: PublishResponse
    ) -> ApplyCommitRequest | None:
        """Collect publish acks; quorum in BOTH configs -> commit."""
        if response.term != self.current_term or response.version != self.last_published_version:
            raise CoordinationError(
                f"stale publish response term={response.term} "
                f"version={response.version}"
            )
        self.publish_votes.add(voter_id)
        if self.committed_config().has_quorum(
            self.publish_votes
        ) and self.last_published_config.has_quorum(self.publish_votes):
            return ApplyCommitRequest(term=response.term, version=response.version)
        return None

    # -- publication (receiver side) ----------------------------------------

    def handle_publish_request(self, request: PublishRequest) -> PublishResponse:
        """Accept a published state (CoordinationState.handlePublishRequest
        :181): only for our exact current term, and never regress."""
        state = request.state
        if state.term != self.current_term:
            raise CoordinationError(
                f"incoming term {state.term} does not match current term "
                f"{self.current_term}"
            )
        if (
            state.term == self.persisted.last_accepted_term
            and state.version <= self.persisted.last_accepted_version
        ):
            raise CoordinationError(
                f"incoming version {state.version} lower or equal to current "
                f"version {self.persisted.last_accepted_version}"
            )
        self.persisted.accepted_state = state
        return PublishResponse(term=state.term, version=state.version)

    def handle_commit(self, commit: ApplyCommitRequest) -> ClusterState:
        """Apply a commit for the exact accepted (term, version)."""
        if commit.term != self.current_term:
            raise CoordinationError(
                f"incoming term {commit.term} does not match current term "
                f"{self.current_term}"
            )
        if commit.term != self.persisted.last_accepted_term:
            raise CoordinationError(
                f"incoming term {commit.term} does not match last accepted "
                f"term {self.persisted.last_accepted_term}"
            )
        if commit.version != self.persisted.last_accepted_version:
            raise CoordinationError(
                f"incoming version {commit.version} does not match last "
                f"accepted version {self.persisted.last_accepted_version}"
            )
        self.last_committed_version = commit.version
        return self.persisted.accepted_state

"""Coordinator: the election/publication finite-state machine.

The analog of the reference's Coordinator
(server/src/main/java/org/opensearch/cluster/coordination/Coordinator.java:
132 — startElection:583, becomeLeader/becomeFollower, handleJoinRequest:659,
publication :518) plus ElectionSchedulerFactory (randomized backoff) and
PreVoteCollector: callback-driven so the same code runs deterministically
under testing/sim.py and on the asyncio transport in production.

Transport contract (duck-typed; MockTransport and TcpTransport implement):
    register(node_id, action, handler), send(sender, target, action,
    payload, on_response, on_failure)
Scheduler contract: schedule(delay_ms, fn) -> cancellable.

Actions: coordination/pre_vote, /start_join, /join, /publish, /commit,
/leader_check, /follower_check — mirroring the reference's action names
(PublicationTransportHandler.java:81,83; FollowersChecker.java:88).
"""

from __future__ import annotations

import enum
import logging
from typing import Any, Callable

from opensearch_tpu_torch.cluster.coordination import (
    ApplyCommitRequest,
    CoordinationError,
    CoordinationState,
    Join,
    PersistedState,
    PublishRequest,
    PublishResponse,
    StartJoinRequest,
)
from opensearch_tpu_torch.cluster.state import (
    ClusterState,
    DiscoveryNode,
    VotingConfiguration,
    apply_diff,
    diff_states,
)


logger = logging.getLogger(__name__)


class Mode(enum.Enum):
    CANDIDATE = "CANDIDATE"
    LEADER = "LEADER"
    FOLLOWER = "FOLLOWER"


class Coordinator:
    def __init__(
        self,
        node: DiscoveryNode,
        peers: list[str],
        transport,
        scheduler,
        persisted: PersistedState | None = None,
        election_initial_timeout_ms: int = 100,
        election_backoff_ms: int = 100,
        election_max_timeout_ms: int = 1000,
        heartbeat_interval_ms: int = 200,
        follower_check_retries: int = 3,
        leader_check_retries: int = 3,
        on_state_applied: Callable[[ClusterState], None] | None = None,
        state_transform: Callable[[ClusterState], ClusterState] | None = None,
    ):
        self.node = node
        self.node_id = node.node_id
        self.peers = [p for p in peers if p != node.node_id]
        # the configured seed hosts are kept forever (a wiped cluster can
        # always be re-discovered from them); everything else in `peers` /
        # `_known_peer_nodes` is evicted when the node leaves the applied
        # state — otherwise node churn grows both without bound (TPU009)
        self._seed_peers: tuple[str, ...] = tuple(self.peers)
        self.transport = transport
        self.scheduler = scheduler
        # set by the node layer (ClusterNode) to its per-node tracer;
        # publication fan-outs open spans on it so state propagation is
        # traceable like any other distributed operation
        self.tracer = None
        self.coord = CoordinationState(node.node_id, persisted)
        self.mode = Mode.CANDIDATE
        self.leader_id: str | None = None
        self.applied_state: ClusterState = self.coord.last_accepted_state
        self.on_state_applied = on_state_applied
        # applied to every computed state before publication — the node
        # layer hooks allocation (AllocationService.reroute on node
        # join/leave) here
        self.state_transform = state_transform
        self.election_attempts = 0
        self._stopped = False
        self._election_timer = None
        self._heartbeat_timer = None
        self._leader_check_timer = None
        self._leader_check_failures = 0
        self._follower_failures: dict[str, int] = {}
        self._catchup_inflight: set[str] = set()
        # node-stats piggyback on the check channel (FsHealthService /
        # monitor feeding allocation): followers attach check_extras() to
        # their acks; the leader consumes via on_follower_extras
        self.check_extras: Callable[[], dict] | None = None
        self.on_follower_extras: Callable[[str, dict], None] | None = None
        self._pending_tasks: list[Callable[[ClusterState], ClusterState]] = []
        self._publishing = False
        self._publication_seq = 0
        self._el_init = election_initial_timeout_ms
        self._el_backoff = election_backoff_ms
        self._el_max = election_max_timeout_ms
        self._heartbeat_ms = heartbeat_interval_ms
        self._follower_retries = follower_check_retries
        self._leader_retries = leader_check_retries
        self._known_peer_nodes: dict[str, DiscoveryNode] = {node.node_id: node}

        t = transport
        t.register(self.node_id, "coordination/pre_vote", self._on_pre_vote)
        t.register(self.node_id, "coordination/start_join", self._on_start_join)
        t.register(self.node_id, "coordination/join", self._on_join)
        t.register(self.node_id, "coordination/publish", self._on_publish)
        t.register(self.node_id, "coordination/commit", self._on_commit)
        t.register(self.node_id, "coordination/follower_check", self._on_follower_check)
        t.register(self.node_id, "coordination/node_join", self._on_node_join_request)
        t.register(self.node_id, "coordination/client_update", self._on_client_update)

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    def start(self) -> None:
        self._become_candidate("started")

    def stop(self) -> None:
        """Node shutdown: cancel every timer so a closed node stops
        heartbeating/electing (its transport is closed too — see
        TcpTransport.send's closed guard)."""
        self._stopped = True
        self._cancel_timers()
        self.mode = Mode.CANDIDATE
        self.leader_id = None

    def bootstrap(self, voting_node_ids: list[str]) -> None:
        """Set the initial voting configuration (ClusterBootstrapService
        analog). No-op on an already-bootstrapped node (e.g. restart with
        recovered durable state — re-bootstrapping would wipe metadata)."""
        if (self.coord.persisted.accepted_state.last_committed_config.node_ids
                or self.coord.persisted.last_accepted_version > 0):
            return
        config = VotingConfiguration(frozenset(voting_node_ids))
        state = self.coord.last_accepted_state.with_(
            last_committed_config=config, last_accepted_config=config,
            cluster_uuid=f"uuid-{self.node_id}",
        )
        self.coord.persisted.accepted_state = state
        self.applied_state = state

    # ------------------------------------------------------------------ #
    # mode transitions
    # ------------------------------------------------------------------ #

    def _cancel_timers(self) -> None:
        for timer in (self._election_timer, self._heartbeat_timer, self._leader_check_timer):
            if timer is not None:
                timer.cancel()
        self._election_timer = self._heartbeat_timer = self._leader_check_timer = None

    def _become_candidate(self, reason: str) -> None:
        if self._stopped:
            return
        self._cancel_timers()
        self.mode = Mode.CANDIDATE
        self.leader_id = None
        self.election_attempts = 0
        self._schedule_election()

    def _become_leader(self) -> None:
        if self._stopped:
            return
        # a publication this node began in an earlier term of its own died
        # with that leadership (its acks carry the old term and are
        # refused): the new term's first publication must not wait for its
        # 30 s timeout (OpenSearch cancels the active publication when a
        # node turns candidate; the reference keeps the flag set, and a
        # follower race for a dead leader then holds the node's removal 30
        # s). The stale timer is harmless: its sequence number is spent.
        self._publishing = False
        self._cancel_timers()
        self.mode = Mode.LEADER
        self.leader_id = self.node_id
        self._follower_failures = {}
        self._heartbeat_timer = self.scheduler.schedule(
            self._heartbeat_ms, self._heartbeat
        )
        # first publication of the new term: leader + joined nodes
        self._submit_reroute_publication()

    def _become_follower(self, leader_id: str) -> None:
        if self._stopped:
            return
        if self.mode == Mode.FOLLOWER and self.leader_id == leader_id:
            return
        self._cancel_timers()
        self.mode = Mode.FOLLOWER
        self.leader_id = leader_id
        self._leader_check_failures = 0
        self._schedule_leader_check()

    # ------------------------------------------------------------------ #
    # elections (PreVoteCollector + ElectionSchedulerFactory analog)
    # ------------------------------------------------------------------ #

    def _schedule_election(self) -> None:
        # randomized backoff: damps election storms
        upper = min(
            self._el_init + self._el_backoff * self.election_attempts, self._el_max
        )
        delay = self.scheduler.random.randint(self._el_init // 2, max(upper, 1))
        self.election_attempts += 1
        self._election_timer = self.scheduler.schedule(delay, self._start_pre_vote)

    def _start_pre_vote(self) -> None:
        if self.mode != Mode.CANDIDATE:
            return
        # exactly ONE retry chain: schedule the next attempt up front; every
        # other path must not reschedule (double chains caused storms)
        self._schedule_election()
        votes: set[str] = {self.node_id}
        responded: set[str] = set()
        started = [False]
        proposed_term = self.coord.current_term + 1
        max_seen_term = [self.coord.current_term]

        payload = {
            "term": self.coord.current_term,
            "last_accepted_term": self.coord.persisted.last_accepted_term,
            "last_accepted_version": self.coord.persisted.last_accepted_version,
        }

        joined_leader = [False]

        def on_response(peer: str):
            def handle(resp: dict) -> None:
                if self.mode != Mode.CANDIDATE:
                    return
                responded.add(peer)
                max_seen_term[0] = max(max_seen_term[0], resp.get("term", 0))
                known_leader = resp.get("leader_id")
                if known_leader and known_leader != self.node_id and not joined_leader[0]:
                    # a live leader exists that doesn't know us — ask to join
                    # it rather than keep electing
                    joined_leader[0] = True
                    self.request_join(known_leader)
                if resp.get("granted") and not started[0]:
                    votes.add(peer)
                    if self.coord.committed_config().has_quorum(votes):
                        started[0] = True
                        self._start_election(max(proposed_term, max_seen_term[0] + 1))
            return handle

        for peer in self.peers:
            self.transport.send(
                self.node_id, peer, "coordination/pre_vote", payload,
                on_response=on_response(peer), on_failure=lambda e: None,
            )
        # single-node cluster: quorum may already be just us
        if self.coord.committed_config().has_quorum(votes):
            started[0] = True
            self._start_election(proposed_term)

    def _on_pre_vote(self, sender: str, payload: dict) -> dict:
        # grant if the candidate's accepted state is not behind ours and we
        # don't currently follow a live leader
        ours_term = self.coord.persisted.last_accepted_term
        ours_version = self.coord.persisted.last_accepted_version
        behind = payload["last_accepted_term"] < ours_term or (
            payload["last_accepted_term"] == ours_term
            and payload["last_accepted_version"] < ours_version
        )
        granted = not behind and self.mode != Mode.LEADER and self.leader_id is None
        # expose any live leader we know of so stranded candidates can join
        # it instead of electioneering (JoinHelper / PeerFinder analog)
        return {"granted": granted, "term": self.coord.current_term,
                "leader_id": self.leader_id if self.mode != Mode.CANDIDATE else None}

    def _start_election(self, term: int) -> None:
        if self.mode != Mode.CANDIDATE or term <= self.coord.current_term:
            return
        request = StartJoinRequest(source_id=self.node_id, term=term)
        # ask every peer (and ourselves) for a join in the new term
        try:
            own_join = self.coord.handle_start_join(request)
            self._process_join(own_join)
        except CoordinationError:
            pass
        for peer in self.peers:
            self.transport.send(
                self.node_id, peer, "coordination/start_join",
                {"source_id": self.node_id, "term": term},
                on_response=None, on_failure=lambda e: None,
            )
        # no rescheduling here: the single election chain in
        # _start_pre_vote retries if this round doesn't produce a leader

    def _on_start_join(self, sender: str, payload: dict) -> dict:
        request = StartJoinRequest(payload["source_id"], payload["term"])
        try:
            join = self.coord.handle_start_join(request)
        except CoordinationError as e:
            return {"ack": False, "reason": str(e)}
        # a start-join for a higher term deposes any current leadership
        if self.mode != Mode.CANDIDATE:
            self._become_candidate(f"start-join from {sender}")
        self.transport.send(
            self.node_id, request.source_id, "coordination/join",
            _join_to_dict(join), on_response=None, on_failure=lambda e: None,
        )
        return {"ack": True}

    def _on_join(self, sender: str, payload: dict) -> dict:
        join = _join_from_dict(payload)
        self._process_join(join)
        return {"ack": True}

    def _process_join(self, join: Join) -> None:
        try:
            won_now = self.coord.handle_join(join)
        except CoordinationError:
            return
        if won_now and self.mode == Mode.CANDIDATE:
            self._become_leader()

    # -- node joins after election (JoinHelper analog) ----------------------

    def request_join(self, leader_id: str) -> None:
        """A fresh node asks the leader to be added to the cluster."""
        self.transport.send(
            self.node_id, leader_id, "coordination/node_join",
            {"node": self.node.to_dict()},
            on_response=None, on_failure=lambda e: None,
        )

    def _on_node_join_request(self, sender: str, payload: dict) -> dict:
        if self.mode != Mode.LEADER:
            raise CoordinationError(f"not the leader (leader is {self.leader_id})")
        node = DiscoveryNode.from_dict(payload["node"])
        self._known_peer_nodes[node.node_id] = node
        if node.node_id not in self.peers:
            self.peers.append(node.node_id)
        self.submit_state_update(lambda s: _add_node(s, node))
        return {"ack": True}

    # ------------------------------------------------------------------ #
    # publication (ClusterManagerService.publish + PublicationTransport)
    # ------------------------------------------------------------------ #

    def submit_state_update(
        self, task: Callable[[ClusterState], ClusterState]
    ) -> None:
        """Single-writer state mutation queue (ClusterManagerService
        .submitStateUpdateTask: tasks batch; one publication in flight)."""
        if self.mode != Mode.LEADER:
            raise CoordinationError("not the leader")
        self._pending_tasks.append(task)
        self._maybe_publish()

    def _submit_reroute_publication(self) -> None:
        def init_state(state: ClusterState) -> ClusterState:
            nodes = dict(state.nodes)
            nodes[self.node_id] = self.node
            for nid in sorted(self.coord.join_votes):
                if nid in self._known_peer_nodes:
                    nodes[nid] = self._known_peer_nodes[nid]
                elif nid not in nodes:
                    nodes[nid] = DiscoveryNode(node_id=nid, name=nid)
            return state.with_(nodes=nodes, leader_id=self.node_id)

        self._pending_tasks.append(init_state)
        self._maybe_publish()

    def _maybe_publish(self) -> None:
        if self._publishing or not self._pending_tasks or self.mode != Mode.LEADER:
            return
        tasks, self._pending_tasks = self._pending_tasks, []
        state = self.applied_state
        for task in tasks:
            try:
                state = task(state)
            except Exception as e:  # noqa: BLE001 - a bad task must not kill the loop
                logger.warning("cluster-state task failed on %s: %s",
                               self.node_id, e)
                continue
        if self.state_transform is not None:
            try:
                state = self.state_transform(state)
            except Exception as e:  # noqa: BLE001
                logger.warning("cluster-state transform failed on %s: %s",
                               self.node_id, e)
        new_state = state.with_(
            term=self.coord.current_term,
            version=max(state.version, self.applied_state.version,
                        self.coord.last_published_version) + 1,
            leader_id=self.node_id,
        )
        try:
            publish_request = self.coord.handle_client_value(new_state)
        except CoordinationError:
            # a refused publication must not eat the submitted tasks:
            # leave them queued for the next trigger (or to die with
            # leadership) instead of silently dropping client updates
            # submitted during a term flap
            self._pending_tasks = tasks + self._pending_tasks
            return
        self._publishing = True
        self._run_publication(publish_request)

    def _run_publication(self, request: PublishRequest) -> None:
        state = request.state
        acked_commit: set[str] = set()
        commit_sent = [False]
        # sorted: set/dict order must not leak into message order, or sim
        # runs stop being replayable across processes (hash randomization)
        targets = sorted(nid for nid in state.nodes if nid != self.node_id)

        # self-ack first (leader accepts its own publication)
        try:
            response = self.coord.handle_publish_request(request)
            commit = self.coord.handle_publish_response(self.node_id, response)
            if commit is not None:
                self._send_commits(commit, state, targets, acked_commit, commit_sent)
        except CoordinationError:
            self._publishing = False
            return

        payload = {"state": state.to_dict()}

        def on_response(peer: str):
            def handle(resp: dict) -> None:
                if resp.get("rejected"):
                    return
                try:
                    commit = self.coord.handle_publish_response(
                        peer, PublishResponse(resp["term"], resp["version"])
                    )
                except CoordinationError:
                    return
                if commit is not None and not commit_sent[0]:
                    self._send_commits(commit, state, targets, acked_commit, commit_sent)
            return handle

        from opensearch_tpu_torch.telemetry.tracing import default_telemetry

        tracer = self.tracer or default_telemetry.tracer
        # NOTE: this span measures the publish DISPATCH (acceptance and
        # commit land in later callbacks); its value is the trace id the
        # follower-side handlers stitch under, not its duration
        with tracer.start_span("coordination.publish", {
            "node": self.node_id, "term": state.term,
            "version": state.version, "targets": len(targets),
        }):
            # sends capture this span's context: the publish/commit
            # handlers' work on followers stitches into one trace
            for peer in targets:
                self.transport.send(
                    self.node_id, peer, "coordination/publish", payload,
                    on_response=on_response(peer), on_failure=lambda e: None,
                )
        # publication timeout: give up and allow the next one. The seq guard
        # keeps a stale timer from an earlier publication from aborting a
        # later in-flight one.
        self._publication_seq += 1
        my_seq = self._publication_seq

        def finish() -> None:
            if self._publishing and self._publication_seq == my_seq:
                self._publishing = False
                self._maybe_publish()

        self.scheduler.schedule(30_000, finish)

    def _send_commits(self, commit: ApplyCommitRequest, state: ClusterState,
                      targets: list[str], acked: set[str], commit_sent: list) -> None:
        commit_sent[0] = True
        applied = self.coord.handle_commit(commit)
        self._apply_state(applied)
        payload = {"term": commit.term, "version": commit.version}
        for peer in targets:
            self.transport.send(
                self.node_id, peer, "coordination/commit", payload,
                on_response=None, on_failure=lambda e: None,
            )
        self._publishing = False
        self._maybe_publish()

    def _on_publish(self, sender: str, payload: dict) -> dict:
        state = ClusterState.from_dict(payload["state"])
        if state.term > self.coord.current_term:
            # lagging node: adopt the term implicitly via a synthetic
            # start-join (the reference wraps publish in onJoinValidators +
            # term bump through join)
            try:
                join = self.coord.handle_start_join(
                    StartJoinRequest(source_id=sender, term=state.term)
                )
                self.transport.send(
                    self.node_id, sender, "coordination/join",
                    _join_to_dict(join), on_response=None, on_failure=lambda e: None,
                )
            except CoordinationError:
                pass
        try:
            response = self.coord.handle_publish_request(PublishRequest(state))
        except CoordinationError as e:
            return {"rejected": True, "reason": str(e)}
        if sender != self.node_id:
            self._become_follower(sender)
        return {"term": response.term, "version": response.version}

    def _on_commit(self, sender: str, payload: dict) -> dict:
        try:
            applied = self.coord.handle_commit(
                ApplyCommitRequest(payload["term"], payload["version"])
            )
        except CoordinationError as e:
            return {"rejected": True, "reason": str(e)}
        self._apply_state(applied)
        return {"ack": True}

    def _apply_state(self, state: ClusterState) -> None:
        if state.version <= self.applied_state.version and state.term <= self.applied_state.term:
            if state.version == self.applied_state.version:
                return
        self.applied_state = state
        self._prune_peer_books(state)
        if self.on_state_applied is not None:
            self.on_state_applied(state)

    def _prune_peer_books(self, state: ClusterState) -> None:
        """Bound the discovery books to live ids: configured seeds, nodes
        in the applied state, and current-term voters (a joiner mid-flight
        has voted but may not be published yet). Node ids are minted per
        process lifetime, so without this a long-lived leader accretes an
        entry per restart forever."""
        keep = set(self._seed_peers) | set(state.nodes)
        keep |= set(self.coord.join_votes)
        keep.add(self.node_id)
        self._known_peer_nodes = {
            nid: n for nid, n in self._known_peer_nodes.items()
            if nid in keep
        }
        kept = [p for p in self.peers if p in keep]
        # late-joining nodes learned from the state become dial targets on
        # every node (PeerFinder's last-accepted-state discovery source),
        # not just on the leader that processed their join
        for nid in sorted(state.nodes):
            if nid != self.node_id and nid not in kept:
                kept.append(nid)
        self.peers = kept

    # ------------------------------------------------------------------ #
    # failure detection (FollowersChecker / LeaderChecker analog)
    # ------------------------------------------------------------------ #

    def _heartbeat(self) -> None:
        if self.mode != Mode.LEADER:
            return
        for peer in sorted(nid for nid in self.applied_state.nodes if nid != self.node_id):
            self.transport.send(
                self.node_id, peer, "coordination/follower_check",
                {"term": self.coord.current_term, "leader_id": self.node_id},
                on_response=self._follower_ok(peer),
                on_failure=self._follower_failed(peer),
            )
        self._heartbeat_timer = self.scheduler.schedule(
            self._heartbeat_ms, self._heartbeat
        )

    def _follower_ok(self, peer: str):
        def handle(resp: dict) -> None:
            if resp.get("ack"):
                self._follower_failures[peer] = 0
                if self.on_follower_extras is not None and "extras" in resp:
                    self.on_follower_extras(peer, resp["extras"])
                # lag repair (LagDetector + publication fallback): a
                # follower that acked but has not applied our committed
                # version (e.g. a wiped node that rejoined while still in
                # state.nodes — no state CHANGE, so no publication would
                # ever reach it) gets a direct full-state catch-up
                applied_v = resp.get("applied_version")
                if (applied_v is not None
                        and applied_v < self.applied_state.version
                        and peer not in self._catchup_inflight):
                    self._send_catchup(peer)
                return
            # the peer rejected us; if it sits on a HIGHER term — or flags
            # an equal-term dual-leader split — we must step down and
            # re-elect (the reference's leader learns of higher terms via
            # check/join responses and bails to candidate)
            peer_term = resp.get("term", 0)
            if self.mode == Mode.LEADER and (
                peer_term > self.coord.current_term or resp.get("dual_leader")
            ):
                self._become_candidate(
                    f"peer {peer} rejected leadership (term {peer_term})"
                )
            else:
                self._follower_failed(peer)(RuntimeError("check rejected"))
        return handle

    def _follower_failed(self, peer: str):
        def handle(_e: Exception) -> None:
            if self.mode != Mode.LEADER:
                return
            self._follower_failures[peer] = self._follower_failures.get(peer, 0) + 1
            if self._follower_failures[peer] >= self._follower_retries:
                self._follower_failures[peer] = 0
                self._remove_node(peer)
        return handle

    def _remove_node(self, peer: str) -> None:
        if self.mode != Mode.LEADER or peer not in self.applied_state.nodes:
            return
        try:
            self.submit_state_update(lambda s: _remove_node(s, peer))
        except CoordinationError:
            pass

    def _send_catchup(self, peer: str) -> None:
        """Push the current committed state to one lagging follower:
        publish (it accepts — its version is behind) then commit. Safe:
        the state is already quorum-committed."""
        state = self.applied_state
        if state.term != self.coord.current_term:
            return
        self._catchup_inflight.add(peer)

        def done(_=None) -> None:
            self._catchup_inflight.discard(peer)

        def after_publish(resp: dict) -> None:
            # commit unconditionally: a rejected publish usually means the
            # follower already ACCEPTED this exact version and missed only
            # the commit — handle_commit's (term, version) match keeps a
            # truly mismatched follower safe
            self.transport.send(
                self.node_id, peer, "coordination/commit",
                {"term": state.term, "version": state.version},
                on_response=done, on_failure=done,
            )

        self.transport.send(
            self.node_id, peer, "coordination/publish",
            {"state": state.to_dict()},
            on_response=after_publish, on_failure=done,
        )

    def _on_follower_check(self, sender: str, payload: dict) -> dict:
        if payload["term"] < self.coord.current_term:
            # stale leader: report our term so it can step down and re-elect
            return {"ack": False, "term": self.coord.current_term}
        if payload["term"] > self.coord.current_term:
            # we lag behind the checking leader's term: adopt it by voting
            # for that leader in its term (synthetic start-join, like the
            # lagging-node path in _on_publish). This DEMOTES us if we were
            # leader — the higher-term leader wins (the reference's
            # ensureTermAtLeast + becomeFollower("onFollowerCheckRequest");
            # adopting the term while staying LEADER would leave two
            # leaders sharing the adopted term)
            try:
                join = self.coord.handle_start_join(
                    StartJoinRequest(source_id=payload["leader_id"], term=payload["term"])
                )
                self.transport.send(
                    self.node_id, payload["leader_id"], "coordination/join",
                    _join_to_dict(join), on_response=None, on_failure=lambda e: None,
                )
            except CoordinationError:
                pass
            if payload["leader_id"] != self.node_id:
                self._become_follower(payload["leader_id"])
                self._leader_check_failures = 0
        if self.mode == Mode.LEADER and payload["leader_id"] != self.node_id:
            # an EQUAL-term check from another self-styled leader: two
            # leaders cannot share a term — reject, flagged so the sender's
            # _follower_ok steps ITS leadership down too (both re-elect)
            return {"ack": False, "term": self.coord.current_term,
                    "dual_leader": True}
        if self.mode != Mode.LEADER and payload["leader_id"] != self.node_id:
            self._become_follower(payload["leader_id"])
            self._leader_check_failures = 0
        if payload["leader_id"] == self.node_id and self.mode != Mode.LEADER:
            # a stale follower still checks us as its leader — reject so it
            # goes looking for the real one
            return {"ack": False, "term": self.coord.current_term}
        if (self.mode == Mode.LEADER
                and payload["leader_id"] == self.node_id
                and sender != self.node_id
                and sender not in self.applied_state.nodes):
            # we evicted this node while its acks were dark (half-open
            # link / partition). Acking its leader checks would leave it a
            # PHANTOM FOLLOWER forever: it gets no publications (not in
            # the state) and no follower checks (heartbeats iterate
            # state.nodes), so nothing ever re-adds it. Reject instead —
            # its leader-check failures send it back to candidate, and the
            # pre-vote -> request_join path (the same one fresh boots use)
            # re-admits it.
            return {"ack": False, "term": self.coord.current_term}
        out = {"ack": True, "term": self.coord.current_term,
               "applied_version": self.applied_state.version}
        if self.check_extras is not None:
            try:
                out["extras"] = self.check_extras()
            except Exception as e:  # noqa: BLE001 - stats must not fail checks
                logger.debug("follower-check extras failed: %s", e)
        return out

    def _schedule_leader_check(self) -> None:
        self._leader_check_timer = self.scheduler.schedule(
            self._heartbeat_ms * 2, self._check_leader
        )

    def _check_leader(self) -> None:
        if self.mode != Mode.FOLLOWER or self.leader_id is None:
            return
        leader = self.leader_id

        def ok(resp: dict) -> None:
            if resp.get("ack"):
                self._leader_check_failures = 0
            else:
                # the node we follow rejected us — it is no longer our
                # leader (deposed or ahead); go find the real one
                failed(RuntimeError("leader check rejected"))

        def failed(_e: Exception) -> None:
            if self.mode != Mode.FOLLOWER or self.leader_id != leader:
                return
            self._leader_check_failures += 1
            if self._leader_check_failures >= self._leader_retries:
                self._become_candidate(f"leader [{leader}] unreachable")

        self.transport.send(
            self.node_id, leader, "coordination/follower_check",
            {"term": self.coord.current_term, "leader_id": leader},
            on_response=ok, on_failure=failed,
        )
        self._schedule_leader_check()

    # -- client entry point -------------------------------------------------

    def _on_client_update(self, sender: str, payload: dict) -> dict:
        """Metadata CRUD routed to the elected leader
        (TransportClusterManagerNodeAction analog). payload: an opaque task
        the node layer interprets; here: pre-serialized state mutations."""
        raise NotImplementedError("wired by the node layer")


def _join_to_dict(join: Join) -> dict:
    return {
        "voter_id": join.voter_id,
        "candidate_id": join.candidate_id,
        "term": join.term,
        "last_accepted_term": join.last_accepted_term,
        "last_accepted_version": join.last_accepted_version,
    }


def _join_from_dict(d: dict) -> Join:
    return Join(d["voter_id"], d["candidate_id"], d["term"],
                d["last_accepted_term"], d["last_accepted_version"])


def _add_node(state: ClusterState, node: DiscoveryNode) -> ClusterState:
    nodes = dict(state.nodes)
    nodes[node.node_id] = node
    return state.with_(nodes=nodes)


def _remove_node(state: ClusterState, node_id: str) -> ClusterState:
    nodes = dict(state.nodes)
    nodes.pop(node_id, None)
    return state.with_(nodes=nodes)

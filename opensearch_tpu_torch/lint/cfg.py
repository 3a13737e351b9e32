"""tpulint dataflow layer: per-function control-flow graphs.

The single-pass AST matchers (TPU001-TPU007) see statements; the rules
added on top of this module (TPU008 callback-leak, TPU010 interprocedural
lock-order) need *paths*: "is there a way through this function that drops
both completion callbacks?" is a question about branches, early returns,
and except-edges, not about any one statement.

Design — deliberately smaller than a compiler CFG:

- ``build_cfg(fn)`` lowers one function body to basic blocks with typed
  edges (``seq``/``true``/``false``/``exc``/``loop``). Branch edges carry
  their test expression so analyses can prune infeasible paths (e.g.
  assume a callback parameter is not None on the path that calls it).
- try/except/finally: every statement boundary inside a ``try`` body gets
  an ``exc`` edge into each handler, carrying the state *before* the
  failing statement (the except-path a dropped listener hides on).
  ``finally`` bodies are inlined — once on the normal continuation, and
  as fresh copies on every abrupt jump (return/break/continue) and on the
  uncaught-exception continuation — so a path walker never needs special
  finally bookkeeping.
- loops are acyclic-ized: a ``for`` body executes exactly once on every
  enumerated path and a ``while`` body at most once. This keeps path
  enumeration finite and, for the must-call-exactly-once analysis, avoids
  flagging the ubiquitous guarded fan-out (``if not targets: cb(); return``
  followed by ``for t in targets: send(..., cb)``) on a phantom
  zero-iteration path. It is a soundness tradeoff, documented here on
  purpose: tpulint hunts the failure classes that have bitten this
  codebase, not arbitrary programs.
- two exits: ``exit`` (normal completion — return or falling off the end)
  and ``raise_exit`` (an exception left the function). Analyses usually
  treat raise-exit paths as resolved-by-caller: a transport handler that
  raises produces an error response, which IS the failure signal.

``enumerate_paths`` walks the graph depth-first with a per-path visit cap
and a global path cap, yielding ``Path`` objects (ordered blocks + the
edges taken + whether an ``exc`` edge was traversed).
"""

from __future__ import annotations

import ast
from typing import Callable, Iterator

# hard bounds: a pathological function must degrade to "no findings",
# never to minutes of enumeration
MAX_PATHS = 4_000
MAX_VISITS_PER_PATH = 2


class ScopeEnter(ast.AST):
    """Marker emitted into a block when a ``with`` body begins.

    ``_fields`` stays empty on purpose: ``ast.walk``/``iter_child_nodes``
    see a leaf, so every pre-existing analysis treats the marker as inert.
    Lock-epoch analyses (TPU019) read ``context_expr`` to know which
    context manager was entered; ``exit_marker`` is the paired ScopeExit.
    """

    _fields = ()

    def __init__(self, item: ast.withitem):
        super().__init__()
        self.item = item
        self.context_expr = item.context_expr
        self.lineno = getattr(item.context_expr, "lineno", 1)
        self.col_offset = getattr(item.context_expr, "col_offset", 0)


class ScopeExit(ast.AST):
    """Paired marker for leaving a ``with`` body (including abrupt exits:
    return/break/continue run the exit like a pending finally)."""

    _fields = ()

    def __init__(self, enter: ScopeEnter):
        super().__init__()
        self.enter = enter
        self.context_expr = enter.context_expr
        self.lineno = enter.lineno
        self.col_offset = enter.col_offset
        enter.exit_marker = self


class Edge:
    __slots__ = ("dst", "kind", "cond")

    def __init__(self, dst: "Block", kind: str, cond: ast.expr | None = None):
        self.dst = dst
        self.kind = kind  # seq | true | false | exc | loop
        self.cond = cond  # branch test for true/false edges

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Edge({self.kind} -> {self.dst.label}#{self.dst.id})"


class Block:
    __slots__ = ("id", "label", "stmts", "edges")

    def __init__(self, block_id: int, label: str):
        self.id = block_id
        self.label = label
        # straight-line payload: statements, plus bare expressions for
        # branch tests / with-items so analyses see every evaluation
        self.stmts: list[ast.AST] = []
        self.edges: list[Edge] = []

    def edge_to(self, dst: "Block", kind: str = "seq",
                cond: ast.expr | None = None) -> None:
        self.edges.append(Edge(dst, kind, cond))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Block({self.label}#{self.id}, {len(self.stmts)} stmts)"


class CFG:
    def __init__(self, fn: ast.AST):
        self.fn = fn
        self.blocks: list[Block] = []
        self.entry = self.new_block("entry")
        self.exit = self.new_block("exit")
        self.raise_exit = self.new_block("raise")

    def new_block(self, label: str) -> Block:
        block = Block(len(self.blocks), label)
        self.blocks.append(block)
        return block


class Path:
    """One enumerated walk entry -> (exit | raise_exit)."""

    __slots__ = ("blocks", "edges", "exceptional")

    def __init__(self, blocks: list[Block], edges: list[Edge],
                 exceptional: bool):
        self.blocks = blocks
        self.edges = edges
        self.exceptional = exceptional

    @property
    def raises(self) -> bool:
        return self.blocks[-1].label == "raise"

    def labels(self) -> list[str]:
        return [b.label for b in self.blocks]


class _Builder:
    """Structured lowering: keeps a 'current' block (None = unreachable
    code), a loop frame stack for break/continue targets, and the stack of
    pending ``finally`` bodies an abrupt jump must run through."""

    def __init__(self, fn: ast.AST):
        self.cfg = CFG(fn)
        self.current: Block | None = self.cfg.entry
        # (break_target, continue_target, finally_depth_at_loop_entry)
        self._loops: list[tuple[Block, Block, int]] = []
        self._finallies: list[list[ast.stmt]] = []
        # innermost try frame: handler entry blocks, uncaught continuation,
        # and the _finallies depth at frame push (a raise runs only the
        # pending finallies ABOVE the frame's own finalbody — with-exit
        # markers interleave on this stack, so depth is recorded, not
        # recomputed from the frame count)
        self._exc_frames: list[tuple[list[Block], Block, int]] = []

    # -- plumbing ----------------------------------------------------------

    def _emit(self, node: ast.AST) -> None:
        if self.current is not None:
            self.current.stmts.append(node)

    def _start(self, label: str) -> Block:
        """Close the current block and continue in a fresh one."""
        block = self.cfg.new_block(label)
        if self.current is not None:
            self.current.edge_to(block)
        self.current = block
        return block

    def _run_finallies(self, down_to: int) -> None:
        """Inline fresh copies of every pending finally body (innermost
        first) into the current chain — the path an abrupt jump takes."""
        for body in reversed(self._finallies[down_to:]):
            if not body:
                continue
            saved = self._finallies
            # the copy runs OUTSIDE the try it belongs to: its own returns
            # only traverse finallies further out
            self._finallies = saved[:down_to]
            self._stmts(body)
            self._finallies = saved

    def _jump(self, target: Block, down_to: int = 0) -> None:
        """Abrupt transfer (return/break/continue/raise): run pending
        finally bodies, edge to the target, mark code after unreachable."""
        if self.current is None:
            return
        self._run_finallies(down_to)
        if self.current is not None:
            self.current.edge_to(target)
        self.current = None

    # -- statements --------------------------------------------------------

    def _stmts(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            if self.current is None:
                return  # unreachable tail
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.If):
            self._build_if(stmt)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._build_for(stmt)
        elif isinstance(stmt, ast.While):
            self._build_while(stmt)
        elif isinstance(stmt, ast.Try):
            self._build_try(stmt)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            enters = []
            for item in stmt.items:
                self._emit(item.context_expr)
                enter = ScopeEnter(item)
                self._emit(enter)
                enters.append(enter)
            exits: list = [ScopeExit(e) for e in reversed(enters)]
            # the exits behave like a pending finally: an abrupt jump out
            # of the body (return/break/continue) releases the context
            # managers on its way, exactly like the runtime does
            self._finallies.append(exits)
            self._stmts(stmt.body)
            self._finallies.pop()
            if self.current is not None:
                for marker in exits:
                    self._emit(marker)
        elif isinstance(stmt, ast.Return):
            self._emit(stmt)
            self._jump(self.cfg.exit)
        elif isinstance(stmt, ast.Raise):
            self._emit(stmt)
            frames = self._exc_frames
            if frames:
                # jump into the innermost uncaught continuation, which
                # inlines that try's finally itself — only finallies of
                # frames we skip OVER (handler bodies, with-exits inside
                # the try body) run here
                self._jump(frames[-1][1], frames[-1][2])
            else:
                self._jump(self.cfg.raise_exit)
        elif isinstance(stmt, ast.Break):
            if self._loops:
                target, _cont, depth = self._loops[-1]
                self._jump(target, depth)
            else:  # malformed code; treat as exit
                self._jump(self.cfg.exit)
        elif isinstance(stmt, ast.Continue):
            if self._loops:
                # acyclic-ized loops: "next iteration" is the loop exit
                target, _cont, depth = self._loops[-1]
                self._jump(target, depth)
            else:
                self._jump(self.cfg.exit)
        else:
            # simple statement (incl. nested FunctionDef/ClassDef, which
            # analyses treat as opaque definitions, not executed bodies)
            self._emit(stmt)

    def _build_if(self, stmt: ast.If) -> None:
        assert self.current is not None
        self._emit(stmt.test)
        head = self.current
        after = self.cfg.new_block("after-if")

        true_block = self.cfg.new_block("if-true")
        head.edge_to(true_block, "true", stmt.test)
        self.current = true_block
        self._stmts(stmt.body)
        if self.current is not None:
            self.current.edge_to(after)

        false_block = self.cfg.new_block("if-false")
        head.edge_to(false_block, "false", stmt.test)
        self.current = false_block
        self._stmts(stmt.orelse)
        if self.current is not None:
            self.current.edge_to(after)

        # both arms may have jumped away (returned/raised)
        self.current = after if _has_preds(self.cfg, after) else None

    def _build_for(self, stmt: ast.For | ast.AsyncFor) -> None:
        assert self.current is not None
        self._emit(stmt.iter)
        after = self.cfg.new_block("after-loop")
        body = self.cfg.new_block("for-body")
        self.current.edge_to(body, "loop")
        self.current = body
        self._loops.append((after, body, len(self._finallies)))
        self._stmts(stmt.body)
        self._loops.pop()
        if self.current is not None:
            self.current.edge_to(after)
        self.current = after
        if stmt.orelse:
            self._stmts(stmt.orelse)

    def _build_while(self, stmt: ast.While) -> None:
        assert self.current is not None
        self._emit(stmt.test)
        head = self.current
        after = self.cfg.new_block("after-loop")
        body = self.cfg.new_block("while-body")
        head.edge_to(body, "true", stmt.test)
        is_forever = (isinstance(stmt.test, ast.Constant)
                      and bool(stmt.test.value))
        if not is_forever:
            head.edge_to(after, "false", stmt.test)
        self.current = body
        self._loops.append((after, body, len(self._finallies)))
        self._stmts(stmt.body)
        self._loops.pop()
        if self.current is not None:
            # body ran once; at most one traversal (acyclic-ized)
            self.current.edge_to(after)
        self.current = after if _has_preds(self.cfg, after) else None
        if self.current is not None and stmt.orelse:
            self._stmts(stmt.orelse)

    def _build_try(self, stmt: ast.Try) -> None:
        assert self.current is not None
        after = self.cfg.new_block("after-try")
        handler_entries = [
            self.cfg.new_block(f"except:{_handler_label(h)}")
            for h in stmt.handlers
        ]
        uncaught = self.cfg.new_block("try-uncaught")

        self._finallies.append(stmt.finalbody)
        self._exc_frames.append((handler_entries, uncaught,
                                 len(self._finallies)))

        # try body: a fresh block per statement, with exc edges from each
        # statement boundary (the handler sees the state BEFORE the
        # statement that raised)
        for s in stmt.body:
            if self.current is None:
                break
            boundary = self.current
            for h in handler_entries:
                boundary.edge_to(h, "exc")
            boundary.edge_to(uncaught, "exc")
            self._start("try-stmt")
            self._stmt(s)

        self._exc_frames.pop()

        if self.current is not None and stmt.orelse:
            self._stmts(stmt.orelse)
        converge = self.cfg.new_block("try-converge")
        if self.current is not None:
            self.current.edge_to(converge)

        # handlers run with the try's finally still pending (a return in a
        # handler runs it) but with this try's exc frame popped
        for h, entry in zip(stmt.handlers, handler_entries):
            self.current = entry
            self._stmts(h.body)
            if self.current is not None:
                self.current.edge_to(converge)

        self._finallies.pop()

        # normal continuation: one shared finally copy
        self.current = converge if _has_preds(self.cfg, converge) else None
        if self.current is not None:
            if stmt.finalbody:
                self._stmts(stmt.finalbody)
            if self.current is not None:
                self.current.edge_to(after)

        # uncaught continuation: fresh finally copy, then the raise exit
        if _has_preds(self.cfg, uncaught):
            self.current = uncaught
            if stmt.finalbody:
                self._stmts(stmt.finalbody)
            if self.current is not None:
                frames = self._exc_frames
                if frames:
                    self.current.edge_to(frames[-1][1])
                else:
                    self.current.edge_to(self.cfg.raise_exit)

        self.current = after if _has_preds(self.cfg, after) else None

    def build(self) -> CFG:
        body = self.cfg.fn.body
        if not isinstance(body, list):  # lambda
            body = [ast.Expr(value=body)]
        self._stmts(body)
        if self.current is not None:
            self.current.edge_to(self.cfg.exit)
        return self.cfg


def _has_preds(cfg: CFG, block: Block) -> bool:
    return any(e.dst is block for b in cfg.blocks for e in b.edges)


def _handler_label(handler: ast.ExceptHandler) -> str:
    if handler.type is None:
        return "bare"
    try:
        return ast.unparse(handler.type)
    except (AttributeError, ValueError):  # pragma: no cover
        return "?"


def build_cfg(fn: ast.AST) -> CFG:
    """Lower one FunctionDef/AsyncFunctionDef/Lambda body to a CFG."""
    return _Builder(fn).build()


def enumerate_paths(
    cfg: CFG,
    *,
    prune: Callable[[Edge], bool] | None = None,
    max_paths: int = MAX_PATHS,
    max_visits: int = MAX_VISITS_PER_PATH,
) -> Iterator[Path]:
    """Depth-first path enumeration entry -> exit/raise_exit.

    ``prune(edge) -> True`` skips an edge (infeasible under the analysis'
    assumptions). Each block appears at most ``max_visits`` times per path;
    at ``max_paths`` total the generator stops — analyses must treat
    truncation as "no finding", never as proof.
    """
    yielded = 0
    # stack entries: (block, blocks_so_far, edges_so_far, visits, exceptional)
    start_visits = {cfg.entry.id: 1}
    stack: list[tuple] = [(cfg.entry, [cfg.entry], [], start_visits, False)]
    while stack and yielded < max_paths:
        block, blocks, edges, visits, exceptional = stack.pop()
        if block is cfg.exit or block is cfg.raise_exit:
            yielded += 1
            yield Path(blocks, edges, exceptional)
            continue
        if not block.edges:
            # dangling block (unreachable-after construction): fell off —
            # treat as normal completion
            yielded += 1
            yield Path(blocks + [cfg.exit], edges, exceptional)
            continue
        for edge in reversed(block.edges):
            if prune is not None and prune(edge):
                continue
            n = visits.get(edge.dst.id, 0)
            if n >= max_visits:
                continue
            new_visits = dict(visits)
            new_visits[edge.dst.id] = n + 1
            stack.append((
                edge.dst,
                blocks + [edge.dst],
                edges + [edge],
                new_visits,
                exceptional or edge.kind == "exc",
            ))


# ---------------------------------------------------------------------------
# branch-feasibility helper shared by path-sensitive rules
# ---------------------------------------------------------------------------

def branch_infeasible(edge: Edge, assumed_non_none: set[str]) -> bool:
    """True when taking this branch contradicts the assumption that every
    name in ``assumed_non_none`` is a real (non-None, truthy) callback.

    Recognized tests: ``x is None`` / ``x is not None`` / bare ``x`` /
    ``not x`` / ``callable(x)`` for a tracked name x. Anything else is
    feasible both ways.
    """
    if edge.kind not in ("true", "false") or edge.cond is None:
        return False
    taken_true = edge.kind == "true"
    verdict = _test_verdict(edge.cond, assumed_non_none)
    if verdict is None:
        return False
    # verdict is the value the test evaluates to under the assumption
    return verdict is not taken_true


def _test_verdict(test: ast.expr, names: set[str]) -> bool | None:
    """Evaluate a branch test under "names are non-None callables";
    None = unknown."""
    if isinstance(test, ast.Name) and test.id in names:
        return True
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = _test_verdict(test.operand, names)
        return None if inner is None else not inner
    if isinstance(test, ast.Call):
        fn = test.func
        if (isinstance(fn, ast.Name) and fn.id == "callable"
                and len(test.args) == 1
                and isinstance(test.args[0], ast.Name)
                and test.args[0].id in names):
            return True
        return None
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        op = test.ops[0]
        if not isinstance(op, (ast.Is, ast.IsNot)):
            return None
        left, right = test.left, test.comparators[0]
        name = None
        if isinstance(left, ast.Name) and left.id in names and \
                isinstance(right, ast.Constant) and right.value is None:
            name = left.id
        elif isinstance(right, ast.Name) and right.id in names and \
                isinstance(left, ast.Constant) and left.value is None:
            name = right.id
        if name is None:
            return None
        # "x is None" is False under the assumption; "is not" flips it
        return isinstance(op, ast.IsNot)
    return None

"""Logical-plan frontend: relational trees compiled to Session task DAGs.

The paper's headline numbers are end-to-end TPC-H/TPC-DS queries, not single
operators — multi-join plans whose *shape* (join order, bushy vs. left-deep)
decides how much intermediate state competes for the page budget.  This
module closes the gap between hand-wired ``session.task(...)`` lists and
those queries:

``LogicalPlan``
  A tree of relational nodes — ``scan`` / ``filter`` / ``join`` /
  ``aggregate`` / ``sort`` — annotated with table statistics (sizes in
  pages).  Filters scale the estimated pages flowing upward; a filter
  chain feeding a BNLJ probe side additionally compiles *physically* — the
  join task carries ``pushdown_sel`` (and the predicate, when given), so
  the arbiter can ship the filtered scan to a compute-capable tier.  All
  other filters remain stats annotations (pushdown-at-scan assumption);
  ``CompiledPlan.pushed_filters`` / ``annotation_filters`` record which is
  which.

``compile_plan(session, plan)``
  Lowers the tree to a dependency-ordered task DAG over the registered
  spill operators — joins to EHJ (or BNLJ), ``aggregate`` to EAGG, ``sort``
  to EMS — chaining intermediate results by ``task.output`` references, so
  ``session.run(tasks, schedule="dag")`` executes producers before
  consumers, overlaps independent subtrees, and places every intermediate
  spill stream through ``arbitrate_hierarchy`` like any other.

Join-order choice is *enumerate-and-cost over a bounded candidate set*
priced with the same closed forms (``core/policies.py`` via
``OperatorSpec.model``) the arbiter already trusts: the hand-written tree
(the left-deep baseline), every left-deep permutation for small clusters, a
greedy smallest-first order, and a smallest-pair bushy tree.  Ties keep the
hand-written order, so a compiled plan is never modeled worse than the
hand-wired chain.  Intermediate cardinalities follow the classic
independent-selectivity estimate: each source join contributes a page
selectivity ``phi = out / (|L| * |S|)`` applied once both its sides are
joined.

Skeleton assumption (documented, asserted nowhere): every join in a cluster
equi-joins on the shared key column 0 — the convention of the synthetic
relations (``make_relation``) and of operator outputs (``_block_join``
keeps the key in column 0) — which is what makes reordering semantically
valid.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.engine.registry import WorkloadStats, get
from repro_torch.engine.session import OperatorTask, Session, TaskOutput

# --------------------------------------------------------------------------
# Logical nodes
# --------------------------------------------------------------------------

_KINDS = ("scan", "filter", "join", "aggregate", "sort")


@dataclasses.dataclass(eq=False)
class Node:
    """One relational node; compare by identity (trees share subtrees)."""

    kind: str
    name: str
    children: Tuple["Node", ...] = ()
    relation: Any = None  # scan only: Relation / page-id list
    rows_per_page: int = 8  # scan only
    selectivity: float = 1.0  # filter only
    out_pages: Optional[float] = None  # join/aggregate estimate override
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def pages(self) -> float:
        """Estimated output pages of this subtree."""
        if self.kind == "scan":
            return max(float(_relation_pages(self.relation)), 1.0)
        if self.kind == "filter":
            return max(self.children[0].pages * self.selectivity, 1.0)
        if self.kind == "sort":
            return self.children[0].pages
        if self.kind == "aggregate":
            if self.out_pages is not None:
                return max(float(self.out_pages), 1.0)
            return max(self.children[0].pages / 8.0, 1.0)
        # join: explicit estimate, else the FK-join default |larger side|
        if self.out_pages is not None:
            return max(float(self.out_pages), 1.0)
        return max(self.children[0].pages, self.children[1].pages)


def _relation_pages(relation: Any) -> int:
    if relation is None:
        return 0
    if hasattr(relation, "page_ids"):
        return len(relation.page_ids)
    return len(relation)


class LogicalPlan:
    """Builder for a relational tree; the last node built is the root.

    >>> lp = LogicalPlan("q3")
    >>> o = lp.scan("orders", orders_rel)
    >>> li = lp.scan("lineitem", lineitem_rel)
    >>> j = lp.join(lp.filter(o, 0.5), li, out_pages=30.0)
    >>> lp.aggregate(j, out_pages=4.0)
    >>> tasks = compile_plan(session, lp).tasks
    """

    def __init__(self, name: str = "query"):
        self.name = name
        self.root: Optional[Node] = None
        self._seq = 0
        self.nodes: List[Node] = []

    def _add(self, node: Node) -> Node:
        self.nodes.append(node)
        self.root = node
        return node

    def _name(self, kind: str, name: Optional[str]) -> str:
        if name is not None:
            return name
        self._seq += 1
        return f"{self.name}.{kind}{self._seq}"

    def scan(self, name: str, relation: Any, rows_per_page: int = 8) -> Node:
        """A base table: a live ``Relation`` or page-id list."""
        if _relation_pages(relation) == 0:
            raise ValueError(f"scan {name!r}: relation has no pages")
        return self._add(Node(
            kind="scan", name=name, relation=relation,
            rows_per_page=rows_per_page,
        ))

    def filter(self, child: Node, selectivity: float,
               name: Optional[str] = None,
               predicate: Optional[Callable[..., bool]] = None) -> Node:
        """Scale the child's estimated pages by ``selectivity`` (0, 1].

        ``selectivity`` must be finite — ``nan``/``inf`` raise here instead
        of corrupting every upstream estimate.  ``predicate(page) -> bool``
        optionally carries the *actual* page predicate; when the filter is
        compiled physically (BNLJ probe side), the predicate executes at the
        data plane — at a compute-capable tier when the arbiter pushes it —
        while ``selectivity`` stays the planning estimate.
        """
        selectivity = float(selectivity)
        if not math.isfinite(selectivity) or not 0.0 < selectivity <= 1.0:
            raise ValueError(
                f"filter selectivity must be finite and in (0, 1], "
                f"got {selectivity}"
            )
        options: Dict[str, Any] = {}
        if predicate is not None:
            if not callable(predicate):
                raise TypeError(
                    f"filter predicate must be callable, got "
                    f"{type(predicate).__name__}"
                )
            options["predicate"] = predicate
        return self._add(Node(
            kind="filter", name=self._name("filter", name),
            children=(self._node(child),), selectivity=selectivity,
            options=options,
        ))

    def join(self, left: Node, right: Node,
             out_pages: Optional[float] = None,
             name: Optional[str] = None, **options: Any) -> Node:
        """Equijoin on the shared key column; ``options`` reach the task."""
        return self._add(Node(
            kind="join", name=self._name("join", name),
            children=(self._node(left), self._node(right)),
            out_pages=out_pages, options=dict(options),
        ))

    def aggregate(self, child: Node, out_pages: Optional[float] = None,
                  name: Optional[str] = None, **options: Any) -> Node:
        """Group-by on the key column, lowered to EAGG."""
        return self._add(Node(
            kind="aggregate", name=self._name("agg", name),
            children=(self._node(child),), out_pages=out_pages,
            options=dict(options),
        ))

    def sort(self, child: Node, name: Optional[str] = None,
             **options: Any) -> Node:
        """Order-by, lowered to EMS."""
        return self._add(Node(
            kind="sort", name=self._name("sort", name),
            children=(self._node(child),), options=dict(options),
        ))

    @staticmethod
    def _node(value: Any) -> Node:
        if not isinstance(value, Node):
            raise TypeError(
                f"expected a plan Node, got {type(value).__name__} "
                f"(wrap base tables with plan.scan(...))"
            )
        return value


# --------------------------------------------------------------------------
# Join-order optimization: enumerate-and-cost over a bounded candidate set
# --------------------------------------------------------------------------

# Full left-deep permutation enumeration up to this many cluster leaves;
# larger clusters fall back to the greedy + bushy candidates only.
_ENUM_LEAVES = 4


@dataclasses.dataclass(frozen=True)
class JoinChoice:
    """One join cluster's costed candidates, for inspection/benchmarks."""

    cluster: str  # the cluster's original top join node name
    chosen: str  # description of the winning shape
    chosen_cost: float  # modeled L of the winning shape
    left_deep_cost: float  # modeled L of the hand-written tree
    candidates: Tuple[Tuple[str, float], ...]  # (description, modeled L)
    # Filter nodes this cluster compiled physically onto a BNLJ probe side
    # (the operator executes them — candidates for tier pushdown) rather
    # than leaving them as pure stats annotations.
    pushed_filters: Tuple[str, ...] = ()


class _Cluster:
    """A maximal join-only subtree: leaves + pairwise page selectivities."""

    def __init__(self, session: Session, join_op: str, policy: str):
        self.leaves: List[Node] = []
        self.est: Dict[frozenset, float] = {}
        self.preds: List[Tuple[frozenset, frozenset, float]] = []
        self.tau = session.tier.tau_pages
        self.spec = get(join_op)
        self.policy = policy
        self.budget = session.budget

    def collect(self, node: Node) -> frozenset:
        """Flatten ``node``'s join subtree into leaves + predicates."""
        if node.kind != "join":
            idx = len(self.leaves)
            self.leaves.append(node)
            s = frozenset([idx])
            self.est[s] = max(node.pages, 1.0)
            return s
        ls = self.collect(node.children[0])
        rs = self.collect(node.children[1])
        out = node.pages if node.out_pages is not None else max(
            self.est[ls], self.est[rs]
        )
        phi = out / max(self.est[ls] * self.est[rs], 1e-12)
        self.preds.append((ls, rs, phi))
        s = ls | rs
        self.est[s] = max(out, 1.0)
        return s

    def size_of(self, s: frozenset) -> float:
        """Estimated pages of the join over leaf set ``s``.

        Independent-selectivity estimate: the product of leaf sizes times
        every source predicate whose two sides are both inside ``s``.
        """
        pages = 1.0
        for i in s:
            pages *= self.est[frozenset([i])]
        for a, b, phi in self.preds:
            if (a | b) <= s:
                pages *= phi
        return max(pages, 1.0)

    def cost_tree(self, tree: Any) -> float:
        """Modeled L of a candidate tree under a nominal even budget split.

        ``tree`` is a leaf index or a nested ``(left, right)`` pair.  Each
        join is priced with the operator's closed-form model at
        ``budget / (#joins)`` — the plan-level analogue of the arbiter's
        even-split starting point.
        """
        n_joins = max(len(self.leaves) - 1, 1)
        m_nom = max(self.budget / n_joins, self.spec.min_pages)
        total = 0.0

        def walk(t) -> frozenset:
            nonlocal total
            if isinstance(t, int):
                return frozenset([t])
            ls, rs = walk(t[0]), walk(t[1])
            s = ls | rs
            stats = WorkloadStats(
                size_r=self.size_of(ls), size_s=self.size_of(rs),
                out=self.size_of(s),
            )
            total += self.spec.model(stats, self.tau, m_nom, self.policy)
            return s

        walk(tree)
        return total

    # -- candidate shapes ---------------------------------------------------

    def _left_deep(self, order: Sequence[int]) -> Any:
        tree: Any = order[0]
        for i in order[1:]:
            tree = (tree, i)
        return tree

    def _bushy_smallest_pair(self) -> Any:
        """Repeatedly join the two smallest current subtrees (by est pages)."""
        forest: List[Tuple[frozenset, Any]] = [
            (frozenset([i]), i) for i in range(len(self.leaves))
        ]
        while len(forest) > 1:
            forest.sort(key=lambda e: (self.size_of(e[0]), min(e[0])))
            (sa, ta), (sb, tb) = forest[0], forest[1]
            forest = forest[2:] + [(sa | sb, (ta, tb))]
        return forest[0][1]

    def candidates(self) -> List[Tuple[str, Any]]:
        n = len(self.leaves)
        given = list(range(n))
        out: List[Tuple[str, Any]] = [
            ("left-deep (as written)", self._left_deep(given))
        ]
        if n <= _ENUM_LEAVES:
            for perm in itertools.permutations(given):
                if list(perm) == given:
                    continue
                names = ">".join(self.leaves[i].name for i in perm)
                out.append((f"left-deep {names}", self._left_deep(perm)))
        else:
            by_size = sorted(
                given, key=lambda i: self.est[frozenset([i])]
            )
            names = ">".join(self.leaves[i].name for i in by_size)
            out.append((f"left-deep smallest-first {names}",
                        self._left_deep(by_size)))
        out.append(("bushy smallest-pair", self._bushy_smallest_pair()))
        return out

    def best(self, cluster_name: str) -> Tuple[Any, JoinChoice]:
        """Cost every candidate; ties keep the hand-written order."""
        scored = [
            (desc, tree, self.cost_tree(tree))
            for desc, tree in self.candidates()
        ]
        left_deep_cost = scored[0][2]
        best_desc, best_tree, best_cost = min(
            scored, key=lambda e: (e[2], e[0] != "left-deep (as written)")
        )
        if best_cost >= left_deep_cost - 1e-12:
            best_desc, best_tree, best_cost = scored[0]
        return best_tree, JoinChoice(
            cluster=cluster_name, chosen=best_desc, chosen_cost=best_cost,
            left_deep_cost=left_deep_cost,
            candidates=tuple((d, c) for d, _, c in scored),
        )


# --------------------------------------------------------------------------
# compile_plan
# --------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledPlan:
    """A logical plan lowered to a Session task DAG.

    ``tasks`` is dependency-ordered (producers first) and runs with
    ``session.run(tasks, schedule="dag")``; ``root`` is the plan's final
    task.  ``join_choices`` records each join cluster's costed candidate
    set — the evidence behind the chosen shape.
    """

    tasks: List[OperatorTask]
    root: OperatorTask
    plan: LogicalPlan
    join_choices: List[JoinChoice]
    # Filter disposition across the whole plan: physically compiled onto a
    # BNLJ probe side (arbiter decides ship vs. tier pushdown at plan time)
    # vs. left as pure estimate annotations (ehj, build sides, non-leaf
    # filters).  Names are logical-plan node names.
    pushed_filters: List[str] = dataclasses.field(default_factory=list)
    annotation_filters: List[str] = dataclasses.field(default_factory=list)

    def run(self, session: Session, **kwargs: Any):
        kwargs.setdefault("schedule", "dag")
        return session.run(self.tasks, **kwargs)

    def explain(self, session: Session):
        return session.explain(self.tasks, dag=True)

    @property
    def output(self) -> TaskOutput:
        return self.root.output


def compile_plan(
    session: Session,
    plan: LogicalPlan,
    root: Optional[Node] = None,
    *,
    join_op: str = "ehj",
    optimize: bool = True,
    prefetch: bool = False,
) -> CompiledPlan:
    """Compile ``plan`` (rooted at ``root`` or ``plan.root``) into tasks.

    ``join_op`` selects the join operator (``"ehj"`` or ``"bnlj"``);
    ``optimize=False`` keeps the hand-written join order (the left-deep
    baseline the benchmark compares against).  Node ``options`` pass
    through to ``session.task`` (e.g. ``placement=...``, ``sigma=...``).
    """
    root = root if root is not None else plan.root
    if root is None:
        raise ValueError(f"plan {plan.name!r} is empty: build nodes first")
    if join_op not in ("ehj", "bnlj"):
        raise ValueError(f"join_op must be 'ehj' or 'bnlj', got {join_op!r}")
    tasks: List[OperatorTask] = []
    choices: List[JoinChoice] = []
    pushed_filters: List[str] = []

    def stats_options(node: Node) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Split node options into WorkloadStats fields vs. task options."""
        stat_fields = {"sigma", "partitions", "selectivity", "k_cap"}
        stats_kw = {k: v for k, v in node.options.items() if k in stat_fields}
        task_kw = {k: v for k, v in node.options.items()
                   if k not in stat_fields}
        return stats_kw, task_kw

    def leaf_rpp(node: Node) -> int:
        """rows_per_page flowing up from the subtree's first scan."""
        if node.kind == "scan":
            return node.rows_per_page
        return leaf_rpp(node.children[0])

    def lower(node: Node) -> Tuple[Any, float]:
        """Returns (data-plane value or TaskOutput, estimated pages)."""
        if node.kind == "scan":
            return node.relation, node.pages
        if node.kind == "filter":
            value, _ = lower(node.children[0])
            return value, node.pages
        if node.kind == "join":
            return lower_join_cluster(node)
        if node.kind == "aggregate":
            value, in_pages = lower(node.children[0])
            stats_kw, task_kw = stats_options(node)
            task_kw.setdefault("rows_per_page", leaf_rpp(node))
            task = session.task(
                "eagg",
                WorkloadStats(size_r=in_pages, out=node.pages, **stats_kw),
                inputs={"rel": value}, label=node.name, **task_kw,
            )
            tasks.append(task)
            return task.output, node.pages
        if node.kind == "sort":
            value, in_pages = lower(node.children[0])
            stats_kw, task_kw = stats_options(node)
            task_kw.setdefault("rows_per_page", leaf_rpp(node))
            task = session.task(
                "ems",
                WorkloadStats(size_r=in_pages, out=node.pages, **stats_kw),
                inputs={"page_ids": value}, label=node.name, **task_kw,
            )
            tasks.append(task)
            return task.output, node.pages
        raise ValueError(f"unknown plan node kind {node.kind!r}")

    def probe_filter(leaf: Node):
        """(combined sel, predicate, raw pages, names) for a physicalizable
        filter chain leaf, else None (the chain stays an annotation)."""
        if leaf.kind != "filter":
            return None
        sel, names, preds = 1.0, [], []
        n = leaf
        while n.kind == "filter":
            sel *= n.selectivity
            if n.options.get("predicate") is not None:
                preds.append(n.options["predicate"])
            names.append(n.name)
            n = n.children[0]
        if preds and (len(preds) > 1 or len(names) > 1):
            # Callables don't compose with each other or with scalar
            # estimates; a mixed chain stays a stats annotation.
            return None
        return sel, (preds[0] if preds else None), max(n.pages, 1.0), names

    def lower_join_cluster(node: Node) -> Tuple[Any, float]:
        """Flatten a maximal join subtree, pick a shape, emit join tasks."""
        cluster = _Cluster(session, join_op, session.policy)
        cluster.collect(node)
        choice: Optional[JoinChoice] = None
        if optimize and len(cluster.leaves) > 2:
            tree, choice = cluster.best(node.name)
        else:
            tree = cluster._left_deep(range(len(cluster.leaves)))
        lowered = [lower(leaf) for leaf in cluster.leaves]
        # Task options/rows_per_page follow the original top join node.
        stats_kw, task_kw = stats_options(node)
        rpp = leaf_rpp(node)
        seq = [0]
        cluster_pushed: List[str] = []

        def emit(t) -> Tuple[Any, frozenset]:
            if isinstance(t, int):
                return lowered[t][0], frozenset([t])
            lv, ls = emit(t[0])
            rv, rs = emit(t[1])
            s = ls | rs
            stats = WorkloadStats(
                size_r=cluster.size_of(ls), size_s=cluster.size_of(rs),
                out=cluster.size_of(s), **stats_kw,
            )
            seq[0] += 1
            label = node.name if s == frozenset(range(len(cluster.leaves))) \
                else f"{node.name}/{seq[0]}"
            kw = dict(task_kw)
            if join_op == "ehj":
                inputs = {"build": lv, "probe": rv}
                kw.setdefault("rows_per_page", rpp)
            else:
                inputs = {"outer": lv, "inner": rv}
                # A filter chain feeding the probe (inner) side compiles
                # physically: the operator scans the *raw* inner pages and
                # applies the filter itself, so the arbiter can ship the
                # scan to a compute-capable tier and return only survivors.
                pf = probe_filter(cluster.leaves[t[1]]) \
                    if isinstance(t[1], int) else None
                if pf is not None:
                    sel, pred, raw_pages, names = pf
                    stats = dataclasses.replace(
                        stats, size_s=raw_pages, pushdown_sel=sel,
                    )
                    if pred is not None:
                        kw.setdefault("inner_filter", pred)
                    cluster_pushed.extend(names)
            if prefetch:
                kw.setdefault("prefetch", True)
            task = session.task(
                join_op, stats, inputs=inputs, label=label, **kw,
            )
            tasks.append(task)
            return task.output, s

        value, s = emit(tree)
        if choice is not None:
            choices.append(dataclasses.replace(
                choice, pushed_filters=tuple(cluster_pushed),
            ))
        pushed_filters.extend(cluster_pushed)
        return value, cluster.size_of(s)

    value, _ = lower(root)
    if not tasks:
        raise ValueError(
            f"plan {plan.name!r} lowers to no operator tasks (scans and "
            f"filters alone are not executable)"
        )
    if not isinstance(value, TaskOutput) or value.task is not tasks[-1]:
        raise AssertionError("lowering must end at the root task")

    def filter_names(node: Node, acc: List[str]) -> None:
        if node.kind == "filter" and node.name not in acc:
            acc.append(node.name)
        for child in node.children:
            filter_names(child, acc)

    all_filters: List[str] = []
    filter_names(root, all_filters)
    annotation_filters = [n for n in all_filters if n not in set(pushed_filters)]
    return CompiledPlan(
        tasks=tasks, root=tasks[-1], plan=plan, join_choices=choices,
        pushed_filters=pushed_filters, annotation_filters=annotation_filters,
    )
